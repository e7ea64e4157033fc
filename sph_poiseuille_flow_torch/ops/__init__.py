from . import cellgrid, fused_cell, fused_cell_cuda, integration, kernels, neighbors

__all__ = ["cellgrid", "fused_cell", "fused_cell_cuda", "integration",
           "kernels", "neighbors"]
