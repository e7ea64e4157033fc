"""(g, mu) workload sweeps (torch port of the JAX package's
``parallel/sweep.py``). The multi-device names of the JAX package's
``parallel`` come with its y-slab decomposition."""

from .sweep import make_workloads, run_sweep

__all__ = ["make_workloads", "run_sweep"]
