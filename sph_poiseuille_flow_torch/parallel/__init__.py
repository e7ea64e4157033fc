"""(g, mu) workload sweeps and the multi-device decomposition (torch port
of the JAX package's ``parallel``)."""

from .sharding import (AXIS, ShardedCellEngine, ShardedEngine,
                       ShardedPallasEngine, make_mesh)
from .sweep import make_workloads, run_sweep
from .virtual import ensure_devices

__all__ = ["AXIS", "ShardedCellEngine", "ShardedEngine",
           "ShardedPallasEngine", "ensure_devices", "make_mesh",
           "make_workloads", "run_sweep"]
