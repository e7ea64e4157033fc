"""PyTorch + CUDA port of the 2D weakly-compressible SPH Poiseuille solver.

The second package beside ``sph_poiseuille_flow_tpu`` (the JAX/Pallas
reference, which it never imports). Module names mirror the JAX
package's. The fused cell-layout engine runs its kernels -- the fused
step and the multi-step chunk, each in the recompute, geometry-cache and
row-outer forms the layout knobs select, and the wall-shear monitor -- as
hand-written CUDA C++ for Hopper (``csrc/fused_cell.cu``) on CUDA tensors,
and as their plain PyTorch twins on CPU tensors. ``python -m
sph_poiseuille_flow_torch.probe`` times the step sweep by sweep through the
probes' kernels (``ops/probes.py``). The cell-layout engine
(``CellEngine``) and the packed-gather engine (``Engine``) are plain torch
ops, float32 or float64 on either device. ``parallel.run_sweep`` runs
(g, mu) workload sweeps on any of the three.
"""

from .config import (SPHConfig, ConfigError, parse_ini, parse_ini_text,
                     get_ini_numeric, derive_config, load_config,
                     env_override)
from .models.poiseuille import Scene, build_scene
from .stepper import (CellEngine, Engine, PallasCellEngine, State,
                      initial_state, make_engine, resolve_engine_name)

__all__ = [
    "SPHConfig", "ConfigError", "parse_ini", "parse_ini_text",
    "get_ini_numeric", "derive_config", "load_config", "env_override",
    "Scene", "build_scene", "PallasCellEngine", "CellEngine", "Engine",
    "make_engine",
    "resolve_engine_name", "State", "initial_state",
]

__version__ = "0.1.0"
