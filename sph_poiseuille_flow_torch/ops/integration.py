"""Time-step rule and periodic wrap (torch port of the JAX package's
``ops/integration.verlet_dt`` and ``periodic_wrap``). The rest of the
reference's Verlet integration (sph_physics_mex.c:736-1469) lives inside
the fused sweeps of ``ops/fused_cell.py``."""

from __future__ import annotations

import torch

from .neighbors import GridSpec


def _c(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim constant of ``like``'s dtype and device (so a constant on
    the LEFT of a division rounds once, as in the JAX package, instead of
    going through torch's reciprocal-times form)."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def verlet_dt(vx_f: torch.Tensor, vy_f: torch.Tensor, c_f: float, h: float,
              nu, gravity_g, remain) -> torch.Tensor:
    """Unified Verlet dt: min(acoustic, viscous, body-force, remaining)
    (reference: SPH_Poiseuille.m:519-527), as a 0-dim tensor."""
    v_max = torch.sqrt(torch.max(vx_f * vx_f + vy_f * vy_f))
    nu = torch.as_tensor(nu, dtype=v_max.dtype, device=v_max.device)
    g = torch.as_tensor(gravity_g, dtype=v_max.dtype, device=v_max.device)
    remain = torch.as_tensor(remain, dtype=v_max.dtype, device=v_max.device)
    tiny = _c(1e-12, v_max)
    dt_acoustic = _c(0.25 * h, v_max) / torch.maximum(c_f + v_max, tiny)
    dt_viscous = _c(0.125 * h * h, v_max) / torch.maximum(nu, tiny)
    dt_body = 0.25 * torch.sqrt(_c(h, v_max) / torch.maximum(g.abs(), tiny))
    dt = torch.minimum(torch.minimum(dt_acoustic, dt_viscous),
                       torch.minimum(dt_body, remain))
    return torch.maximum(dt, tiny)


def periodic_wrap(spec: GridSpec, x: torch.Tensor) -> torch.Tensor:
    """x <- mod(x, DL) for fluid particles (SPH_Poiseuille.m:570-577)."""
    nf = spec.n_fluid
    return torch.cat([torch.remainder(x[:nf], spec.DL), x[nf:]])
