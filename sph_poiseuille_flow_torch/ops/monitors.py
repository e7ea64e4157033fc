"""Runtime diagnostics of the gather engine (torch port of the JAX
package's ``ops/monitors.py``).

* ``wall_shear``: the reference's read-only ``wall_shear_monitor`` mode
  (sph_physics_mex.c:1653-1743): the viscous x-force of fluid-wall pairs
  (the viscous operator's formula with its 4.0 one-sided factor), split by
  wall side through the rebuild-static wall masks, tau = -sum/DL. It reads
  the Geometry's own gathered ``vol_j``.
* ``mid_channel_profile``: mean u_x binned by y over a periodic slice
  around x = DL/2 (SPH_Poiseuille.m:579-605), on the state's device.
"""

from __future__ import annotations

import math

import torch

from .neighbors import Candidates, Geometry, GridSpec


def wall_shear(spec: GridSpec, geom: Geometry, cands: Candidates,
               vx, vol, b11, b12, b21, b22, DL: float,
               mu, h: float, wall_visc_factor: float = 4.0):
    """Returns (tau_bottom, tau_top) as 0-dim tensors."""
    nf = spec.n_fluid
    ex, ey = geom.ex, geom.ey
    ebe = (ex * (b11[:nf][:, None] * ex + b12[:nf][:, None] * ey)
           + ey * (b21[:nf][:, None] * ex + b22[:nf][:, None] * ey))
    dv_x = vx[:nf][:, None] - cands.wvx_j
    f_pair = (wall_visc_factor * mu * ebe * geom.dw * geom.vol_j * dv_x
              / (geom.r + 0.01 * h) * vol[:nf][:, None]) * geom.mask_w
    tau_bottom = -torch.sum(f_pair * cands.wall_bot) / DL
    tau_top = -torch.sum(f_pair * cands.wall_top) / DL
    return tau_bottom, tau_top


def binned_profile_mean(y_values, u_values, weights, y_min: float,
                        y_max: float, n_bins: int):
    """Mean of u per y-bin (SPH_Poiseuille.m:579-590). ``weights`` selects
    which samples participate (1.0/0.0). Returns (y_mid, u_mean) with NaN
    for empty bins."""
    edges_step = (y_max - y_min) / n_bins
    dt = u_values.dtype
    dev = u_values.device
    y_mid = y_min + (torch.arange(n_bins, device=dev).to(dt) + 0.5) \
        * edges_step
    in_range = (y_values >= y_min) & (y_values <= y_max)
    w = weights * in_range.to(dt)
    bin_id = torch.clamp(((y_values - y_min) / edges_step).to(torch.int64),
                         0, n_bins - 1)
    sum_u = torch.zeros(n_bins, dtype=dt, device=dev).index_add_(
        0, bin_id, u_values * w)
    cnt = torch.zeros(n_bins, dtype=dt, device=dev).index_add_(0, bin_id, w)
    u_mean = torch.where(cnt > 0, sum_u / torch.clamp(cnt, min=1.0),
                         math.nan)
    return y_mid, u_mean


def mid_channel_profile(spec: GridSpec, x, y, vx, DL: float, DH: float,
                        mid_x: float, half_width: float, n_bins: int):
    """u(y) profile in the periodic slice |x - mid_x| <= half_width
    (SPH_Poiseuille.m:592-605)."""
    nf = spec.n_fluid
    x_wrap = torch.remainder(x[:nf], DL)
    dx_mid = torch.abs(x_wrap - mid_x)
    dx_mid = torch.minimum(dx_mid, DL - dx_mid)
    is_mid = (dx_mid <= half_width).to(x.dtype)
    return binned_profile_mean(y[:nf], vx[:nf], is_mid, 0.0, DH, n_bins)
