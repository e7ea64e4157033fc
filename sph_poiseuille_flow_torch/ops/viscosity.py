"""Morris-type laminar viscous force with corrected kernel gradients
(torch port of the JAX package's ``ops/viscosity.py``; the reference's
``viscous_force`` mode, sph_physics_mex.c:396-550). Pure row math over
caller-gathered neighbor values.

* fluid-fluid: coeff = e^T(B_i+B_j)e * mu * dW * Vol_j / (r + 0.01h),
  on (v_i - v_j) (c:489-520); each direction of a pair is its own row's
  term.
* fluid-wall: no-slip against the prescribed wall velocity with the 4.0
  one-sided factor (c:521-535), B_i only.
* Returned force = acc * Vol_i for fluid, zero for walls (c:538-545).
"""

from __future__ import annotations

import torch

from .neighbors import Candidates, Geometry, GridSpec


def viscous_force(spec: GridSpec, geom: Geometry, cands: Candidates,
                  vx, vy, vol, b11, b12, b21, b22,
                  vol_j, b11_j, b12_j, b21_j, b22_j, vx_j, vy_j,
                  mu, h: float, wall_visc_factor: float = 4.0):
    """Returns (fx, fy), shape (n_total,); wall rows are zero."""
    nf = spec.n_fluid
    n_wall = spec.n_total - nf
    ex, ey = geom.ex, geom.ey
    denom = geom.r + 0.01 * h

    b11i = b11[:nf][:, None]
    b12i = b12[:nf][:, None]
    b21i = b21[:nf][:, None]
    b22i = b22[:nf][:, None]
    vxi = vx[:nf][:, None]
    vyi = vy[:nf][:, None]

    # fluid-fluid: symmetric B sum
    bs11 = b11i + b11_j
    bs12 = b12i + b12_j
    bs21 = b21i + b21_j
    bs22 = b22i + b22_j
    ebe_f = ex * (bs11 * ex + bs12 * ey) + ey * (bs21 * ex + bs22 * ey)
    coeff_f = ebe_f * mu * geom.dw * vol_j / denom * geom.mask_f

    # fluid-wall: one-sided, B_i only, 4x no-slip factor
    ebe_w = ex * (b11i * ex + b12i * ey) + ey * (b21i * ex + b22i * ey)
    coeff_w = (wall_visc_factor * ebe_w * mu * geom.dw * vol_j / denom
               * geom.mask_w)

    acc_x = torch.sum(coeff_f * (vxi - vx_j) + coeff_w * (vxi - cands.wvx_j),
                      dim=1)
    acc_y = torch.sum(coeff_f * (vyi - vy_j) + coeff_w * (vyi - cands.wvy_j),
                      dim=1)

    zeros_w = acc_x.new_zeros((n_wall,))
    fx = torch.cat([acc_x * vol[:nf], zeros_w])
    fy = torch.cat([acc_y * vol[:nf], zeros_w])
    return fx, fy
