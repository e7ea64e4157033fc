"""Transport-velocity correction, i.e. particle shifting (torch port of the
JAX package's ``ops/transport.py``; the reference's
``transport_correction`` mode, sph_physics_mex.c:569-714). Pure row math
over caller-gathered neighbor values.

* fluid-fluid: inc_i += -dW * Vol_j * (B_i+B_j)e (c:656-685).
* fluid-wall: inc_i += -2 * dW * Vol_j * B_i e (mirror symmetry, c:686-699).
* limiter = clamp(100*|inc|^2/h^2, 0, 1); pos += coeff*h^2*limiter*inc
  (c:702-709). Positions only.
"""

from __future__ import annotations

import torch

from .neighbors import Geometry, GridSpec


def transport_correction(spec: GridSpec, geom: Geometry, x, y,
                         b11, b12, b21, b22,
                         vol_j, b11_j, b12_j, b21_j, b22_j,
                         h: float, transport_coeff: float):
    """Returns (x, y) with shifted fluid positions; walls unchanged."""
    nf = spec.n_fluid
    ex, ey = geom.ex, geom.ey

    b11i = b11[:nf][:, None]
    b12i = b12[:nf][:, None]
    b21i = b21[:nf][:, None]
    b22i = b22[:nf][:, None]

    tx_f = (b11i + b11_j) * ex + (b12i + b12_j) * ey
    ty_f = (b21i + b21_j) * ex + (b22i + b22_j) * ey
    coeff_f = -geom.dw * vol_j * geom.mask_f

    tx_w = b11i * ex + b12i * ey
    ty_w = b21i * ex + b22i * ey
    coeff_w = -2.0 * geom.dw * vol_j * geom.mask_w

    inc_x = torch.sum(coeff_f * tx_f + coeff_w * tx_w, dim=1)
    inc_y = torch.sum(coeff_f * ty_f + coeff_w * ty_w, dim=1)

    n2 = inc_x * inc_x + inc_y * inc_y
    limiter = torch.clamp(100.0 * n2 / (h * h), 0.0, 1.0)
    scale = transport_coeff * h * h * limiter

    x = torch.cat([x[:nf] + scale * inc_x, x[nf:]])
    y = torch.cat([y[:nf] + scale * inc_y, y[nf:]])
    return x, y
