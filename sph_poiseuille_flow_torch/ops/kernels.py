"""2D cubic-spline smoothing kernel (Monaghan M4), torch port of the JAX
package's ``ops/kernels.py`` (reference: sph_neighbor_search_mex.c:115-133,
sph_physics_mex.c:32-38). sigma = 10/(7 pi h^2); support radius 2h.

  W(q)  = sigma * (1 - 1.5 q^2 + 0.75 q^3)          0 <= q < 1
        = sigma * 0.25 * (2 - q)^3                  1 <= q < 2
        = 0                                         q >= 2
  dW/dr = sigma * (-3 q + 2.25 q^2) / h             0 <= q < 1
        = -sigma * 0.75 * (2 - q)^2 / h             1 <= q < 2
        = 0                                         q >= 2
"""

from __future__ import annotations

import math

import torch


def sigma_2d(h: float) -> float:
    return 10.0 / (7.0 * math.pi * h * h)


def w0(h: float) -> float:
    """Self contribution W(0, h) = sigma (sph_physics_mex.c:33-38)."""
    return sigma_2d(h)


def cubic_spline(r: torch.Tensor, h: float):
    """Return (W, dW/dr) for distances ``r`` (any shape)."""
    sigma = sigma_2d(h)
    q = r / h
    tq = 2.0 - q
    w_inner = sigma * (1.0 - 1.5 * q * q + 0.75 * q * q * q)
    w_outer = sigma * 0.25 * tq * tq * tq
    dw_inner = sigma * (-3.0 * q + 2.25 * q * q) / h
    dw_outer = -sigma * 0.75 * tq * tq / h
    zero = torch.zeros_like(q)
    w = torch.where(q < 1.0, w_inner, torch.where(q < 2.0, w_outer, zero))
    dw = torch.where(q < 1.0, dw_inner, torch.where(q < 2.0, dw_outer, zero))
    return w, dw
