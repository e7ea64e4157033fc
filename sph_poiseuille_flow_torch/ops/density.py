"""Kernel-summation density reinitialization + Kernel Gradient Correction
(torch port of the JAX package's ``ops/density.py``).

The reference's ``density_correction`` mode (sph_physics_mex.c:95-374) as
masked row sums over the gather engine's dense ``(n_fluid, C)`` neighbor
rows. The ops are pure row math: every neighbor-side (``*_j``) value is
supplied by the caller from a packed gather (``neighbors.gather_pack``).

* sigma_inner starts from the self contribution W(0) (c:178-181); fluid
  neighbors add W (c:197-205); wall neighbors add W * m_j/rho0 into
  sigma_contact (c:206-211).
* rho_i = sigma_inner*rho0*inv_sigma0 + sigma_contact*rho0^2*inv_sigma0/m_i,
  floored to rho0 below 1e-12 (c:218-225). Walls keep rho = rho0.
* KGC matrix A -= dx (x) (dW*Vol_j*e) over all neighbor kinds
  (c:239-312); regularized pseudo-inverse P = (A^T A + eps I)^-1 A^T with
  eps = 1e-8 (c:321-349); blend B = w1*P + w2*I (c:351-365); walls get
  B = I.
"""

from __future__ import annotations

import torch

from .kernels import w0
from .neighbors import Candidates, Geometry, GridSpec

EPS_REG = 1e-8


def density_sums(spec: GridSpec, geom: Geometry, cands: Candidates, mass,
                 rho0: float, inv_sigma0: float):
    """Kernel-summation density. Returns (rho, vol), both (n_total,)."""
    nf = spec.n_fluid
    n_wall = spec.n_total - nf
    sigma_inner = w0(spec.h) + torch.sum(geom.w * geom.mask_f, dim=1)
    sigma_contact = torch.sum(geom.w * (cands.mass_j / rho0) * geom.mask_w,
                              dim=1)
    rho_f = (sigma_inner * rho0 * inv_sigma0
             + sigma_contact * rho0 * rho0 * inv_sigma0 / mass[:nf])
    rho_f = torch.where(rho_f <= 1e-12, rho0, rho_f)
    rho = torch.cat([rho_f, rho_f.new_full((n_wall,), rho0)])
    return rho, mass / rho


def kernel_gradient_correction(spec: GridSpec, geom: Geometry, vol_j):
    """KGC matrix. ``vol_j`` is the caller-gathered neighbor volume.
    Returns (b11, b12, b21, b22), each (n_total,) with walls = identity."""
    n_wall = spec.n_total - spec.n_fluid

    f = geom.dw * vol_j * (geom.mask_f + geom.mask_w)
    a11 = -torch.sum(geom.dx * f * geom.ex, dim=1)
    a12 = -torch.sum(geom.dx * f * geom.ey, dim=1)
    a21 = -torch.sum(geom.dy * f * geom.ex, dim=1)
    a22 = -torch.sum(geom.dy * f * geom.ey, dim=1)

    # regularized pseudo-inverse P = (A^T A + eps I)^-1 A^T
    ata11 = a11 * a11 + a21 * a21 + EPS_REG
    ata12 = a11 * a12 + a21 * a22
    ata22 = a12 * a12 + a22 * a22 + EPS_REG
    det_m = ata11 * ata22 - ata12 * ata12
    degenerate = torch.abs(det_m) < 1e-20
    det_m_safe = torch.where(degenerate, 1.0, det_m)
    im11 = ata22 / det_m_safe
    im12 = -ata12 / det_m_safe
    im22 = ata11 / det_m_safe
    p11 = torch.where(degenerate, 1.0, im11 * a11 + im12 * a12)
    p12 = torch.where(degenerate, 0.0, im11 * a21 + im12 * a22)
    p21 = torch.where(degenerate, 0.0, im12 * a11 + im22 * a12)
    p22 = torch.where(degenerate, 1.0, im12 * a21 + im22 * a22)

    # determinant-weighted blend toward identity
    det_a = a11 * a22 - a12 * a21
    det_sqr = torch.clamp(1.0 - det_a, min=0.0)
    denom = det_a + det_sqr
    small = torch.abs(denom) < 1e-12
    denom_safe = torch.where(small, 1.0, denom)
    w1 = torch.where(small, 0.0, det_a / denom_safe)
    w2 = torch.where(small, 1.0, det_sqr / denom_safe)

    ones_w = a11.new_ones((n_wall,))
    zeros_w = a11.new_zeros((n_wall,))
    b11 = torch.cat([w1 * p11 + w2, ones_w])
    b12 = torch.cat([w1 * p12, zeros_w])
    b21 = torch.cat([w1 * p21, zeros_w])
    b22 = torch.cat([w1 * p22 + w2, ones_w])
    return b11, b12, b21, b22
