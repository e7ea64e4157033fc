"""The work of the scheme, counted from the particle state alone: the
least time one card could take for it is the larger of its float32
operations over the peak rate and its bytes over the memory rate.

Per valid pair, counted from each of its two particles' sides as a
row-per-particle formulation visits it (a fluid-wall pair from the fluid
side only): the geometry (rsqrt, r, q, W, dW, masks, unit vector: 20),
the density sum (8), the gradient-correction matrix (13), the viscous,
shifting and pressure terms with their projections (62 + 41) and the
continuity term (15): 159. Per fluid particle: density and EOS (29), the
correction's inversion and blend (63), the limiter and the kick (36) and
the update (24): 152. Per fluid-wall pair, once an output interval, the
wall shear's geometry and term (20 + 21). These are the tallies of the
port's ``utils/roofline.py`` (SWEEP_PAIR_OPS, SWEEP_ANCHOR_OPS,
SHEAR_PAIR_OPS), copied here; the window test of candidates that lie
beyond 2h is left out, because how many a step tests depends on the
layout (cells, K, windows, lanes) and not on the state.

Bytes per step: the fields a step must read (x, y, vx, vy, drho_dt and the
mass of every particle) read once, and the fields it writes (x, y, vx,
vy, rho, p, drho_dt, the four forces, vol and the four entries of B of
every fluid particle) written once, 4 bytes each.
"""

from __future__ import annotations

import torch

from .reference.sph import candidate_pairs

PAIR_OPS = 20 + 8 + 13 + 62 + 41 + 15
PARTICLE_OPS = 29 + 63 + 36 + 24
SHEAR_PAIR_OPS = 20 + 21
READ_FIELDS, WRITE_FIELDS, WORD = 6, 16, 4


def pairs_within(x, y, n_fluid: int, DL: float, h: float):
    """(fluid-fluid pairs, fluid-wall pairs) with 0 < r < 2h, each pair
    once, by the reference's cell search."""
    i, j = candidate_pairs(x, y, n_fluid, DL, 2.0 * h)
    dx = x[i].double() - x[j].double()
    dx = dx - DL * torch.round(dx / DL)
    dy = y[i].double() - y[j].double()
    ok = dx * dx + dy * dy > 1e-24
    wall = j >= n_fluid
    return int((ok & ~wall).sum()), int((ok & wall).sum())


def step_work(ff: int, fw: int, n_fluid: int, n_total: int):
    """(operations, bytes) of one step whose state holds ``ff``
    fluid-fluid and ``fw`` fluid-wall pairs within 2h."""
    ops = (2 * ff + fw) * PAIR_OPS + n_fluid * PARTICLE_OPS
    nbytes = WORD * (READ_FIELDS * n_total + WRITE_FIELDS * n_fluid)
    return float(ops), float(nbytes)


def least_seconds(ops: float, nbytes: float, peak_ops: float,
                  peak_bytes: float):
    """(seconds, "operations" or "bytes"): the bound and what sets it."""
    t_ops, t_bytes = ops / peak_ops, nbytes / peak_bytes
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def window_least_seconds(points, steps, n_fluid: int, n_total: int,
                         peak_ops: float, peak_bytes: float):
    """The least time of a window of output intervals: interval k runs
    ``steps[k]`` steps from the state at output point k to the one at
    k + 1, each step counted at the mean of the two points' pair counts,
    and one wall-shear pass at its end. ``points``: (ff, fw) at each of
    the len(steps) + 1 output points. Returns (seconds, bound by)."""
    total, by = 0.0, {}
    for k, n in enumerate(steps):
        (ff0, fw0), (ff1, fw1) = points[k], points[k + 1]
        ops, nbytes = step_work(0.5 * (ff0 + ff1), 0.5 * (fw0 + fw1),
                                n_fluid, n_total)
        s, b = least_seconds(n * ops + fw1 * SHEAR_PAIR_OPS, n * nbytes,
                             peak_ops, peak_bytes)
        total += s
        by[b] = by.get(b, 0.0) + s
    return total, max(by, key=by.get) if by else None
