"""The least time one H100 could take for the work of a fused-kernel call:
the larger of the bytes the function must move (each input read once,
each output written once) over the memory rate and its float32 operations
over the peak rate outside the tensor cores (one H100 SXM at its 700 W
limit: 3.35 TB/s, 67 TFLOP/s). The work is counted from the inputs: the
pairs the call's position cores hold, not the most a grid could hold.

Operations, counted from csrc/fused_cell.cu: the window test of every
visited candidate (dx, dy, r^2 and two compares: 7); per valid pair the
geometry (rsqrt, r, q, w, dw, masks, unit vector: 20), sweep 0 (8), sweep 1
(13), sweep 2's two passes with the projections done once (62 + 41) and
sweep 3 (15); per visited anchor the density and EOS (29), the gradient
correction's inversion (63), the limiter and the kick (36) and the update
(24). The geometry and the window test belong to sweep 0: the function
needs them once per step, however often a form recomputes them. The
shear needs only the cell rows whose window holds a wall slot (the
layout's ``shear_rows``; every other partial is +0): the test per
candidate of their occupied anchors and, per valid wall pair, the geometry
and its term (20 + 21); in bytes, the seven cores its windows read (x, y,
isf, vol, wvx, wbot, wtop) over the halo'd rows those windows span, the
five it reads at the anchors only (vx, b11, b12, b21, b22) and the two
partials it writes over the listed rows, the row list and occ.
"""

from __future__ import annotations

import torch

PEAK_OPS, PEAK_BYTES = 67e12, 3.35e12
TEST_OPS, SHEAR_PAIR_OPS = 7, 41
SWEEP_PAIR_OPS = (20 + 8, 13, 62 + 41, 15)
SWEEP_ANCHOR_OPS = (29, 63, 36, 24)
# (halo'd, plain) cores each sweep reads and writes (body0 .. body3):
# sweep 0 reads x y isf mass | dr, writes vol rhoH pH | cnt; sweep 1 reads
# x y isf vol, writes b11 b12 b21 b22; sweep 2 reads x y isf mass vol vx vy
# b11 b12 b21 b22 rhoH pH wvx wvy, writes vx2 vy2 | fx fy fpx fpy dxs dys;
# sweep 3 reads x y isf vol vx vy vx2 vy2 rhoH wvx wvy | dxs dys, writes
# rho p drho x2 y2
SWEEP_CORES = (((4, 1), (3, 1)), ((4, 0), (4, 0)), ((15, 0), (2, 6)),
               ((11, 2), (0, 5)))


def pair_counts(spec, lay, xH, yH) -> dict:
    """Visited anchors, their candidates, valid pairs and valid wall pairs
    of these position cores; for the shear, the listed wall rows, the
    halo'd rows their windows span and the candidates of their occupied
    anchors."""
    from ..ops import fused_cell as fc
    nyp = xH.shape[0] - 2
    vis = fc._visited(spec, lay.occ, nyp)
    _, _, _, _, _, m1, mw = fc._geometry(
        spec, fc._pair(fc._anc(xH)), fc._pair(fc._anc(yH)),
        fc._win(spec, xH), fc._win(spec, yH), fc._win(spec, lay.isf_c),
        need_w=False)
    visf = vis.unsqueeze(-1).to(xH.dtype)
    anchors = float(vis.sum()) * spec.nx
    rows = lay.shear_rows.to(torch.int64)
    held = (fc._anc(xH) < 0.5 * fc._BIG_X) & vis
    return dict(anchors=anchors, cands=anchors * 9 * spec.K,
                pairs=float(torch.sum((m1 + mw) * visf)),
                wall=float(torch.sum(mw * visf)),
                wall_rows=rows.numel(),
                window_rows=torch.cat([rows, rows + 1, rows + 2]
                                      ).unique().numel(),
                wall_cands=float(held[rows].sum()) * 9 * spec.K,
                n_groups=lay.occ.numel())


def _ms(ops: float, nbytes: float):
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def bound(kind: str, spec, n: dict, n_steps: int = 1):
    """(bound_ms, bound_by) of one call on a grid with pair counts ``n``:
    ``kind`` is "step", "chunk" (of ``n_steps`` steps), "shear", "sweep0"
    .. "sweep3" (one sweep alone) or "noop"."""
    from ..ops import fused_cell as fc
    nyp = fc.plan(spec)[3]
    halo = (nyp + 2) * spec.K * (spec.nx + 2) * 4
    plain = nyp * spec.K * spec.nx * 4
    if kind == "noop":                 # one row of x in, one of vol out
        return _ms(0.0, 2 * (spec.nx + 2) * 4)
    if kind == "shear":
        row_h, row_p = spec.K * (spec.nx + 2) * 4, spec.K * spec.nx * 4
        nbytes = (7 * n["window_rows"] * row_h
                  + (5 + 2) * n["wall_rows"] * row_p
                  + 4 * (n["wall_rows"] + n["n_groups"]))
        return _ms(n["wall_cands"] * TEST_OPS + n["wall"] * SHEAR_PAIR_OPS,
                   nbytes)
    if kind.startswith("sweep"):
        s = int(kind[5:])
        (rh, rp), (wh, wp) = SWEEP_CORES[s]
        ops = (n["pairs"] * SWEEP_PAIR_OPS[s]
               + n["anchors"] * SWEEP_ANCHOR_OPS[s]
               + (n["cands"] * TEST_OPS if s == 0 else 0.0))
        return _ms(ops, (rh + wh) * halo + (rp + wp) * plain)
    step_ops = (n["cands"] * TEST_OPS + n["pairs"] * sum(SWEEP_PAIR_OPS)
                + n["anchors"] * sum(SWEEP_ANCHOR_OPS))
    if kind == "step":   # 8 halo'd + dr in; 7 halo'd + 9 plain + cnt out
        nbytes = 8 * halo + plain + 7 * halo + 10 * plain
    else:                # 9 halo'd + dr in; state 5 + 17 aux cores out
        nbytes = 8 * halo + plain + 4 * halo + plain + 7 * halo + 10 * plain
    return _ms(step_ops * n_steps, nbytes)


def expand_bound(rows: int, bx: int, K: int):
    """(bound_ms, bound_by) of the one-hot lane tiling of a (rows, bx)
    input: rows*bx*4 bytes in, rows*K*bx*4 out. Its output is the input
    tiled K times, so the function needs no arithmetic: bytes only."""
    return _ms(0.0, 4.0 * rows * bx * (1 + K))
