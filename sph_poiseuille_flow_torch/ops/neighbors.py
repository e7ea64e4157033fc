"""Cell-grid geometry and the packed-gather candidate engine (torch port
of the JAX package's ``ops/neighbors.py``).

``GridSpec``, ``make_grid_spec`` (with its lane-packed column picker
``_lane_packed_nx``), ``_cell_coords`` and ``step_displacement_exceeded``
serve every engine; the grid choice is the JAX package's own, so cores
compare one for one with it. The rest is the gather engine's neighbor
pipeline (``stepper.Engine``): bin every particle, gather the raw 3x3-cell
candidates once per rebuild, compact each fluid row to its first ``C``
candidates within ``2h + skin`` (``Candidates``), and per step rebuild
the exact pair geometry at the cutoff ``2h`` from one packed gather
(``Geometry``). Every pair appears once per direction in the dense
``(n_fluid, C)`` rows; the operators (``ops/density.py``,
``viscosity.py``, ``transport.py``, ``integration.py``, ``monitors.py``)
take masked row sums over them. The compacted column order is the JAX
package's, column for column, so the float32 row sums add in its order.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple, Sequence

import torch

from .kernels import cubic_spline


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static neighbor-grid geometry (compile-time constants)."""

    n_fluid: int
    n_total: int
    DL: float
    DH: float
    h: float
    cutoff: float        # interaction cutoff = 2h
    cand_cutoff: float   # candidate retention cutoff = 2h + skin
    skin: float
    nx: int
    ny: int
    cell_x: float        # x cell width = DL/nx >= cand_cutoff
    cell_y: float
    y0: float            # grid origin in y
    K: int               # per-cell capacity
    C: int               # compacted per-particle candidate capacity
    # fused-engine knob plumbing (SPHConfig.geom_cache/geom_kcut/
    # fused_rows ride the spec so trace-time layout decisions deep in
    # ops/fused_cell.py see them without threading cfg through every
    # kernel wrapper; env vars still override at the decision point)
    geom_cache: str = "auto"
    geom_kcut: int = 0
    fused_rows: str = "auto"
    plan_r: int = 0      # row-group width R (0 = auto: R=1 when a row
    #                      fills the lanes, else the padded-cost model —
    #                      see fused_cell.plan)

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny

    @property
    def skin_x(self) -> float:
        """Per-axis pair-drift budget in x: a 3x3 stencil walk over frozen
        cells finds every pair within ``cutoff`` while the pair-relative
        x-displacement since rebuild stays below ``cell_x - cutoff`` (and
        likewise in y). Lane-packed fused grids make ``cell_x`` larger
        than ``cand_cutoff``, so the x budget exceeds the radial skin —
        the fused chunk guard exploits this per-axis slack."""
        return self.cell_x - self.cutoff

    @property
    def skin_y(self) -> float:
        return self.cell_y - self.cutoff

    @property
    def x_offsets(self):
        """Static wrapped x-column offsets; deduplicated for tiny domains so
        a cell is never visited twice (the reference dedups dynamically via
        its seen_neighbor stamp, sph_neighbor_search_mex.c:298-303)."""
        if self.nx >= 3:
            return (-1, 0, 1)
        if self.nx == 2:
            return (0, 1)
        return (0,)

    @property
    def n_raw_candidates(self) -> int:
        return len(self.x_offsets) * 3 * self.K


def _lane_packed_nx(cfg, cand_cutoff: float, y_span: float) -> int:
    """Pick ``nx`` for the fused cell-layout engine so a row-group's lane
    axis (R*nx for some R in 1..8) fills 128-lane vregs, weighing the
    padded-work factors of the fused kernels (ops/fused_cell.plan):
    padded lanes, row-group count, per-cell occupancy (the k-loop bound),
    and the candidate-slab sublane tiles. Occupancy is estimated from the
    lattice-aliasing bound — a window of width w covers at most
    floor(w/dp)+1 lattice columns, except at INTEGER w/dp where uniform
    x-translation is occupancy-invariant (a column enters exactly as one
    leaves) so the bound is w/dp exactly — plus a measured developed-flow
    compression margin: +3 over the pristine count at integer ratios
    (cell 3.0dp x 2.9dp: pristine 9, full-20 s max 12), +4 at non-integer
    ratios where aliasing and compression compound (cell 3.75dp x 2.9dp:
    pristine 12, K=15 overflowed the full run while K=18 stayed clean).
    Integer-ratio grids therefore win the cost model at equal work — the
    shipping dp=0.025 config (nx=40, K=14) is such a pick.
    Wider-than-``cand_cutoff`` x cells are allowed — they only
    ENLARGE the per-axis x drift budget (``GridSpec.skin_x``) — but any
    nx whose occupancy estimate exceeds ``cfg.cell_capacity`` is rejected
    (it would overflow the configured slot capacity)."""
    nx_max = max(1, int(math.floor(cfg.DL / cand_cutoff)))
    if nx_max < 3:
        return nx_max
    force = os.environ.get("SPH_LANEPACK_NX") \
        or getattr(cfg, "lane_pack_nx", 0)
    if force:  # config knob / tuning escape hatch (shape A/B probes)
        return min(int(force), nx_max)
    ny_est = int(math.ceil(y_span / cand_cutoff)) + 2
    k_cols_y = int(math.floor(cand_cutoff / cfg.dp)) + 1
    cutoff = 2.0 * cfg.h

    def pick(min_skin_x: float, margins=(3, 4)):
        best = None
        for nx in range(3, nx_max + 1):
            cell_x = cfg.DL / nx
            if cell_x - cutoff < min_skin_x:
                continue
            ratio = cell_x / cfg.dp
            exact = abs(ratio - round(ratio)) < 1e-9
            k_cols_x = int(round(ratio)) if exact \
                else int(math.floor(ratio)) + 1
            k_req = k_cols_x * k_cols_y + margins[0 if exact else 1]
            if k_req > cfg.cell_capacity:
                continue
            slab_tiles = -(-9 * k_req // 8)
            for R in range(1, 9):
                L = R * nx
                lanes = -(-L // 128) * 128
                groups = -(-ny_est // R)
                cost = lanes * groups * k_req * slab_tiles
                # tie-break toward more cells: same padded-lane cost with
                # a fuller vreg means fewer dead lanes
                if (best is None or cost < best[0]
                        or (cost == best[0] and nx > best[1])):
                    best = (cost, nx)
        return best

    # x drift is shear-dominated (the channel profile differentiates
    # x positions across rows), so the x budget must comfortably exceed
    # the radial skin or the drift guard rebuilds on x long before y;
    # require skin_x >= 3*skin where possible, else fall back. (With the
    # predictive drift guard a tight skin_x only shortens the rebuild
    # cadence — the integer-ratio picks from the relaxed pass measure
    # FASTER than wide-cell picks despite more rebuilds.)
    best = pick(3.0 * cfg.neighbor_skin)
    if best is None:
        best = pick(0.0)
    if best is None:
        # legacy occupancy margin (+2 uniformly): keeps pre-existing
        # validated combos resolving to their historical grids (e.g.
        # skin=0.75dp, K=18 -> nx=32 at dp=0.025) when the measured
        # margins above would reject every candidate
        best = pick(0.0, margins=(2, 2))
    return best[1] if best is not None else nx_max


def make_grid_spec(cfg, scene, wall_margin: float = 0.0,
                   s_multiple: int = 1, lane_pack: bool = False) -> GridSpec:
    """Build the static grid geometry from config + scene extents.

    ``s_multiple`` pads the cell-row count so the flattened cell axis
    S = ny*nx is divisible by it (jit shardings of the cell-layout engine
    require an even partition; extra rows hold only empty slots).

    ``lane_pack`` (fused Pallas engine): choose ``nx`` to fill 128-lane
    vregs instead of maximizing cell count — see ``_lane_packed_nx``."""
    cutoff = 2.0 * cfg.h
    cand_cutoff = cutoff + cfg.neighbor_skin
    if lane_pack:
        y_span = (cfg.DH + 2.0 * cfg.wall_thickness + 2.0 * wall_margin)
        nx = _lane_packed_nx(cfg, cand_cutoff, y_span)
    else:
        nx = max(1, int(math.floor(cfg.DL / cand_cutoff)))
    cell_x = cfg.DL / nx
    cell_y = cand_cutoff
    if lane_pack:
        # expand cell_y toward the next lattice-aliasing boundary: the
        # per-cell occupancy bound (floor(cell_y/dp)+1 lattice rows) is a
        # step function of cell_y, so growing 2.9dp -> 2.94dp costs NO
        # slot capacity while raising the per-axis y drift budget
        # (GridSpec.skin_y = cell_y - cutoff) by the slack — fewer
        # drift-forced rebuilds for free. The margin below the boundary
        # is the COMPRESSION tolerance: m+1 lattice rows fit a window of
        # height cell_y once row spacing compresses to cell_y/m, i.e. a
        # linear y-compression of 1 - cell_y/(m*dp). Weakly-compressible
        # density fluctuation reaches ~Ma^2 (~0.5% at the validation's
        # Ma=U_max/c_f~0.07; measured: margin 0.01dp = 0.33% tolerance
        # OVERFLOWED a K=15 cell at t~3.5 of the dp=0.025 run), so keep
        # 2%: margin = 0.06dp at m=3.
        m = math.floor(cand_cutoff / cfg.dp) + 1
        margin = float(os.environ.get("SPH_CELLY_MARGIN", "")
                       or getattr(cfg, "celly_margin", 0.06))
        grown = (m - margin) * cfg.dp
        if grown > cell_y:
            cell_y = grown
    # Static y extent: walls are immobile; fluid is confined to the channel.
    # One pad cell each side absorbs transient overshoot (clipped binning).
    y_lo = -cfg.wall_thickness - wall_margin
    y_hi = cfg.DH + cfg.wall_thickness + wall_margin
    ny = int(math.ceil((y_hi - y_lo) / cell_y)) + 2
    while (ny * nx) % s_multiple != 0:
        ny += 1
    y0 = y_lo - cell_y
    return GridSpec(
        n_fluid=scene.n_fluid, n_total=scene.n_total, DL=cfg.DL, DH=cfg.DH,
        h=cfg.h, cutoff=cutoff, cand_cutoff=cand_cutoff,
        skin=cfg.neighbor_skin, nx=nx, ny=ny, cell_x=cell_x, cell_y=cell_y,
        y0=y0, K=cfg.cell_capacity, C=cfg.neighbor_capacity,
        geom_cache=str(getattr(cfg, "geom_cache", "auto")),
        geom_kcut=int(getattr(cfg, "geom_kcut", 0)),
        fused_rows=str(getattr(cfg, "fused_rows", "auto")),
        plan_r=int(getattr(cfg, "plan_r", 0)),
    )


def _cell_coords(spec: GridSpec, x: torch.Tensor, y: torch.Tensor):
    """Integer cell coordinates (cx, cy) of every particle; x is wrapped
    into [0, DL) first and both axes are clipped to the grid."""
    xw = x - torch.floor(x / spec.DL) * spec.DL
    cx = torch.clamp(torch.floor(xw / spec.cell_x).to(torch.int32),
                     0, spec.nx - 1)
    cy = torch.clamp(torch.floor((y - spec.y0) / spec.cell_y).to(torch.int32),
                     0, spec.ny - 1)
    return cx, cy


def step_displacement_exceeded(spec: GridSpec, x0, y0, x1, y1):
    """True (0-dim bool) when a SINGLE step's motion crossed the half-skin
    budget (the JAX package's ``step_displacement_exceeded``): the
    unrecoverable drift-guard case, which an immediate rebuild cannot heal.
    Accumulated drift over several stale-list steps is healed in the
    engine by an early rebuild (``stepper.CellEngine``)."""
    if spec.skin <= 0.0:
        return torch.zeros((), dtype=torch.bool, device=x1.device)
    ddx = x1 - x0
    ddx = ddx - spec.DL * torch.round(ddx / spec.DL)
    ddy = y1 - y0
    return torch.max(ddx * ddx + ddy * ddy) > (0.5 * spec.skin) ** 2


class Candidates(NamedTuple):
    """Compacted candidate set + rebuild-static per-neighbor data.
    All (n_fluid, C) unless noted. Valid while no particle has moved more
    than skin/2 since the rebuild."""

    jsafe: torch.Tensor      # int64 neighbor index, clipped to n_total-1
    cvalid: torch.Tensor     # 1.0 for real candidates (state dtype)
    is_fluid_j: torch.Tensor  # 1.0 where neighbor is a fluid particle
    mass_j: torch.Tensor
    wvx_j: torch.Tensor      # prescribed wall velocity of neighbor
    wvy_j: torch.Tensor
    wall_bot: torch.Tensor   # 1.0 for bottom-wall neighbors (y_j <= 0)
    wall_top: torch.Tensor   # 1.0 for top-wall neighbors (y_j >= DH)
    ref_x: torch.Tensor      # (n_total,) positions at rebuild (skin guard)
    ref_y: torch.Tensor
    overflow: torch.Tensor   # 0-dim bool: cell or compaction capacity


class Geometry(NamedTuple):
    """Per-step pair geometry over the candidate set, masked to the exact
    interaction cutoff r < 2h. All (n_fluid, C)."""

    dx: torch.Tensor
    dy: torch.Tensor
    r: torch.Tensor        # 1.0 where invalid (safe division)
    ex: torch.Tensor       # dx/r
    ey: torch.Tensor
    w: torch.Tensor        # 0 where invalid
    dw: torch.Tensor       # 0 where invalid
    mask_f: torch.Tensor   # 1.0 valid fluid-fluid
    mask_w: torch.Tensor   # 1.0 valid fluid-wall
    x_j: torch.Tensor      # gathered neighbor positions (reused by callers)
    y_j: torch.Tensor
    vol_j: torch.Tensor    # gathered neighbor volume (for the shear monitor)


def gather_pack(jsafe: torch.Tensor, arrays: Sequence[torch.Tensor]):
    """ONE packed gather of several (n_total,) arrays at (n_fluid, C)
    indices: a (n_total, F) stack indexed once."""
    g = torch.stack(list(arrays), dim=-1)[jsafe]      # (n_fluid, C, F)
    return g.unbind(dim=-1)


def _raw_candidates(spec: GridSpec, x, y):
    """Bin all particles; gather the 3x3-cell raw candidate indices.
    Returns (idx_raw (n_fluid, 9K) int64 with sentinel n_total,
    cell_overflow). The per-cell counts use ``scatter_add`` with a known
    length, which unlike ``bincount`` needs no device sync; the scatter
    into the occupancy table writes past-capacity particles to one spare
    row that is sliced off (the JAX scatter's ``mode="drop"``). Every
    write is out of place, so the function maps over a lane axis
    (``torch.func.vmap``, the batched sweep)."""
    n = spec.n_total
    dev = x.device
    cx, cy = _cell_coords(spec, x, y)
    cid = cy.to(torch.int64) * spec.nx + cx.to(torch.int64)

    order = torch.argsort(cid, stable=True)
    cid_sorted = cid[order]
    counts = torch.zeros(spec.n_cells, dtype=torch.int64,
                         device=dev).scatter_add(0, cid, torch.ones_like(cid))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, dtype=torch.int64, device=dev) - starts[cid_sorted]
    cell_overflow = torch.max(counts) > spec.K

    n_slots = spec.n_cells * spec.K
    slot = torch.where(rank < spec.K, cid_sorted * spec.K + rank,
                       torch.full_like(rank, n_slots))
    table = torch.full((n_slots + 1,), n, dtype=torch.int64,
                       device=dev).index_put((slot,), order)
    table = table[:n_slots].reshape(spec.n_cells, spec.K)

    cxf = cx[: spec.n_fluid].to(torch.int64)
    cyf = cy[: spec.n_fluid].to(torch.int64)
    blocks = []
    for oy in (-1, 0, 1):
        cyn = cyf + oy
        y_ok = (cyn >= 0) & (cyn < spec.ny)
        cyn_c = torch.clamp(cyn, 0, spec.ny - 1)
        for ox in spec.x_offsets:
            cxn = torch.remainder(cxf + ox, spec.nx)
            cand = table[cyn_c * spec.nx + cxn]           # (n_fluid, K)
            blocks.append(torch.where(y_ok[:, None], cand,
                                      torch.full_like(cand, n)))
    return torch.cat(blocks, dim=1), cell_overflow


def build_candidates(spec: GridSpec, x, y, mass, wall_vx, wall_vy
                     ) -> Candidates:
    """Full candidate rebuild: raw 3x3 gather -> cutoff filter ->
    compaction to C entries -> packed static gather."""
    n = spec.n_total
    nf = spec.n_fluid
    idx_raw, cell_overflow = _raw_candidates(spec, x, y)
    jraw = torch.clamp(idx_raw, max=n - 1)

    xi = x[:nf][:, None]
    yi = y[:nf][:, None]
    xj, yj = gather_pack(jraw, (x, y))
    dx = xi - xj
    dx = dx - spec.DL * torch.round(dx / spec.DL)
    dy = yi - yj
    r2 = dx * dx + dy * dy
    self_row = torch.arange(nf, dtype=torch.int64, device=x.device)[:, None]
    valid = ((idx_raw < n) & (jraw != self_row)
             & (r2 < spec.cand_cutoff * spec.cand_cutoff) & (r2 > 1e-24))

    # compaction: stable-sort valid entries to the front, keep C columns
    # (an integer key: the stable order of a bool sort is not promised on
    # every device)
    n_valid = torch.sum(valid, dim=1)
    compaction_overflow = torch.max(n_valid) > spec.C
    perm = torch.argsort((~valid).to(torch.uint8), dim=1,
                         stable=True)[:, : spec.C]
    idx_c = torch.gather(idx_raw, 1, perm)
    cvalid_b = torch.gather(valid, 1, perm)
    jsafe = torch.clamp(idx_c, max=n - 1)

    mass_j, wvx_j, wvy_j, yj_c = gather_pack(jsafe,
                                             (mass, wall_vx, wall_vy, y))
    fdtype = x.dtype
    cvalid = cvalid_b.to(fdtype)
    is_wall_j = cvalid * (jsafe >= nf).to(fdtype)
    return Candidates(
        jsafe=jsafe, cvalid=cvalid,
        is_fluid_j=cvalid * (jsafe < nf).to(fdtype),
        mass_j=mass_j, wvx_j=wvx_j, wvy_j=wvy_j,
        wall_bot=is_wall_j * (yj_c <= 0.0).to(fdtype),
        wall_top=is_wall_j * (yj_c >= spec.DH).to(fdtype),
        ref_x=x, ref_y=y,
        overflow=cell_overflow | compaction_overflow,
    )


def compute_geometry(spec: GridSpec, cands: Candidates, x, y, vol
                     ) -> Geometry:
    """Per-step geometry over the compacted candidates, masked to the exact
    cutoff r < 2h. One packed gather ([x, y, vol])."""
    xj, yj, vol_j = gather_pack(cands.jsafe, (x, y, vol))
    xi = x[: spec.n_fluid][:, None]
    yi = y[: spec.n_fluid][:, None]
    dx = xi - xj
    # minimum-image along the x-periodic axis
    # (sph_neighbor_search_mex.c:359-363)
    dx = dx - spec.DL * torch.round(dx / spec.DL)
    dy = yi - yj
    r2 = dx * dx + dy * dy
    valid = ((cands.cvalid > 0) & (r2 < spec.cutoff * spec.cutoff)
             & (r2 > 1e-24))

    r = torch.sqrt(torch.where(valid, r2, torch.ones_like(r2)))
    w, dw = cubic_spline(r, spec.h)
    fvalid = valid.to(x.dtype)
    w = w * fvalid
    dw = dw * fvalid
    inv_r = 1.0 / r
    return Geometry(
        dx=dx * fvalid, dy=dy * fvalid, r=r,
        ex=dx * inv_r * fvalid, ey=dy * inv_r * fvalid,
        w=w, dw=dw,
        mask_f=fvalid * cands.is_fluid_j,
        mask_w=fvalid * (1.0 - cands.is_fluid_j) * cands.cvalid,
        x_j=xj, y_j=yj, vol_j=vol_j,
    )


def displacement_exceeded(spec: GridSpec, cands: Candidates, x, y):
    """Skin guard: True (0-dim bool) when some particle moved more than
    skin/2 since the candidate rebuild (the candidate set may have lost a
    true pair)."""
    if spec.skin <= 0.0:
        return torch.zeros((), dtype=torch.bool, device=x.device)
    ddx = x - cands.ref_x
    ddx = ddx - spec.DL * torch.round(ddx / spec.DL)
    ddy = y - cands.ref_y
    return torch.max(ddx * ddx + ddy * ddy) > (0.5 * spec.skin) ** 2


def count_pairs(geom: Geometry):
    """Reference-convention pair count (fluid-fluid stored once + all
    fluid-wall pairs), for log parity with SPH_Poiseuille.m:287-288."""
    n_ff_directed = torch.sum(geom.mask_f)
    n_fw = torch.sum(geom.mask_w)
    return (n_ff_directed / 2 + n_fw).to(torch.int32)
