"""Cell-grid geometry for the fused cell-layout engine (torch port).

Ports the parts of the JAX package's ``ops/neighbors.py`` that the fused
and cell-layout engines reach: ``GridSpec``, ``make_grid_spec`` (with its
lane-packed column picker ``_lane_packed_nx``), ``_cell_coords`` and
``step_displacement_exceeded``. The grid choice
is the JAX package's own, so cores compare one for one with it; tuning the
grid for the GPU is left to a later change.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch


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
