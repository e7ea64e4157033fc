"""Fused cell-layout SPH step (torch port of the JAX package's
``ops/fused_cell.py``).

Layout, as in the JAX package:

* every field travels as a HALO'D CORE ``(nyp+2, K, nx+2)`` -- cell row,
  slot rank, cell column with wrapped x-halo columns -- or as a PLAIN core
  ``(nyp, K, nx)``;
* empty slots ride at x = ``_BIG_X``, so the r^2 window test alone masks
  them, and the self pair drops out through r^2 == 0;
* ``occ`` bounds the anchor ranks each row group visits (``plan`` defines
  the groups); skipped ranks keep zeroed outputs and their positions.

One physics step is four sweeps (density, kernel gradient correction,
forces + kick, continuity + positions). Each of the three entry points --
``fused_step_cores``, ``fused_chunk_call`` and ``fused_wall_shear_cores``
-- launches its hand-written CUDA kernel (``fused_cell_cuda``) for CUDA
tensors and runs its plain PyTorch twin (``*_plain`` below) for CPU
tensors. The twins build the ``(nyp, 9K, nx)`` window stacks by slicing
the halo'd cores and do the sweep algebra as tensor ops, in the JAX
package's operation order; they are what the kernels are held to.

The step and the chunk come in the forms the JAX package's layout knobs
select (``step_form``/``chunk_form``, resolved exactly as the JAX package
resolves them): the recompute sweeps ("none"), the geometry cache
("full", "ring", "partial" -- ranks below ``k_cut`` cached) and the
candidate-row-outer loop ("rows"). The plain twins differ between them
only where the JAX cached expressions associate differently (sweep 1).
Each plain sweep is a function of its own (``_sweep0_plain`` ..
``_sweep3_plain``, the cores each writes in ``SWEEP_WRITES``), so that
``ops/probes.py`` can run a sweep range.

The rebuild glue (slot assignment, packed scatter, takes) is plain
torch in ``build_fused_layout``, as it is XLA in the JAX package; init,
the per-step path and the mesh's re-bin build their layouts with it. The
engine's interval loop runs on persistent buffers instead. Its
sub-chunks run through ``ChunkRunner``: on the card one call a
sub-chunk (``sph_chunk_run``), the chunk and the drift guard's bounds
together; on the CPU the plain twins fill the same buffers. Its rebuilds
between groups run through ``RebuildRunner`` on persistent layout sets:
on the card one enqueued call a rebuild (``sph_rebuild``), on the CPU
the engine's ``_do_rebuild`` (``build_fused_layout``) fills the set.
``fused_chunk_call`` and ``pair_drift_bounds`` stay as what a runner's
call is held to bit for bit, ``_do_rebuild`` as what a rebuild is.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from . import fused_cell_cuda
from .kernels import sigma_2d, w0
from .neighbors import GridSpec

_BIG_X = 1.0e9   # x-core fill for empty slots: past the cutoff from all


def plan(spec: GridSpec):
    """(R, L, n_groups, nyp): R cell rows per row group, as the JAX
    package picks them. On the GPU R only defines the ``occ`` row groups
    (the anchor-rank bound is a max over the group's rows), which decides
    the values left in never-visited empty slots -- so it must match the
    JAX package for whole-core comparisons."""
    nx, ny = spec.nx, spec.ny
    forced = (int(os.environ.get("SPH_PLAN_R", "0"))
              or int(getattr(spec, "plan_r", 0)))
    if forced > 0:
        R = min(forced, 8)
        n_groups = -(-ny // R)
        return R, R * nx, n_groups, R * n_groups
    if nx >= 100:
        return 1, nx, ny, ny
    best = None
    for R in range(1, 9):
        L = R * nx
        cost = -(-L // 128) * 128 * (-(-ny // R))
        if best is None or cost < best[0]:
            best = (cost, R)
    R = best[1]
    n_groups = -(-ny // R)
    return R, R * nx, n_groups, R * n_groups


# ---------------------------------------------------------------------------
# layout-knob resolution (the JAX package's fused_cell.py:364-557, :1482-1501)
# ---------------------------------------------------------------------------
#
# The budgets are the TPU's VMEM figures. They are kept so that for every
# spec, knob and environment variable the port resolves the same form and
# k_cut as the JAX package, which makes the cores comparable one for one.
# Re-picking "auto" for the H100 waits for measurements on the card.

_N_CACHE = 5        # cached per pair: ex ey r dw*m1 dw*mw
_GEOM_CACHE_BUDGET = 48 * 1024 * 1024
_RING_CACHE_BUDGET = 80 * 1024 * 1024
_PARTIAL_CACHE_BUDGET = 64 * 1024 * 1024
_RING_DEPTH = 4


def _itemsize(dtype) -> int:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty((), dtype=dtype).element_size()


def _cache_bytes(spec: GridSpec, dtype, n_slots: int,
                 k_cut: int | None = None) -> int:
    R, L, n_groups, nyp = plan(spec)
    K = spec.K if k_cut is None else k_cut
    sub = -(-9 * spec.K // 8) * 8
    lanes = -(-L // 128) * 128
    return _N_CACHE * n_slots * K * sub * lanes * _itemsize(dtype)


def use_geom_cache(spec: GridSpec, dtype) -> bool:
    """True when the JAX package's full per-(group, k) cache fits its
    VMEM budget."""
    n_groups = plan(spec)[2]
    return _cache_bytes(spec, dtype, n_groups) <= _GEOM_CACHE_BUDGET


def _k_unroll() -> int:
    """The JAX package's anchor-rank unroll (SPH_FUSED_UNROLL). The unroll
    is TPU scheduling; the port reads it only to align ``k_cut`` as the
    JAX package does."""
    return max(1, int(os.environ.get("SPH_FUSED_UNROLL", "1")))


def cache_plan(spec: GridSpec, dtype) -> tuple:
    """("full"|"ring"|"partial"|"none", k_cut): the geometry-cache form and
    the number of cached anchor ranks (K except for "partial"), from
    ``spec.geom_cache``/``spec.geom_kcut`` with the environment variables
    SPH_GEOM_CACHE and SPH_GEOM_KCUT overriding them."""
    K = spec.K
    env = (os.environ.get("SPH_GEOM_CACHE", "")
           or getattr(spec, "geom_cache", "auto"))

    def partial_kcut():
        kc = (int(os.environ.get("SPH_GEOM_KCUT", "0"))
              or int(getattr(spec, "geom_kcut", 0)))
        if kc <= 0:
            kc = K - 1
            while kc >= 2 and _cache_bytes(
                    spec, dtype, _RING_DEPTH, kc) > _PARTIAL_CACHE_BUDGET:
                kc -= 1
        u = _k_unroll()
        return min(kc - kc % u, K)

    if env in ("0", "none"):
        return "none", 0
    if env in ("full", "ring"):
        return env, K
    if env == "partial":
        return "partial", partial_kcut()
    if use_geom_cache(spec, dtype):
        return "full", K
    if _cache_bytes(spec, dtype, _RING_DEPTH) <= _RING_CACHE_BUDGET:
        return "ring", K
    kc = partial_kcut()
    if kc >= 2:
        return "partial", kc
    return "none", 0


def cache_mode(spec: GridSpec, dtype) -> str:
    return cache_plan(spec, dtype)[0]


def use_rows(spec: GridSpec, dtype) -> bool:
    """The candidate-row-outer loop (``spec.fused_rows``, environment
    variable SPH_FUSED_ROWS); off unless asked for, as in the JAX
    package."""
    v = (os.environ.get("SPH_FUSED_ROWS", "")
         or getattr(spec, "fused_rows", "auto"))
    return v == "1"


def chunk_form(spec: GridSpec, dtype) -> tuple:
    """(form, k_cut) of the chunk (JAX fused_chunk_call, :1724-1725):
    "rows" forces the recompute loop, so it takes no cache."""
    if use_rows(spec, dtype):
        return "rows", 0
    return cache_plan(spec, dtype)


def step_form(spec: GridSpec, dtype) -> tuple:
    """(form, k_cut) of the single step (JAX _fused_call, :1482-1501): a
    forced ring or partial cache whose size busts the JAX package's own
    budget drops to the full cache when that fits, else to recompute."""
    cm, kc = chunk_form(spec, dtype)
    if (cm in ("ring", "partial")
            and _cache_bytes(spec, dtype, _RING_DEPTH,
                             kc if cm == "partial" else None)
            > (_RING_CACHE_BUDGET if cm == "ring"
               else _PARTIAL_CACHE_BUDGET)):
        cm, kc = (("full", spec.K) if use_geom_cache(spec, dtype)
                  else ("none", 0))
    return cm, kc


def _cached_ranks(form: str, k_cut: int) -> int:
    """Anchor ranks k < this read the geometry cache (0: none)."""
    return k_cut if form in ("full", "ring", "partial") else 0


class FusedLayout(NamedTuple):
    """Per-rebuild state of the fused engine: scatter/take indices and the
    static halo'd cores (the layout-level ghost entries,
    sph_neighbor_search_mex.c:267-295)."""

    pidx: torch.Tensor   # (n,) int64 flat index into (nyp, K, nx)
    hidx: torch.Tensor   # (n,) int64 flat index into (nyp+2, K, nx+2)
    isf_c: torch.Tensor  # halo'd 1.0-fluid mask core (0.0 wall/empty)
    mass_c: torch.Tensor
    wvx_c: torch.Tensor  # prescribed wall velocity
    wvy_c: torch.Tensor
    wbot_c: torch.Tensor  # bottom/top wall membership masks
    wtop_c: torch.Tensor
    refx_p: torch.Tensor  # PLAIN position cores at rebuild
    refy_p: torch.Tensor
    occ: torch.Tensor     # (n_groups, 1) int32 anchor-rank bound per group
    overflow: torch.Tensor  # 0-dim bool
    # the wall shear's static data (``shear_row_list``; walls do not move,
    # so an engine builds it from its first layout and hands it to every
    # rebuild): the (n,) int32 cell rows, ascending, whose window rows
    # (halo'd rows iy .. iy+2) hold a slot with wbot or wtop set, the only
    # rows whose partials are not +-0; the (2, nyp, K, nx) per-slot
    # partials (bottom, top), zeroed once: the kernel writes the listed
    # rows only, so every other slot keeps +0
    shear_rows: torch.Tensor = None
    shear_tbt: torch.Tensor = None


def _scatter(n_slots: int, idx, vals, fill):
    """Packed scatter with the JAX ``mode="drop"`` semantics: indices
    equal to ``n_slots`` (the overflow sentinel) land in a spare row that
    is cut off."""
    flat = torch.empty((n_slots + 1,) + tuple(vals.shape[1:]),
                       dtype=vals.dtype, device=vals.device)
    flat[:] = torch.as_tensor(fill, dtype=vals.dtype, device=vals.device)
    flat[idx] = vals
    return flat[:n_slots]


def make_plain(spec: GridSpec, pidx, vals, fill: float = 0.0):
    """Packed scatter of a per-particle array into the PLAIN (nyp, K, nx)
    core (no halo)."""
    nyp = plan(spec)[3]
    nx, K = spec.nx, spec.K
    return _scatter(nyp * K * nx, pidx, vals, fill).reshape(nyp, K, nx)


def halo_ify(spec: GridSpec, plain, fill: float = 0.0,
             xshift: float = 0.0):
    """PLAIN (nyp, K, nx) core -> halo'd (nyp+2, K, nx+2): wrapped x
    columns (zeroed for nx < 3) + ``fill`` y-halo rows. ``xshift`` (the x
    POSITION core passes DL) makes the halo columns hold the TRANSLATED
    copies x -+ DL, the reference's ghost-entry translation
    (sph_neighbor_search_mex.c:282-295)."""
    nyp, K, nx = plain.shape
    if nx >= 3:
        left, right = plain[:, :, -1:] - xshift, plain[:, :, :1] + xshift
    else:
        left = right = torch.full((nyp, K, 1), fill, dtype=plain.dtype,
                                  device=plain.device)
    c = torch.cat([left, plain, right], dim=2)
    pad = torch.full((1, K, nx + 2), fill, dtype=plain.dtype,
                     device=plain.device)
    return torch.cat([pad, c, pad], dim=0)


def halo_ify_many(spec: GridSpec, plains):
    """``halo_ify`` (fill 0, no shift) of several plain cores in one go:
    the same values, in fewer launches. Returns contiguous halo'd cores."""
    stack = torch.stack(list(plains))
    F, nyp, K, nx = stack.shape
    if nx >= 3:
        c = torch.cat([stack[..., -1:], stack, stack[..., :1]], dim=3)
    else:
        c = torch.nn.functional.pad(stack, (1, 1))
    out = torch.nn.functional.pad(c, (0, 0, 0, 0, 1, 1))
    return [out[f] for f in range(F)]


def make_core(spec: GridSpec, pidx, vals, fill: float = 0.0,
              xshift: float = 0.0):
    """Packed scatter of a per-particle array into the halo'd core."""
    return halo_ify(spec, make_plain(spec, pidx, vals, fill), fill,
                    xshift=xshift)


def _packed_cores(spec: GridSpec, pidx, fields, fills):
    """Scatter F per-particle arrays into plain cores with ONE packed
    scatter. Returns a list of (nyp, K, nx) plain cores."""
    nyp = plan(spec)[3]
    nx, K = spec.nx, spec.K
    pack = torch.stack(fields, dim=-1)
    fill_row = torch.as_tensor(fills, dtype=pack.dtype, device=pack.device)
    out = _scatter(nyp * K * nx, pidx, pack, fill_row)
    out = out.reshape(nyp, K, nx, len(fields))
    return [out[..., f].contiguous() for f in range(len(fields))]


def build_fused_layout(spec: GridSpec, x, y, mass, wall_vx, wall_vy,
                       wall_y, state_fields=(), shear=None
                       ) -> FusedLayout:
    """Slot assignment + static cores. ``state_fields`` optionally rides
    extra per-particle arrays through the SAME packed scatter (the
    in-loop rebuild scatters vx/vy/drho this way); their plain cores are
    returned as a second value. ``shear``: (shear_rows, shear_tbt) of an
    earlier layout of the same walls (walls do not move, so they hold for
    every rebuild); built here from the wall cores when not given."""
    from .cellgrid import assign_slots

    R, L, n_groups, nyp = plan(spec)
    nx, K = spec.nx, spec.K
    dev = x.device
    slot, overflow = assign_slots(spec, x, y)
    cell = slot // K
    k = slot % K
    iy = cell // nx
    ix = cell - iy * nx
    in_range = slot < spec.n_cells * K  # overflow sentinel -> dropped
    pidx = torch.where(in_range, (iy * K + k) * nx + ix,
                       torch.full_like(slot, nyp * K * nx))
    hidx = torch.where(in_range, ((iy + 1) * K + k) * (nx + 2) + ix + 1,
                       torch.full_like(slot, (nyp + 2) * K * (nx + 2)))

    # per-row-group anchor-rank bound: the max occupancy of any cell in
    # the group's R rows (sph_neighbor_search_mex.c:69-113)
    ones = torch.zeros(spec.n_cells, dtype=torch.int32, device=dev)
    ones.scatter_add_(0, torch.clamp(cell, max=spec.n_cells - 1),
                      in_range.to(torch.int32))
    occ_rows = torch.zeros((nyp, nx), dtype=torch.int32, device=dev)
    occ_rows[:spec.ny] = ones.reshape(spec.ny, nx)
    occ = torch.amax(occ_rows.reshape(n_groups, R * nx), dim=1,
                     keepdim=True)
    occ = torch.clamp(occ, max=K).to(torch.int32)

    fields = (layout_statics(spec, mass, wall_vx, wall_vy, wall_y, x)
              + [x, y] + list(state_fields))
    fills = [0.0] * 6 + [_BIG_X, 0.0] + [0.0] * len(state_fields)
    cores = _packed_cores(spec, pidx, fields, fills)
    wbot_c, wtop_c = halo_ify(spec, cores[4]), halo_ify(spec, cores[5])
    shear_rows, shear_tbt = (shear_row_list(wbot_c, wtop_c) if shear is None
                             else shear)
    lay = FusedLayout(
        pidx=pidx, hidx=hidx,
        isf_c=halo_ify(spec, cores[0]),
        mass_c=halo_ify(spec, cores[1]),
        wvx_c=halo_ify(spec, cores[2]),
        wvy_c=halo_ify(spec, cores[3]),
        wbot_c=wbot_c, wtop_c=wtop_c,
        refx_p=cores[6], refy_p=cores[7],
        occ=occ, overflow=overflow, shear_rows=shear_rows,
        shear_tbt=shear_tbt)
    if state_fields:
        return lay, cores[8:]
    return lay


def layout_statics(spec: GridSpec, mass, wall_vx, wall_vy, wall_y, like):
    """The per-particle fields of a layout's static cores, in
    ``build_fused_layout``'s float type (``like``'s): the fluid mask, the
    mass, the prescribed wall velocity and the bottom/top wall masks
    (walls by their rest height ``wall_y``)."""
    fdtype = like.dtype
    is_fluid = (torch.arange(spec.n_total, device=like.device)
                < spec.n_fluid).to(fdtype)
    is_wall = 1.0 - is_fluid
    return [is_fluid, mass, wall_vx, wall_vy,
            is_wall * (wall_y <= 0.0).to(fdtype),
            is_wall * (wall_y >= spec.DH).to(fdtype)]


def shear_row_list(wbot_c, wtop_c):
    """(shear_rows, shear_tbt) of ``FusedLayout``: the anchor rows whose
    window rows (halo'd rows iy .. iy+2) hold a slot with ``wbot`` or
    ``wtop`` set, the only rows whose wall-shear partials are not +-0, and
    the zeroed partials, on the cores' device (one host sync: an engine
    builds them once)."""
    wall = ((wbot_c != 0) | (wtop_c != 0)).flatten(1).any(dim=1)
    near = wall[:-2] | wall[1:-1] | wall[2:]
    nyp, K, nx = wbot_c.shape[0] - 2, wbot_c.shape[1], wbot_c.shape[2] - 2
    return (torch.nonzero(near).flatten().to(torch.int32),
            torch.zeros((2, nyp, K, nx), dtype=wbot_c.dtype,
                        device=wbot_c.device))


def take_h(lay: FusedLayout, core):
    """Collect a halo'd core back to particle order (one packed take).
    The overflow sentinel is clamped, as the JAX gather clamps it."""
    flat = core.reshape(-1)
    return flat[torch.clamp(lay.hidx, max=flat.numel() - 1)]


def take_p(lay: FusedLayout, core):
    """Collect a plain core back to particle order (one packed take)."""
    flat = core.reshape(-1)
    return flat[torch.clamp(lay.pidx, max=flat.numel() - 1)]


# ---------------------------------------------------------------------------
# candidate-validity guard (plain torch; XLA-side in the JAX package)
# ---------------------------------------------------------------------------


def pair_drift_bounds(spec: GridSpec, lay: FusedLayout, x2P, y2P):
    """Per-axis upper bounds (bx, by) on the PAIR-RELATIVE displacement
    since the rebuild (JAX ``pair_drift_bounds``, fused_cell.py:1786-1849):
    fluid slots contribute their drift, wall slots anchor the range at 0,
    empty slots are excluded; the max over 2-row x 2-column (x-wrapped)
    windows of the per-slot displacement range bounds every candidate
    pair. Candidates stay valid while bx <= skin_x and by <= skin_y.
    On the card the chunk path takes them in ``sph_chunk_run``'s drift
    kernels (``ChunkRunner``), which equal this."""
    return DriftRef(lay.refx_p, lay.refy_p, lay.isf_c).bounds(spec.nx, x2P,
                                                              y2P)


def drift_row_ranges(fl, refx, refy, x2P, y2P):
    """The per-cell halves of ``pair_drift_bounds`` on plain cores
    (rows, K, nx) of any run of rows: (max, min) over slot rank of the
    (x, y) drift, each (2, rows, nx), fluid slots (``fl``) by their drift,
    wall slots as 0, empty slots (refx at the parking value) left out."""
    occm = refx < 0.5 * _BIG_X
    big = torch.tensor(1e30, dtype=x2P.dtype, device=x2P.device)
    zero = torch.zeros((), dtype=x2P.dtype, device=x2P.device)
    d = torch.stack([x2P - refx, y2P - refy])  # (2, rows, K, nx)
    dmax = torch.where(fl, d, torch.where(occm, zero, -big))
    dmin = torch.where(fl, d, torch.where(occm, zero, big))
    return torch.amax(dmax, dim=2), torch.amin(dmin, dim=2)


def drift_window_bounds(mx, mn, nx: int):
    """(bx, by) from the whole grid's ``drift_row_ranges``: the largest
    range over 2-row x 2-column (x-wrapped) windows."""
    mx = torch.maximum(mx[:, :-1], mx[:, 1:])     # 2-row windows
    mn = torch.minimum(mn[:, :-1], mn[:, 1:])
    if nx >= 3:
        mx = torch.maximum(mx, torch.roll(mx, -1, dims=2))  # 2-col,
        mn = torch.minimum(mn, torch.roll(mn, -1, dims=2))  # x-wrapped
    else:
        mx = torch.amax(mx, dim=2, keepdim=True)
        mn = torch.amin(mn, dim=2, keepdim=True)
    b = torch.amax(torch.clamp(mx - mn, min=0.0), dim=(1, 2))
    return b[0], b[1]


def pair_drift_exceeded(spec: GridSpec, lay: FusedLayout, x2P, y2P):
    """True iff a per-axis drift bound exceeds its budget."""
    if spec.skin <= 0.0:
        return torch.zeros((), dtype=torch.bool, device=x2P.device)
    bx, by = pair_drift_bounds(spec, lay, x2P, y2P)
    return torch.logical_or(bx > spec.skin_x, by > spec.skin_y)


# ---------------------------------------------------------------------------
# plain PyTorch twins of the sweeps
# ---------------------------------------------------------------------------


def _win(spec: GridSpec, core):
    """Halo'd core -> (nyp, 1, 9K, nx) candidate windows, (dy, dx, k) order
    (the JAX package's _stage, fused_cell.py:251-263)."""
    nyp, nx = core.shape[0] - 2, spec.nx
    w = torch.cat([core[dy:dy + nyp, :, dx:dx + nx]
                   for dy in range(3) for dx in range(3)], dim=1)
    return w.unsqueeze(1)


def _anc(core):
    """Halo'd core -> (nyp, K, nx) anchor (center) values."""
    return core[1:-1, :, 1:-1]


def _pair(a):
    """(nyp, K, nx) anchor values -> (nyp, K, 1, nx) for pair math."""
    return a.unsqueeze(2)


def _visited(spec: GridSpec, occ, nyp: int):
    """(nyp, K, 1) mask of the anchor ranks the row groups visit."""
    R = plan(spec)[0]
    occ_rows = occ[:, 0].repeat_interleave(R)[:nyp]
    ks = torch.arange(spec.K, device=occ.device)
    return (ks[None, :] < occ_rows[:, None]).unsqueeze(2)


def _geometry(spec: GridSpec, xa, ya, xv, yv, isfv, need_w=True):
    """Masked pair geometry (r, ex, ey, w, dw, m1, mw) of the anchors vs
    the candidate windows (JAX _geometry, fused_cell.py:300-344)."""
    h = spec.h
    dx = xa - xv
    if spec.nx < 3:
        dx = dx - spec.DL * torch.round(dx / spec.DL)
    dy = ya - yv
    r2 = dx * dx + dy * dy
    fvalid = ((r2 < spec.cutoff * spec.cutoff) & (r2 > 1e-24)).to(xa.dtype)
    rs = torch.rsqrt(torch.clamp(r2, min=1e-24))
    r = r2 * rs
    sigma = sigma_2d(h)
    q = r / h
    tq = 2.0 - q
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    w = None
    if need_w:
        w = torch.where(q < 1.0,
                        sigma * (1.0 - 1.5 * q * q + 0.75 * (q * q * q)),
                        torch.where(q < 2.0, sigma * 0.25 * (tq * tq * tq),
                                    zero))
        w = w * fvalid
    soh = sigma / h
    dw = torch.where(q < 1.0, q * (2.25 * soh * q - 3.0 * soh),
                     torch.where(q < 2.0, -0.75 * soh * tq * tq, zero))
    m1 = fvalid * isfv
    mw = fvalid - m1
    return r, dx * rs, dy * rs, w, dw, m1, mw


def cache_list_plain(spec: GridSpec, lay: FusedLayout, xH, yH,
                     k_cut: int) -> dict:
    """Plain version of the geometry-cache form's list as its sweep 0
    writes it (csrc/fused_cell.cu FORM_CACHE, read back by
    ``fused_cell_cuda.StepBuffers.cache_list``): for each cached slot
    s = (iy*k_cut + k)*nx + ix (ranks k < ``k_cut``), the valid candidates
    of a visited anchor in the (dy, dx, k) window order, with their
    halo'd-core index ``idx``, ``ex``, ``ey``, ``r``, ``c1`` = dw*m1 and
    ``cw`` = dw*mw, as (ncs, 9K) rows whose entries e >= n[s] are zero
    (idx -1); ``n`` (ncs,) int32, 0 for ranks the row group does not
    visit. For tests and chip_smoke.py only."""
    nyp, K, nx = xH.shape[0] - 2, spec.K, spec.nx
    r, ex, ey, _, dw, m1, mw = _geometry(
        spec, _pair(_anc(xH)), _pair(_anc(yH)), _win(spec, xH),
        _win(spec, yH), _win(spec, lay.isf_c), need_w=False)
    hidx = torch.arange(xH.numel(), device=xH.device).reshape(xH.shape)
    full = (nyp, K, 9 * K, nx)

    def slots(t):   # (nyp, K, 9K, nx) -> (ncs, 9K), cached ranks only
        return t.expand(full)[:, :k_cut].permute(0, 1, 3, 2).reshape(
            -1, 9 * K)

    valid = slots((m1 + mw > 0) & _visited(spec, lay.occ, nyp).unsqueeze(-1))
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    n = valid.sum(dim=1)
    used = torch.arange(9 * K, device=xH.device)[None, :] < n[:, None]
    out = {name: torch.where(used, torch.gather(slots(t), 1, order),
                             torch.zeros((), dtype=t.dtype, device=t.device))
           for name, t in (("ex", ex), ("ey", ey), ("r", r),
                           ("c1", dw * m1), ("cw", dw * mw))}
    out["idx"] = torch.where(used, torch.gather(slots(_win(spec, hidx)), 1,
                                                order), -1).to(torch.int32)
    out["n"] = n.to(torch.int32)
    return out


class _Sweep:
    """What the plain sweeps share: the step's inputs, the masked pair
    geometry of the anchors against their candidate windows, and the
    cores each sweep writes for the later ones (the kernel's output and
    scratch buffers)."""

    def __init__(self, spec: GridSpec, cores, occ, dt, scalars,
                 n_cached: int, o: dict):
        (self.rho0, self.p0, self.c_f, self.inv_sigma0,
         self.transport_coeff, self.g, self.mu, self.wf) = scalars
        (self.xC, self.yC, self.vxC, self.vyC, self.drP, self.isfC,
         self.massC, self.wvxC, self.wvyC) = cores
        self.spec, self.dt, self.n_cached, self.o = spec, dt, n_cached, o
        xC = self.xC
        self.vis = _visited(spec, occ, xC.shape[0] - 2)
        self.zero = torch.zeros((), dtype=xC.dtype, device=xC.device)
        self.af = _anc(self.isfC)
        self.massa = _anc(self.massC)
        self.mass_safe = torch.where(self.massa > 0, self.massa, 1.0)
        self.fl = self.af > 0
        (self.r, self.ex, self.ey, self.w, self.dw, self.m1,
         self.mw) = _geometry(spec, _pair(_anc(xC)), _pair(_anc(self.yC)),
                              _win(spec, xC), _win(spec, self.yC),
                              _win(spec, self.isfC))

    def keep(self, v):   # zero the never-visited anchor ranks
        return torch.where(self.vis, v, self.zero)

    def halo(self, v):   # _flush of a halo'd output: wrapped x columns
        return halo_ify(self.spec, self.keep(v))

    def dwv(self):
        """(dw*Vol_j*m1, dw*Vol_j*mw) of sweeps 2-3."""
        dwv = self.dw * _win(self.spec, self.o["volH"])
        return dwv * self.m1, dwv * self.mw


def _sweep0_plain(s: _Sweep):
    """Sweep 0: density (sph_physics_mex.c:178-234)."""
    spec, o = s.spec, s.o
    rho0, inv_sigma0 = s.rho0, s.inv_sigma0
    w, m1, mw, fl = s.w, s.m1, s.mw, s.fl
    massv = _win(spec, s.massC)
    sig_inner = w0(spec.h) + torch.sum(w * m1, dim=2)
    sig_contact = torch.sum(w * (massv * (1.0 / rho0)) * mw, dim=2)
    rho = (sig_inner * rho0 * inv_sigma0
           + sig_contact * rho0 * rho0 * inv_sigma0 / s.mass_safe)
    rho = torch.where(rho <= 1e-12, rho0, rho)
    rho = torch.where(fl, rho, rho0)   # walls keep rho0
    vol = s.mass_safe / rho
    rk = rho + 0.5 * s.dt * s.drP      # stage-1 half-kick + EOS (c:857-865)
    rho_half = torch.where(fl, torch.where(rk < 1e-10, rho0, rk), rho)
    p_half = torch.where(fl, s.p0 * (rho_half / rho0 - 1.0), s.zero)
    # reference pair-count convention (fluid-rooted, store-once)
    o["cnt"] = s.keep(s.af * (0.5 * torch.sum(m1, dim=2)
                              + torch.sum(mw, dim=2)))
    o["volH"], o["rhohH"], o["phH"] = (s.halo(vol), s.halo(rho_half),
                                       s.halo(p_half))


def _sweep1_plain(s: _Sweep):
    """Sweep 1: kernel gradient correction (c:239-365)."""
    spec, o = s.spec, s.o
    r, dw, m1, mw, ex, ey, fl = s.r, s.dw, s.m1, s.mw, s.ex, s.ey, s.fl
    n_cached = s.n_cached
    volv = _win(spec, o["volH"])
    rf = r * dw * volv * (m1 + mw)
    if n_cached > 0:
        # the cache holds dw*m1 and dw*mw and sweeps 1-3 multiply them by
        # Vol_j; sweeps 2-3 get (dw*m1)*Vol_j and (dw*mw)*Vol_j, which equal
        # (dw*Vol_j)*m1 and (dw*Vol_j)*mw bit for bit (m1, mw are exactly 0
        # or 1), so only rf associates differently
        rf_c = r * ((dw * m1) * volv + (dw * mw) * volv)
        cached = (torch.arange(spec.K, device=rf.device)
                  < n_cached).reshape(1, spec.K, 1, 1)
        rf = torch.where(cached, rf_c, rf)
    a11 = -torch.sum(rf * ex * ex, dim=2)
    a12 = -torch.sum(rf * ex * ey, dim=2)
    a22 = -torch.sum(rf * ey * ey, dim=2)
    a21 = a12
    ata11 = a11 * a11 + a21 * a21 + 1e-8
    ata12 = a11 * a12 + a21 * a22
    ata22 = a12 * a12 + a22 * a22 + 1e-8
    det_m = ata11 * ata22 - ata12 * ata12
    degen = torch.abs(det_m) < 1e-20
    det_safe = torch.where(degen, 1.0, det_m)
    im11 = ata22 / det_safe
    im12 = -ata12 / det_safe
    im22 = ata11 / det_safe
    p11 = torch.where(degen, 1.0, im11 * a11 + im12 * a12)
    p12 = torch.where(degen, 0.0, im11 * a21 + im12 * a22)
    p21 = torch.where(degen, 0.0, im12 * a11 + im22 * a12)
    p22 = torch.where(degen, 1.0, im12 * a21 + im22 * a22)
    det_a = a11 * a22 - a12 * a21
    det_sqr = torch.clamp(1.0 - det_a, min=0.0)
    denom = det_a + det_sqr
    small = torch.abs(denom) < 1e-12
    denom_safe = torch.where(small, 1.0, denom)
    w1 = torch.where(small, 0.0, det_a / denom_safe)
    w2 = torch.where(small, 1.0, det_sqr / denom_safe)
    o["b11H"] = s.halo(torch.where(fl, w1 * p11 + w2, 1.0))
    o["b12H"] = s.halo(torch.where(fl, w1 * p12, 0.0))
    o["b21H"] = s.halo(torch.where(fl, w1 * p21, 0.0))
    o["b22H"] = s.halo(torch.where(fl, w1 * p22 + w2, 1.0))


def _sweep2_plain(s: _Sweep):
    """Sweep 2: viscous + shifting + Riemann pressure + kick (c:466-545,
    :633-709, :867-957, :1388-1409)."""
    spec, o = s.spec, s.o
    h, g, mu, wf, dt, zero = spec.h, s.g, s.mu, s.wf, s.dt, s.zero
    c_f, transport_coeff = s.c_f, s.transport_coeff
    r, ex, ey, fl, af = s.r, s.ex, s.ey, s.fl, s.af
    massa, mass_safe = s.massa, s.mass_safe
    vxC, vyC = s.vxC, s.vyC
    dwv1, dwvw = s.dwv()
    vola = _anc(o["volH"])
    vxa, vxv = _pair(_anc(vxC)), _win(spec, vxC)
    vya, vyv = _pair(_anc(vyC)), _win(spec, vyC)
    b11a, b11v = _pair(_anc(o["b11H"])), _win(spec, o["b11H"])
    b12a, b12v = _pair(_anc(o["b12H"])), _win(spec, o["b12H"])
    b21a, b21v = _pair(_anc(o["b21H"])), _win(spec, o["b21H"])
    b22a, b22v = _pair(_anc(o["b22H"])), _win(spec, o["b22H"])
    rhoha, rhohv = _pair(_anc(o["rhohH"])), _win(spec, o["rhohH"])
    pha, phv = _pair(_anc(o["phH"])), _win(spec, o["phH"])
    wvxv, wvyv = _win(spec, s.wvxC), _win(spec, s.wvyC)
    inv_denom = 1.0 / (r + 0.01 * h)
    tx_f = (b11a + b11v) * ex + (b12a + b12v) * ey
    ty_f = (b21a + b21v) * ex + (b22a + b22v) * ey
    tx_w = b11a * ex + b12a * ey
    ty_w = b21a * ex + b22a * ey
    ebe_f = ex * tx_f + ey * ty_f
    ebe_w = ex * tx_w + ey * ty_w
    cf_p = ebe_f * mu * inv_denom * dwv1
    cw_p = wf * ebe_w * mu * inv_denom * dwvw
    acc_x = torch.sum(cf_p * (vxa - vxv) + cw_p * (vxa - wvxv), dim=2)
    acc_y = torch.sum(cf_p * (vya - vyv) + cw_p * (vya - wvyv), dim=2)
    fpx = torch.where(fl, acc_x * vola + massa * g, zero)
    fpy = torch.where(fl, acc_y * vola, zero)
    inc_x = torch.sum(-dwv1 * tx_f - 2.0 * dwvw * tx_w, dim=2)
    inc_y = torch.sum(-dwv1 * ty_f - 2.0 * dwvw * ty_w, dim=2)
    limiter = torch.clamp(
        100.0 * (inc_x * inc_x + inc_y * inc_y) / (h * h), 0.0, 1.0)
    shift = transport_coeff * h * h * limiter * af
    rho_bar = 0.5 * (rhoha + rhohv)
    un_l = vxa * ex + vya * ey
    un_r = vxv * ex + vyv * ey
    beta = torch.clamp(3.0 * torch.clamp(un_l - un_r, min=0.0), max=c_f)
    p_avg = 0.5 * (pha + phv)
    p_star = p_avg + 0.5 * beta * rho_bar * (un_l - un_r)
    p_face = 0.5 * (p_avg + p_star)
    ax_prior = _pair(fpx / mass_safe)
    ay_prior = _pair(fpy / mass_safe)
    face_acc = -(ax_prior * ex + ay_prior * ey)
    p_wall = pha + rhoha * r * torch.clamp(face_acc, min=0.0)
    pacc_x = -torch.sum(p_face * tx_f * dwv1 + (pha + p_wall) * tx_w * dwvw,
                        dim=2)
    pacc_y = -torch.sum(p_face * ty_f * dwv1 + (pha + p_wall) * ty_w * dwvw,
                        dim=2)
    fx = torch.where(fl, pacc_x * vola, zero)
    fy = torch.where(fl, pacc_y * vola, zero)
    inv_m = 1.0 / mass_safe
    vx2 = torch.where(fl, _anc(vxC) + (fpx + fx) * inv_m * dt, zero)
    vy2 = torch.where(fl, _anc(vyC) + (fpy + fy) * inv_m * dt, zero)
    o["vxH"], o["vyH"] = s.halo(vx2), s.halo(vy2)
    o["dxsP"], o["dysP"] = s.keep(shift * inc_x), s.keep(shift * inc_y)
    o["fxP"], o["fyP"] = s.keep(fx), s.keep(fy)
    o["fpxP"], o["fpyP"] = s.keep(fpx), s.keep(fpy)


def _sweep3_plain(s: _Sweep):
    """Sweep 3: continuity + finalize + positions (c:1073-1116,
    :1429-1451; SPH_Poiseuille.m:254-283 ordering)."""
    spec, o = s.spec, s.o
    rho0, dt, zero, ex, ey, fl = s.rho0, s.dt, s.zero, s.ex, s.ey, s.fl
    dwv1, dwvw = s.dwv()
    wvxv, wvyv = _win(spec, s.wvxC), _win(spec, s.wvyC)
    vx2O, vy2O = o["vxH"], o["vyH"]
    vx2a, vx2v = _pair(_anc(vx2O)), _win(spec, vx2O)
    vy2a, vy2v = _pair(_anc(vy2O)), _win(spec, vy2O)
    u_jump_f = (vx2a - vx2v) * ex + (vy2a - vy2v) * ey
    u_jump_w = 2.0 * ((vx2a - wvxv) * ex + (vy2a - wvyv) * ey)
    rate = torch.sum(u_jump_f * dwv1 + u_jump_w * dwvw, dim=2)
    rho_h = _anc(o["rhohH"])
    drho_new = torch.where(fl, rate * rho_h, zero)
    rho_new = rho_h + 0.5 * dt * drho_new
    rho_new = torch.where(rho_new < 1e-10, rho0, rho_new)
    rho_new = torch.where(fl, rho_new, rho_h)
    p_new = torch.where(fl, s.p0 * (rho_new / rho0 - 1.0), zero)
    xc, yc = _anc(s.xC), _anc(s.yC)
    x2 = xc + o["dxsP"] + 0.5 * dt * (_anc(s.vxC) + _anc(vx2O))
    y2 = yc + o["dysP"] + 0.5 * dt * (_anc(s.vyC) + _anc(vy2O))
    o["xP"] = torch.where(s.vis & fl, x2, xc)  # walls, empty and skipped
    o["yP"] = torch.where(s.vis & fl, y2, yc)  # slots keep their positions
    o["rhoP"], o["pP"], o["drP"] = (s.keep(rho_new), s.keep(p_new),
                                    s.keep(drho_new))


_SWEEPS = (_sweep0_plain, _sweep1_plain, _sweep2_plain, _sweep3_plain)

# The cores each sweep writes: its outputs (the _flush calls under
# @_when(sweep == s) of the JAX _kernel_body, fused_cell.py:717,
# :813-816, :958-963, :1074-1078) and the scratch cores it leaves for the
# later sweeps (rho and p at the half step, the shift).
SWEEP_WRITES = (("volH", "cnt", "rhohH", "phH"),
                ("b11H", "b12H", "b21H", "b22H"),
                ("vxH", "vyH", "fxP", "fyP", "fpxP", "fpyP", "dxsP", "dysP"),
                ("rhoP", "pP", "drP", "xP", "yP"))
SCRATCH = ("rhohH", "phH", "dxsP", "dysP")


def _sweeps_plain(spec: GridSpec, cores, occ, dt, scalars, n_cached: int,
                  first: int, count: int, prior=None):
    """Sweeps ``first .. first+count-1`` of one fused step. The cores the
    range does not write come from ``prior`` (the buffers of an earlier
    step) or are zero, as the kernel's zeroed buffers hold them, and the
    range reads them. ``cnt`` is per slot (nyp, K, nx) where the range
    writes it."""
    o = {} if prior is None else dict(prior)
    for i, ks in enumerate(SWEEP_WRITES):
        for k in ks:
            if k not in o and not first <= i < first + count:
                o[k] = zero_core(spec, k, cores[0], cores[4])
    s = _Sweep(spec, cores, occ, dt, scalars, n_cached, o)
    for i in range(first, first + count):
        _SWEEPS[i](s)
    return o


def zero_core(spec: GridSpec, key: str, xH, drP):
    """A zero output core named ``key``: halo'd (suffix H) like ``xH``,
    plain (suffix P) like ``drP``, or the (n_groups, L) pair count."""
    R, L, n_groups, nyp = plan(spec)
    return torch.zeros((n_groups, L) if key == "cnt"
                       else (xH if key.endswith("H") else drP).shape,
                       dtype=xH.dtype, device=xH.device)


def _step_plain(spec: GridSpec, cores, occ, dt, scalars, n_cached: int = 0):
    """One fused step on cores (the four sweeps of the JAX _kernel_body,
    fused_cell.py:604-1078). ``cores``: x y vx vy (halo'd), dr (plain),
    isf mass wvx wvy (halo'd). ``dt``/``g``/``mu``/``wf``: 0-dim tensors.
    Anchor ranks k < ``n_cached`` take the geometry-cache expressions
    (:743-762). Returns a dict of output cores with ``cnt`` per slot
    (nyp, K, nx)."""
    o = _sweeps_plain(spec, cores, occ, dt, scalars, n_cached, 0, 4)
    return {k: v for k, v in o.items() if k not in SCRATCH}


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _cnt_rows(spec: GridSpec, cnt_slot):
    """Per-slot pair counts -> the JAX package's (n_groups, L) per-lane
    rows (a sum over slot ranks)."""
    R, L, n_groups, nyp = plan(spec)
    return torch.sum(cnt_slot, dim=1).reshape(n_groups, L)


def _check_device(t: torch.Tensor):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused kernels take cpu or cuda tensors, got "
                         f"{t.device}")


def fused_step_cores_plain(spec: GridSpec, lay: FusedLayout, xH, yH, vxH,
                           vyH, drP, dt, rho0: float, p0: float, c_f: float,
                           inv_sigma0: float, transport_coeff: float, g, mu,
                           wall_visc_factor: float = 4.0):
    """Plain PyTorch twin of the fused step kernel (any device), in the
    form ``step_form`` resolves."""
    cores = [xH, yH, vxH, vyH, drP,
             lay.isf_c, lay.mass_c, lay.wvx_c, lay.wvy_c]
    scal = (rho0, p0, c_f, inv_sigma0, transport_coeff,
            _scalar(g, xH), _scalar(mu, xH), _scalar(wall_visc_factor, xH))
    o = _step_plain(spec, cores, lay.occ, _scalar(dt, xH), scal,
                    _cached_ranks(*step_form(spec, xH.dtype)))
    o["cnt"] = _cnt_rows(spec, o["cnt"])
    return o


def fused_step_cores(spec: GridSpec, lay: FusedLayout, xH, yH, vxH, vyH,
                     drP, dt, rho0: float, p0: float, c_f: float,
                     inv_sigma0: float, transport_coeff: float, g, mu,
                     wall_visc_factor: float = 4.0, cache_slots: int = 0):
    """Core-level fused step (JAX ``fused_step_cores``): halo'd
    position/velocity cores + plain drho_dt core in; a dict of output
    cores (suffix H = halo'd, P = plain) + ``cnt`` (n_groups, L) out.
    CUDA tensors launch the hand-written kernel of the form ``step_form``
    resolves, CPU tensors run the plain twin. ``cache_slots``: the anchor
    slots the cache kernels pick their lanes per anchor for (0: the
    spec's; ``fused_cell_cuda._const``)."""
    _check_device(xH)
    if not xH.is_cuda:
        return fused_step_cores_plain(
            spec, lay, xH, yH, vxH, vyH, drP, dt, rho0, p0, c_f,
            inv_sigma0, transport_coeff, g, mu, wall_visc_factor)
    o = fused_cell_cuda.step(
        spec, plan(spec)[0], lay, xH, yH, vxH, vyH, drP, dt,
        (rho0, p0, c_f, inv_sigma0, transport_coeff, g, mu,
         wall_visc_factor), *step_form(spec, xH.dtype),
        cache_slots=cache_slots)
    o["cnt"] = _cnt_rows(spec, o["cnt"])
    return o


def fused_cell_step(spec: GridSpec, lay: FusedLayout, x, y, vx, vy,
                    drho_dt, dt, rho0: float, p0: float, c_f: float,
                    inv_sigma0: float, transport_coeff: float, g, mu,
                    wall_visc_factor: float = 4.0):
    """Per-particle wrapper of ``fused_step_cores`` (scatter -> kernel ->
    collect). Returns the per-particle dict of the JAX package's
    ``fused_cell_step`` plus ``n_pairs`` (a 0-dim int32 tensor)."""
    xH = make_core(spec, lay.pidx, x, fill=_BIG_X, xshift=spec.DL)
    yH, vxH, vyH = (make_core(spec, lay.pidx, v) for v in (y, vx, vy))
    drP = make_plain(spec, lay.pidx, drho_dt)
    o = fused_step_cores(
        spec, lay, xH, yH, vxH, vyH, drP, dt, rho0, p0, c_f, inv_sigma0,
        transport_coeff, g, mu, wall_visc_factor)
    n_pairs = torch.round(torch.sum(o["cnt"])).to(torch.int32)
    return dict(rho=take_p(lay, o["rhoP"]), p=take_p(lay, o["pP"]),
                drho_dt=take_p(lay, o["drP"]),
                vx=take_h(lay, o["vxH"]), vy=take_h(lay, o["vyH"]),
                fx=take_p(lay, o["fxP"]), fy=take_p(lay, o["fyP"]),
                fpx=take_p(lay, o["fpxP"]), fpy=take_p(lay, o["fpyP"]),
                vol=take_h(lay, o["volH"]), b11=take_h(lay, o["b11H"]),
                b12=take_h(lay, o["b12H"]), b21=take_h(lay, o["b21H"]),
                b22=take_h(lay, o["b22H"]),
                x=take_p(lay, o["xP"]), y=take_p(lay, o["yP"]),
                n_pairs=n_pairs)


# ---------------------------------------------------------------------------
# the multi-step chunk
# ---------------------------------------------------------------------------

_AUX = ("volH", "b11H", "b12H", "b21H", "b22H", "rhoP", "pP", "fxP", "fyP",
        "fpxP", "fpyP")


def _refresh(core_h, plain, xshift: float = 0.0):
    """Write a plain core back into a halo'd working core: center plus
    (nx >= 3) the translated x-halo columns; the y-halo rows are kept
    (JAX _chunk_kernel, fused_cell.py:1680-1689)."""
    out = core_h.clone()
    nx = plain.shape[2]
    out[1:-1, :, 1:-1] = plain
    if nx >= 3:
        out[1:-1, :, 0:1] = plain[:, :, nx - 1:nx] - xshift
        out[1:-1, :, nx + 1:nx + 2] = plain[:, :, 0:1] + xshift
    return out


def chunk_dt_limits(spec: GridSpec, rho0: float, g, mu, like: torch.Tensor):
    """The step-independent dt limits (viscous, body force) exactly as
    the JAX chunk kernel rounds them (fused_cell.py:1596-1598)."""
    nu = _scalar(mu, like) / rho0
    tiny = _scalar(1e-12, like)
    h = spec.h
    dt_visc = _scalar(0.125 * h * h, like) / torch.maximum(nu, tiny)
    dt_body = 0.25 * torch.sqrt(
        _scalar(h, like) / torch.maximum(torch.abs(_scalar(g, like)), tiny))
    return dt_visc, dt_body


def _chunk_result(xHs, yHs, vxHs, vyHs, drPs, o, spec):
    st = dict(xH=xHs, yH=yHs, vxH=vxHs, vyH=vyHs, drP=drPs,
              xP=o["xP"], yP=o["yP"])
    aux = {k: o[k] for k in _AUX}
    aux["drP"] = o["drP"]
    aux["cnt"] = _cnt_rows(spec, o["cnt"])
    return st, aux


def fused_chunk_call_plain(spec: GridSpec, lay: FusedLayout, xH, yH, vxH,
                           vyH, drP, t_local, t_comp, interval_len, n_sub,
                           rho0: float, p0: float, c_f: float,
                           inv_sigma0: float, transport_coeff: float, g, mu,
                           wall_visc_factor: float = 4.0):
    """Plain PyTorch twin of the chunk kernel (any device; one host sync
    per step for the loop condition), in the form ``chunk_form``
    resolves."""
    *work, o, steps, t, tc = _chunk_plain(
        spec, lay, xH, yH, vxH, vyH, drP, t_local, t_comp, interval_len,
        n_sub, rho0, p0, c_f, inv_sigma0, transport_coeff, g, mu,
        wall_visc_factor)
    st, aux = _chunk_result(*work, o, spec)
    return st, aux, steps, t, tc


def _chunk_plain(spec: GridSpec, lay: FusedLayout, xH, yH, vxH, vyH, drP,
                 t_local, t_comp, interval_len, n_sub, rho0: float, p0: float,
                 c_f: float, inv_sigma0: float, transport_coeff: float, g, mu,
                 wall_visc_factor: float):
    """``fused_chunk_call_plain``'s loop: (xH, yH, vxH, vyH, drP working
    state, the last step's outputs with ``cnt`` per slot (zeros where no
    step ran), steps, t, t_comp)."""
    like = xH
    n_cached = _cached_ranks(*chunk_form(spec, xH.dtype))
    h = spec.h
    t = _scalar(t_local, like)
    tc = _scalar(t_comp, like)
    interval = _scalar(interval_len, like)
    tiny = _scalar(1e-12, like)
    dt_visc, dt_body = chunk_dt_limits(spec, rho0, g, mu, like)
    scal = (rho0, p0, c_f, inv_sigma0, transport_coeff,
            _scalar(g, like), _scalar(mu, like),
            _scalar(wall_visc_factor, like))
    # the working state starts as copies: the inputs stay intact for the
    # caller's rollback
    xHs, yHs, vxHs, vyHs, drPs = (a.clone() for a in (xH, yH, vxH, vyH, drP))
    o = None
    steps = 0
    while steps < int(n_sub) and bool(t < interval):
        # the kick writes 0 to every wall and empty slot, so the max over
        # the whole core is the fluid max
        v_max = torch.sqrt(torch.max(vxHs * vxHs + vyHs * vyHs))
        remain = interval - t
        dt_ac = _scalar(0.25 * h, like) / torch.maximum(c_f + v_max, tiny)
        dt = torch.maximum(torch.minimum(torch.minimum(dt_ac, dt_visc),
                                         torch.minimum(dt_body, remain)),
                           tiny)
        o = _step_plain(spec, [xHs, yHs, vxHs, vyHs, drPs, lay.isf_c,
                               lay.mass_c, lay.wvx_c, lay.wvy_c],
                        lay.occ, dt, scal, n_cached)
        # Kahan-compensated interval clock (stepper._t_add)
        yk = dt - tc
        t2 = t + yk
        tc = (t2 - t) - yk
        t = t2
        # positions stay UNWRAPPED inside a chunk
        xHs = _refresh(xHs, o["xP"], spec.DL if spec.nx >= 3 else 0.0)
        yHs = _refresh(yHs, o["yP"])
        vxHs, vyHs, drPs = o["vxH"], o["vyH"], o["drP"]
        steps += 1
    if o is None:
        z = torch.zeros_like(drP)
        zh = torch.zeros_like(xH)
        o = dict({k: (zh if k.endswith("H") else z) for k in _AUX},
                 drP=z, xP=z, yP=z, cnt=z)
    return (xHs, yHs, vxHs, vyHs, drPs, o,
            torch.tensor(steps, dtype=torch.int32, device=like.device), t,
            tc)


def fused_chunk_call(spec: GridSpec, lay: FusedLayout, xH, yH, vxH, vyH,
                     drP, t_local, t_comp, interval_len, n_sub,
                     rho0: float, p0: float, c_f: float, inv_sigma0: float,
                     transport_coeff: float, g, mu,
                     wall_visc_factor: float = 4.0, cache_slots: int = 0):
    """Run up to ``n_sub`` steps in one call (JAX ``fused_chunk_call``).
    Returns (state_cores_dict, aux_outs_dict, steps_done, t_new,
    t_comp_new), the last three as 0-dim tensors on the input's device.
    Candidate validity is NOT checked inside: the caller runs
    ``pair_drift_bounds`` on the returned position cores. The inputs are
    left intact. CUDA tensors launch the hand-written kernels (no host
    sync inside the chunk) in the form ``chunk_form`` resolves, CPU
    tensors run the plain twin. ``cache_slots``: as in
    ``fused_step_cores``."""
    _check_device(xH)
    if not xH.is_cuda:
        return fused_chunk_call_plain(
            spec, lay, xH, yH, vxH, vyH, drP, t_local, t_comp, interval_len,
            n_sub, rho0, p0, c_f, inv_sigma0, transport_coeff, g, mu,
            wall_visc_factor)
    # the clock buffer is assembled on the host and crosses in one copy
    host = torch.empty((), dtype=xH.dtype)
    dt_visc, dt_body = chunk_dt_limits(spec, rho0, float(g), float(mu), host)
    work, o, steps, t, tc, _ = fused_cell_cuda.chunk(
        spec, plan(spec)[0], lay, xH, yH, vxH, vyH, drP, t_local, t_comp,
        interval_len, n_sub, dt_visc, dt_body,
        (rho0, p0, c_f, inv_sigma0, transport_coeff, g, mu,
         wall_visc_factor), *chunk_form(spec, xH.dtype),
        cache_slots=cache_slots)
    st, aux = _chunk_result(*work, o, spec)
    return st, aux, steps, t, tc


class DriftRef(NamedTuple):
    """What a group's drift bounds compare the chunk's final positions
    with: the rebuild's plain position cores (rows, K, nx), the fluid mask
    (``isf``: the halo'd core of those rows where ``isf_halo``, else
    plain) and the chunk's plain row that their first row is (``row0``:
    a y-slab's ghost rows come first)."""

    refx: torch.Tensor
    refy: torch.Tensor
    isf: torch.Tensor
    isf_halo: bool = True
    row0: int = 0

    def bounds(self, nx: int, x2P, y2P):
        """(bx, by) in plain torch: ``pair_drift_bounds`` over these
        rows."""
        rows = self.refx.shape[0]
        isf = self.isf[1:rows + 1, :, 1:nx + 1] if self.isf_halo else self.isf
        r = slice(self.row0, self.row0 + rows)
        mx, mn = drift_row_ranges(isf > 0, self.refx, self.refy, x2P[r],
                                  y2P[r])
        return drift_window_bounds(mx, mn, nx)


class ChunkRunner:
    """The chunk path on persistent buffers, which the fused engine's
    sub-chunk groups take: one ``fused_cell_cuda.ChunkBuffers`` per key
    (halo'd and plain core shapes, form and cached ranks, device, dtype),
    built on first use and reused by every later group, interval and
    lane; and the dt limits per (rho0, g, mu)."""

    def __init__(self):
        self._bufs = {}
        self._dt = {}

    def group(self, spec: GridSpec, lay: FusedLayout, carry, interval_len,
              scalars, drift: DriftRef = None, cache_slots: int = 0,
              lay_key=None):
        """A sub-chunk group's runner over ``lay`` from ``carry`` (the
        chunk state: xH, yH, vxH, vyH, drP and the aux cores) on the
        buffers of its cores' key. ``scalars``: (rho0, p0, c_f,
        inv_sigma0, transport_coeff, g, mu, wall_visc_factor);
        ``drift``: the bounds' references, None for none (bounds 0);
        ``lay_key``: names ``lay`` and ``drift`` where they are a
        persistent layout set's (``BufferedRebuild``), whose tensors
        never change, so the buffers bind them once (None: bind them
        anew)."""
        xH, drP = carry["xH"], carry["drP"]
        _check_device(xH)
        form, k_cut = chunk_form(spec, xH.dtype)
        key = (tuple(xH.shape), tuple(drP.shape), form,
               _cached_ranks(form, k_cut), xH.device, xH.dtype)
        bufs = self._bufs.get(key)
        if bufs is None:
            bufs = self._bufs[key] = fused_cell_cuda.ChunkBuffers(
                spec, plan(spec)[0], form, k_cut, xH.shape, drP.shape,
                xH.dtype, xH.device)
        dt = None
        if xH.is_cuda:
            # the step-independent dt limits, rounded as fused_chunk_call
            # rounds them
            key = (spec, scalars[0], float(scalars[5]), float(scalars[6]))
            dt = self._dt.get(key)
            if dt is None:
                host = torch.empty((), dtype=xH.dtype)
                dt = self._dt[key] = tuple(
                    float(v) for v in chunk_dt_limits(*key, host))
        return BufferedChunkRun(bufs, spec, lay, carry, interval_len,
                                scalars, drift, cache_slots, dt, lay_key)


class BufferedChunkRun:
    """A sub-chunk group's runner (the one protocol of
    ``stepper.PallasCellEngine._run_group``) on a key's buffers
    (``ChunkRunner.group``): a call runs up to n_sub steps from the kept
    state into the scratch set and returns on the host (bx, by, t,
    t_comp, steps, host syncs: 1), ``keep`` swaps the sets (a rollback
    swaps nothing), ``state`` returns the kept state, ``cnt`` per slot
    (nyp, K, nx). The kept set holds what the last kept call wrote until
    the next keep, so a group that ends on a rollback, and the next
    group's carry, read the aux cores of the last kept call. On the card
    a call is one ``sph_chunk_run`` and one synchronize, the drift bounds
    taken there beside the chunk; on the CPU the plain twins
    (``fused_chunk_call_plain``'s loop, ``DriftRef.bounds``) fill the
    scratch set and one ``tolist`` reads what the card's record holds.
    Each call is ``fused_chunk_call`` and ``pair_drift_bounds`` from the
    state it began in, bit for bit."""

    def __init__(self, bufs, spec, lay, carry, interval_len, scalars,
                 drift, cache_slots, dt_limits, lay_key=None):
        self.cur, self.new = carry, None
        self.bufs, self.spec, self.lay = bufs, spec, lay
        self.interval, self.scalars, self.drift = interval_len, scalars, drift
        self._card = bufs.cores[0]["x"].is_cuda
        if self._card:
            bufs.bind(lay, lay_key)
            self._c = bufs.const(spec, scalars[:5], cache_slots)
            self._clock = (interval_len, *dt_limits)
            self._dyn = tuple(float(v) for v in scalars[5:8])
            self._drift = (None if drift is None
                           else bufs.drift(*drift, key=lay_key))

    def __call__(self, n_sub: int, t_i, tc_i):
        fused_cell_cuda.CHUNK_BUFFERS["runs"] += 1
        b = self.bufs
        inputs = [self.cur[k] for k in ("xH", "yH", "vxH", "vyH", "drP")]
        if self._card:
            got = b.launch(self._c, inputs, (t_i, tc_i) + self._clock,
                           self._dyn, n_sub, self._drift)
        else:
            got = self._run_plain(inputs, t_i, tc_i, n_sub)
        self.new = b.state(b.scratch)
        return (*got, 1)

    def _run_plain(self, inputs, t_i, tc_i, n_sub):
        b = self.bufs
        *work, o, steps, t, tc = _chunk_plain(
            self.spec, self.lay, *inputs, t_i, tc_i, self.interval, n_sub,
            *self.scalars)
        s = b.scratch
        b.zero_outputs(s)
        for n, v in zip(("x", "y", "vx", "vy", "dr"), work):
            b.cores[s][n].copy_(v)
        st = b.state(s)
        for k in _AUX + ("drP", "xP", "yP", "cnt"):
            st[k].copy_(o[k])
        if self.drift is None:
            bx = by = torch.zeros((), dtype=t.dtype, device=t.device)
        else:
            bx, by = self.drift.bounds(self.spec.nx, st["xP"], st["yP"])
        vals = torch.stack([bx, by, t, tc, steps.to(t.dtype)]).tolist()
        return (*vals[:4], int(vals[4]))

    def keep(self) -> None:
        self.bufs.keep()
        self.cur = self.new

    def state(self) -> dict:
        return self.cur


class RebuildRunner:
    """The interval loop's rebuild on persistent layout sets, which the
    fused engine's groups take beside the chunk path's buffers: one
    ``fused_cell_cuda.RebuildBuffers`` per key (halo'd and plain core
    shapes, particles, device, dtype), built on first use and reused by
    every later group, interval and lane."""

    def __init__(self):
        self._bufs = {}

    def interval(self, spec: GridSpec, carry, statics, shear, plain):
        """An interval's rebuilds on the sets of ``carry``'s key (its xH
        and drP). ``statics``: the (6, n) ``layout_statics``; ``shear``:
        the layouts' (shear_rows, shear_tbt); ``plain(lay, st)``: the
        plain twin (the engine's ``_do_rebuild``)."""
        xH, drP = carry["xH"], carry["drP"]
        _check_device(xH)
        key = (tuple(xH.shape), tuple(drP.shape), spec.n_total, xH.device,
               xH.dtype)
        bufs = self._bufs.get(key)
        if bufs is None:
            bufs = self._bufs[key] = fused_cell_cuda.RebuildBuffers(
                spec, plan(spec)[0], xH.shape, drP.shape, xH.dtype,
                xH.device)
        return BufferedRebuild(bufs, statics, shear, plain)


_SET_LAYOUT = (("pidx", "pidx"), ("hidx", "hidx"), ("isf_c", "isf"),
               ("mass_c", "mass"), ("wvx_c", "wvx"), ("wvy_c", "wvy"),
               ("wbot_c", "wbot"), ("wtop_c", "wtop"), ("refx_p", "refx"),
               ("refy_p", "refy"), ("occ", "occ"), ("overflow", "ovf"))
_SET_CARRY = ("xH", "yH", "vxH", "vyH", "drP")


class BufferedRebuild:
    """An interval's rebuilds (``RebuildRunner.interval``): a call
    rebuilds the layout from the old one and the group's kept state into
    the set that the group did not read, and returns the set's layout, its
    carry (the next group's xH, yH, vxH, vyH, drP) and its key for
    ``ChunkRunner.group``. The two sets take turns, so the last group's
    layout, which the interval's end reads, and the new one stay intact.
    ``totals`` gives the last kept pair count and the interval's overflow,
    ``detach`` a copy of a set's layout: nothing handed to the caller
    aliases a set. On the card a call is one ``sph_rebuild``, enqueued;
    on the CPU the plain twin fills the set. Bit for bit, a call's layout
    and carry are the plain twin's, its pair count is the sum of the kept
    state's per-slot ``cnt`` (0 where nothing was kept) and its
    overflow the OR of its layout's flag and every earlier call's."""

    def __init__(self, bufs, statics, shear, plain):
        self.bufs, self.statics, self.plain = bufs, statics, plain
        self.first = True
        rows, tbt = shear
        self.layouts = [FusedLayout(**{f: c[k] for f, k in _SET_LAYOUT},
                                    shear_rows=rows, shear_tbt=tbt)
                        for c in bufs.cores]
        self.carries = [{k: c[k] for k in _SET_CARRY} for c in bufs.cores]

    def __call__(self, lay: FusedLayout, st, kept: bool):
        """Rebuild from ``lay`` and ``st``: the kept chunk state (a
        buffer set's, ``cnt`` per slot) where ``kept``, else the group's
        carry."""
        b = self.bufs
        i = b.next_set()
        fused_cell_cuda.REBUILD_BUFFERS["runs"] += 1
        if b.card:
            pos = ("xP", "yP") if kept else ("xH", "yH")
            b.launch(i, lay.pidx, lay.hidx, st[pos[0]], st[pos[1]], st["drP"],
                     st["vxH"], st["vyH"], st["cnt"] if kept else None,
                     self.statics, not kept, self.first)
        else:
            self._run_plain(i, lay, st, kept)
        self.first = False
        return self.layouts[i], self.carries[i], (b, i)

    def _run_plain(self, i, lay, st, kept):
        if not kept:
            st = dict(st, xP=st["xH"][1:-1, :, 1:-1],
                      yP=st["yH"][1:-1, :, 1:-1])
        nl, carry = self.plain(lay, st)
        out = self.bufs.cores[i]
        for f, k in _SET_LAYOUT:
            out[k].copy_(getattr(nl, f))
        for k in _SET_CARRY:
            out[k].copy_(carry[k])
        b = self.bufs
        b.pairs2.copy_(2 * torch.sum(st["cnt"]) if kept else 0)
        b.overflow_any.copy_(nl.overflow if self.first else
                             torch.logical_or(b.overflow_any != 0,
                                              nl.overflow))

    def totals(self, overflow):
        """(the last rebuild's kept pair count, ``overflow`` or any
        rebuild's overflow): new tensors, after at least one call."""
        b = self.bufs
        return (torch.round(b.pairs2.double() * 0.5).to(torch.int32),
                torch.logical_or(overflow, b.overflow_any != 0))

    def detach(self, lay: FusedLayout) -> FusedLayout:
        """``lay``, or where it is a set's layout a copy of it (one copy
        of the set's allocation)."""
        for i, own in enumerate(self.layouts):
            if lay is own:
                c = self.bufs.views(self.bufs.mem[i].clone())
                return lay._replace(**{f: c[k] for f, k in _SET_LAYOUT})
        return lay


# ---------------------------------------------------------------------------
# wall-shear monitor
# ---------------------------------------------------------------------------


def _shear_plain(spec: GridSpec, lay: FusedLayout, xH, yH, vxH, volH, b11H,
                 b12H, b21H, b22H, mu, wf, rows=None):
    """Per-slot (bottom, top) wall-shear partials (JAX _shear_kernel,
    fused_cell.py:1928-1979). ``rows``: compute only these anchor rows (a
    1-D index tensor) and leave +0 in the others, as the kernel does."""
    h = spec.h
    nyp = xH.shape[0] - 2
    vis = _visited(spec, lay.occ, nyp)
    zero = torch.zeros((), dtype=xH.dtype, device=xH.device)

    def anc(core):
        a = _pair(_anc(core))
        return a if rows is None else a[rows]

    def win(core):
        w = _win(spec, core)
        return w if rows is None else w[rows]

    r, ex, ey, _, dw, m1, mw = _geometry(
        spec, anc(xH), anc(yH), win(xH), win(yH), win(lay.isf_c),
        need_w=False)
    b11a, b12a, b21a, b22a = anc(b11H), anc(b12H), anc(b21H), anc(b22H)
    ebe = ex * (b11a * ex + b12a * ey) + ey * (b21a * ex + b22a * ey)
    f_pair = (wf * mu * ebe * dw * win(volH)
              * (anc(vxH) - win(lay.wvx_c))
              / (r + 0.01 * h) * anc(volH)) * mw
    tb = torch.sum(f_pair * win(lay.wbot_c), dim=2)
    tt = torch.sum(f_pair * win(lay.wtop_c), dim=2)
    if rows is None:
        return torch.where(vis, tb, zero), torch.where(vis, tt, zero)
    out = torch.zeros((2, nyp) + tuple(tb.shape[1:]), dtype=xH.dtype,
                      device=xH.device)
    out[0, rows] = torch.where(vis[rows], tb, zero)
    out[1, rows] = torch.where(vis[rows], tt, zero)
    return out[0], out[1]


def fused_wall_shear_slots_plain(spec: GridSpec, lay: FusedLayout, xH, yH,
                                 vxH, volH, b11H, b12H, b21H, b22H, mu,
                                 wall_visc_factor: float = 4.0,
                                 every_row: bool = False):
    """Plain PyTorch twin of the wall-shear kernel's per-slot partials
    (any device): (2, nyp, K, nx), bottom then top, computed over the
    layout's wall rows only, +0 elsewhere; ``every_row``: over every row,
    as the JAX kernel computes them (what the row list is checked
    against)."""
    rows = None if every_row else lay.shear_rows.to(torch.int64)
    tb, tt = _shear_plain(spec, lay, xH, yH, vxH, volH, b11H, b12H, b21H,
                          b22H, _scalar(mu, xH),
                          _scalar(wall_visc_factor, xH), rows=rows)
    return torch.stack([tb, tt])


def fused_wall_shear_cores_plain(spec: GridSpec, lay: FusedLayout, xH, yH,
                                 vxH, volH, b11H, b12H, b21H, b22H, mu,
                                 wall_visc_factor: float = 4.0):
    """Plain PyTorch twin of ``fused_wall_shear_cores`` (any device)."""
    tbt = fused_wall_shear_slots_plain(spec, lay, xH, yH, vxH, volH, b11H,
                                       b12H, b21H, b22H, mu,
                                       wall_visc_factor)
    return -torch.sum(tbt[0]) / spec.DL, -torch.sum(tbt[1]) / spec.DL


def fused_wall_shear_cores(spec: GridSpec, lay: FusedLayout, xH, yH, vxH,
                           volH, b11H, b12H, b21H, b22H, mu,
                           wall_visc_factor: float = 4.0):
    """Wall-shear monitor over cores in the (freshly rebuilt) layout:
    (tau_bottom, tau_top) as 0-dim tensors, tau = -sum/DL (reference
    ordering SPH_Poiseuille.m:280-283; formula
    sph_physics_mex.c:1713-1742). On CUDA the kernel's per-slot partials
    are summed with one ``torch.sum`` for both walls."""
    _check_device(xH)
    if not xH.is_cuda:
        return fused_wall_shear_cores_plain(
            spec, lay, xH, yH, vxH, volH, b11H, b12H, b21H, b22H, mu,
            wall_visc_factor)
    tbt = fused_cell_cuda.wall_shear(
        spec, plan(spec)[0], lay, xH, yH, vxH, volH, b11H, b12H, b21H,
        b22H, mu, wall_visc_factor)
    return (torch.sum(tbt.view(2, -1), dim=1) / (-spec.DL)).unbind()


def fused_wall_shear(spec: GridSpec, lay: FusedLayout, x, y, vx, vol,
                     b11, b12, b21, b22, mu, wall_visc_factor: float = 4.0):
    """Per-particle wrapper of ``fused_wall_shear_cores``: x gets its own
    core (fill 1e9, translated halo columns); the other seven fields ride
    one packed scatter and one batched halo."""
    xH = make_core(spec, lay.pidx, x, fill=_BIG_X, xshift=spec.DL)
    yH, volH, vxH, b11H, b12H, b21H, b22H = halo_ify_many(
        spec, _packed_cores(spec, lay.pidx, (y, vol, vx, b11, b12, b21, b22),
                            (0.0,) * 7))
    return fused_wall_shear_cores(
        spec, lay, xH, yH, vxH, volH, b11H, b12H, b21H, b22H, mu,
        wall_visc_factor)
