"""The rows form's tiled walk (csrc/fused_cell.cu FORM_ROWS, ``rows_sweep``)
on the CPU. A block holds one cell row x TX columns x K ranks x G lanes per
anchor slot (slots in the (k, tx) order); it stages its window into shared
memory (``FieldSet::stage``: tile[f][dy][j][col], W = TX+2 words a rank,
only the ranks below each candidate row's occupancy bound and the halo'd
columns inside the core; a thread takes one (rank, column) and every field
there), and every lane group walks its anchor's window from that tile with
the recompute form's walk (``walk_window`` over ``InTile``). ``_stage``
and ``_tile_walk`` mirror that index arithmetic in numpy (the staging
loop's decode, pass 1's row-by-row, dx-fastest order and rank bound, pass
2's decode of a set bit by compares, ``InTile::at``), and the tests hold
it:

* the walk, each candidate read through the tile's staging map, lists
  exactly the plain list's valid candidates (``cache_list_plain`` over
  every rank) in window order, at config.ini's grid (K=16) and at the K=48
  grid of chip_smoke.py's k48 phase, for the tile ``rows_tile`` picks and
  for tiles whose last one the grid's edge cuts;
* the sweeps rebuilt from those candidates equal
  ``_sweeps_plain(..., n_cached=0)`` bit for bit;
* every tile position the walk reads lies inside the block's shared
  memory and was staged, the staging writes each position at most once,
  and the launch's blocks and groups take every slot of the grid once;
* pass 1's loads of a warp are free of bank conflicts at the picked tiles,
  whatever the rows' occupancy;
* ``fused_cell_cuda.rows_tile`` gives a tile that fits a block (threads <=
  1024, G a power of two <= 32, shared memory <= 227 KB) at every grid
  chip_smoke.py runs, and raises where no tile fits.
"""

import numpy as np
import pytest
import torch

from sph_poiseuille_flow_torch.ops import fused_cell as tfc
from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc

from test_torch_cache_list import _ini_case
from test_torch_win_walk import (PIECE, _grid_spec, _inputs, _k48_case,
                                 _rebuild)

torch.set_num_threads(1)

N_FIELDS = fcc.ROWS_FIELDS   # sweep 2 stages the most fields


@pytest.fixture(scope="module", params=["ini", "k48"])
def case(request):
    return _ini_case() if request.param == "ini" else _k48_case()


def _picked(spec):
    nyp = tfc.plan(spec)[3]
    return fcc.rows_tile(spec.K, nyp * spec.K * spec.nx, spec.nx)[0]


def _row_occ(spec, lay, nyp):
    """The anchor-rank bound of each halo'd cell row (``row_occ``: 0 for
    the two y-halo rows)."""
    occ = lay.occ[:, 0].numpy().repeat(tfc.plan(spec)[0])[:nyp]
    return np.concatenate([[0], occ, [0]])


def _stage(spec, lay, nyp, TX):
    """``FieldSet::stage`` for every block (iy, x0) of the grid: (n_blocks,
    N_FIELDS * 3K*W) halo'd-core index of each tile position (field f's
    plane offset by f * nh, nh the halo'd core's size), -1 where nothing
    was staged."""
    K, nx = spec.K, spec.nx
    W, nx2 = TX + 2, spec.nx + 2
    nh = (nyp + 2) * K * nx2
    occ_h = _row_occ(spec, lay, nyp)
    tiles = -(-nx // TX)
    tile = np.full((nyp * tiles, N_FIELDS * 3 * K * W), -1, np.int64)
    f = np.arange(N_FIELDS)
    for blk in range(nyp * tiles):
        iy, x0 = blk // tiles, (blk % tiles) * TX
        cols = min(W, nx2 - x0)
        jn = occ_h[iy:iy + 3]
        for t in range(jn.max() * cols):   # a thread's (rank, column)
            j, col = t // cols, t % cols
            for dy in range(3):
                if j >= jn[dy]:
                    continue
                at = ((f * 3 + dy) * K + j) * W + col
                assert (tile[blk, at] == -1).all()   # written once
                tile[blk, at] = f * nh + ((iy + dy) * K + j) * nx2 + x0 + col
    return tile


def _tile_walk(spec, lay, xH, yH, TX):
    """The rows kernels' walk of every visited anchor's window from its
    block's tile, in numpy: (slot, halo'd-core index, window position
    (dy*3 + dx)*K + j) of each valid candidate in the order the anchor's
    group takes them, with the tile positions it read. Slots in the (iy, k,
    ix) order; the anchor at tile column tx = ix - x0 reads candidate (dy,
    j, dx) at (dy*K + j)*W + tx + dx (``InTile::at``)."""
    K, nx = spec.K, spec.nx
    W = TX + 2
    x, y = xH.numpy().reshape(-1), yH.numpy().reshape(-1)
    nyp = xH.shape[0] - 2
    R3 = 3 * K
    rows = 3 if 9 * K <= PIECE else 1
    span = rows * R3
    iy, k, ix = (a.reshape(-1) for a in np.meshgrid(
        np.arange(nyp), np.arange(K), np.arange(nx), indexing="ij"))
    tiles = -(-nx // TX)
    x0 = ix // TX * TX
    tx = ix - x0
    blk = iy * tiles + ix // TX
    tile = _stage(spec, lay, nyp, TX)
    occ_h = _row_occ(spec, lay, nyp)
    ha = ((iy + 1) * K + k) * (nx + 2) + ix + 1
    xa, ya = x[ha], y[ha]
    walks = (k < occ_h[iy + 1]) & (xa < np.float32(5e8))
    cut2 = np.float32(spec.cutoff * spec.cutoff)
    DL = np.float32(spec.DL)
    plane = 3 * K * W
    reads = []

    def ld(f, at, on):
        """Field f (0: x, 1: y) at tile positions ``at`` of each slot's
        block, through the staging map; records the positions read."""
        pos = f * plane + np.where(on, at, 0)
        src = tile[blk[:, None], pos]
        reads.append((pos[on], src[on]))
        core = x if f == 0 else y
        return core[np.where(src >= 0, src % x.size, 0)]

    def in_range(xv, yv):
        ddx = xa[:, None] - xv
        if nx < 3:
            ddx = ddx - DL * np.rint(ddx / DL)
        ddy = ya[:, None] - yv
        r2 = ddx * ddx + ddy * ddy
        return (r2 < cut2) & (r2 > np.float32(1e-24))

    out, order = [], 0
    for dy0 in range(0, 3, rows):
        for b in range(0, span, PIECE):
            mask = np.zeros((iy.size, PIECE), bool)
            for dr in range(rows):
                # pass 1: u = 3j + dx, dx fastest, ranks below the row's
                # occupancy bound
                jn = occ_h[iy + dy0 + dr]
                u = np.arange(3 * K)
                j, dx = u // 3, u % 3
                w = dr * R3 + dx * K + j - b
                at = ((dy0 + dr) * K + j)[None, :] * W + tx[:, None] + dx
                on = ((j[None, :] < jn[:, None])
                      & ((w >= 0) & (w < PIECE))[None, :] & walks[:, None])
                ok = on & in_range(ld(0, at, on), ld(1, at, on))
                sl, col = np.nonzero(ok)
                mask[sl, w[col]] = True
            # pass 2: the set bits in ascending position, decoded by
            # compares, read from the tile
            sl, pos = np.nonzero(mask)
            w2 = b + pos
            dr2 = (0 if rows == 1
                   else (w2 >= R3).astype(int) + (w2 >= 2 * R3))
            u2 = w2 - dr2 * R3
            dx2 = (u2 >= K).astype(int) + (u2 >= 2 * K)
            j2 = u2 - dx2 * K
            at2 = ((dy0 + dr2) * K + j2) * W + tx[sl] + dx2
            src = tile[blk[sl], at2]
            reads.append((at2, src))
            out.append((sl, src, ((dy0 + dr2) * 3 + dx2) * K + j2,
                        order * PIECE + pos))
            order += 1
    sl, idx, wpos, key = (np.concatenate(a) for a in zip(*out))
    o = np.lexsort((key, sl))
    return (sl[o], idx[o], wpos[o]), reads


def _tiles(spec):
    """The picked tile width and one whose last tile the grid's edge
    cuts."""
    picked = _picked(spec)
    return picked, next(t for t in (3, 2, 4, 5)
                        if spec.nx % t and t != picked)


def test_tile_walk_lists_the_valid_candidates_in_window_order(case):
    spec, lay, (xH, yH) = case["spec"], case["lay"], case["cores"][:2]
    ref = tfc.cache_list_plain(spec, lay, xH, yH, spec.K)
    for TX in _tiles(spec):
        (sl, idx, _), _ = _tile_walk(spec, lay, xH, yH, TX)
        n = np.bincount(sl, minlength=ref["n"].numel())
        assert np.array_equal(n, ref["n"].numpy()), TX
        used = np.arange(9 * spec.K)[None, :] < n[:, None]
        assert np.array_equal(idx, ref["idx"].numpy()[used]), TX
    if spec.K == 48:   # ranks past 32 of a window row: a second piece
        assert int(lay.occ.max()) > 32


def test_tile_walk_rebuilds_the_recompute_sweeps(case):
    """Each sweep from the tiled walk's candidates alone, their geometry
    recomputed, equals _sweeps_plain(..., n_cached=0) bit for bit."""
    spec, lay, inputs, scal = _inputs(case)
    dt = torch.tensor(2e-4)
    ref = tfc._sweeps_plain(spec, inputs, lay.occ, dt, scal, 0, 0, 4)
    o = {}
    s = tfc._Sweep(spec, inputs, lay.occ, dt, scal, 0, o)
    walk, _ = _tile_walk(spec, lay, inputs[0], inputs[1], _picked(spec))
    _rebuild(spec, s, walk, inputs[0], inputs[1])
    for i in range(4):
        tfc._SWEEPS[i](s)
    assert set(o) == set(ref)
    for name, v in ref.items():
        assert torch.equal(o[name], v), name


def test_tile_walk_reads_only_staged_positions(case):
    spec, lay, (xH, yH) = case["spec"], case["lay"], case["cores"][:2]
    for TX in _tiles(spec):
        _, reads = _tile_walk(spec, lay, xH, yH, TX)
        words = N_FIELDS * 3 * spec.K * (TX + 2)   # the block's allocation
        for at, src in reads:
            assert ((at >= 0) & (at < words)).all(), TX
            assert (src >= 0).all(), TX


def test_groups_take_every_slot_once(case):
    """The launch: nyp * ceil(nx / TX) blocks of TX*K groups, group a of
    block (iy, x0) on slot (iy, a // TX, x0 + a % TX) where that column is
    inside the grid (``tile_slot``): every slot of the grid once."""
    spec = case["spec"]
    K, nx = spec.K, spec.nx
    nyp = tfc.plan(spec)[3]
    for TX in _tiles(spec):
        seen = np.zeros((nyp, K, nx), int)
        tiles = -(-nx // TX)
        for blk in range(nyp * tiles):
            iy, x0 = blk // tiles, (blk % tiles) * TX
            a = np.arange(TX * K)
            k, ix = a // TX, x0 + a % TX
            on = ix < nx
            np.add.at(seen, (iy, k[on], ix[on]), 1)
        assert (seen == 1).all(), TX


@pytest.mark.parametrize("label", ["a", "b", "d025", "k48"])
def test_rows_tile_fits_every_grid(label):
    spec = _grid_spec(label)
    nyp = tfc.plan(spec)[3]
    TX, G = fcc.rows_tile(spec.K, nyp * spec.K * spec.nx, spec.nx)
    assert G in fcc.ROWS_GROUPS and G <= 32 and G & (G - 1) == 0
    assert 1 <= TX <= spec.nx and TX * spec.K * G <= 1024
    assert fcc.rows_smem(spec.K, TX) <= 227 * 1024
    c = fcc._const(spec, tfc.plan(spec)[0], 1.0, 0.0, 0.0, 0.0, 0.0,
                   rows=True)
    assert (c.tx, c.rg) == (TX, G)
    assert fcc._const(spec, tfc.plan(spec)[0], 1.0, 0.0, 0.0, 0.0,
                      0.0).rg == 0


@pytest.mark.parametrize("K", [257, 400])
def test_rows_tile_raises_where_no_tile_fits(K):
    with pytest.raises(ValueError, match="no rows-form tile fits"):
        fcc.rows_tile(K, 100 * K * 40, 40)


def _pass1_bank_ways(K, TX, G, occ):
    """The most distinct words of pass 1 that one load of a warp puts on
    one of the 32 banks, in a row whose window rows all hold occ ranks
    (each group's lanes at u = lane, lane + G, ...; the warp's groups at
    neighbouring columns or ranks of the tile; the groups of ranks past
    occ do not walk)."""
    W, worst = TX + 2, 1
    for w0 in range(0, TX * K * G, 32):
        t = np.arange(w0, min(w0 + 32, TX * K * G))
        a, lane = t // G, t % G
        walks, col = a // TX < occ, a % TX
        for it in range(0, 3 * occ, G):
            u = lane + it
            j, dx = u // 3, u % 3
            words = np.unique((j * W + col + dx)[walks & (u < 3 * occ)])
            if words.size:
                worst = max(worst, np.bincount(words % 32).max())
    return worst


@pytest.mark.parametrize("label", ["a", "b", "d025", "k48"])
def test_pass1_loads_are_free_of_bank_conflicts(label):
    """At the tile rows_tile picks, W = TX+2 words a rank needs no
    padding: at any occupancy a warp's pass-1 loads fall on distinct banks
    or share a word (a broadcast)."""
    spec = _grid_spec(label)
    nyp = tfc.plan(spec)[3]
    TX, G = fcc.rows_tile(spec.K, nyp * spec.K * spec.nx, spec.nx)
    ways = {occ: _pass1_bank_ways(spec.K, TX, G, occ)
            for occ in range(1, spec.K + 1)}
    assert set(ways.values()) == {1}, ways
