"""The recompute form's window walk (csrc/fused_cell.cu FORM_WIN,
``walk_window``) on the CPU: a lane group per anchor slot walks the anchor's
window in pieces of 128 positions, tests x and y of the candidates below
each row's occupancy bound (pass 1), and takes the valid ones in window
order (pass 2); every lane adds the terms of the candidates in that
order. ``_walk`` mirrors that walk in numpy, its index arithmetic included
(pass 1's row-by-row, dx-fastest order and rank bound, pass 2's decode of
a set bit by compares), and the tests hold it against the plain sweeps:

* the sweeps rebuilt from the walk's candidates alone, their geometry
  recomputed and put back at their window positions, equal
  ``_sweeps_plain(..., n_cached=0)`` bit for bit, at config.ini's grid
  (K=16) and at the K=48 grid of chip_smoke.py's k48 phase;
* with every window sum taken one term at a time in window order (the
  kernels' order), the sums over the walk's candidates alone equal the
  sums over all 9K candidates bit for bit: skipping an invalid candidate
  is exact;
* on the tiny jittered grid of tests/test_torch_fused.py, those sums hold
  the JAX package's recompute ``_kernel_body`` (a ``pallas_call`` in
  interpret mode) to the step tolerances of tests/test_torch_fused.py;
* the lane picker (``fused_cell_cuda.win_groups``) gives a power of two
  <= 32 at every grid chip_smoke.py runs; the kernels take no shared
  memory, so none can exceed a block's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from sph_poiseuille_flow_tpu.ops import fused_cell as jfc
from sph_poiseuille_flow_tpu.ops import neighbors as jnb
from sph_poiseuille_flow_torch import interop
from sph_poiseuille_flow_torch.config import (SPHConfig, derive_config,
                                              load_config)
from sph_poiseuille_flow_torch.models.poiseuille import build_scene
from sph_poiseuille_flow_torch.ops import fused_cell as tfc
from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc
from sph_poiseuille_flow_torch.ops import neighbors as tnb

import chip_smoke
from test_torch_cache_list import _ini_case, _jitter
from test_torch_fused import (STEP_CORES, TOL_STEP, _close, _scalars,
                              tiny_case)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIECE = 128          # window positions per piece of the walk (kPiece)


def _k48_case():
    """chip_smoke.py's k48 grid (dp=0.025 in the tiny box, three cell
    columns, K=48) with the seeded jitter, port only."""
    cfg = derive_config(**chip_smoke.K48)
    scene = build_scene(cfg)
    spec = tnb.make_grid_spec(cfg, scene, lane_pack=True)
    st = {k: torch.tensor(v) for k, v in _jitter(cfg, scene).items()}
    z = torch.zeros(scene.n_total)
    lay = tfc.build_fused_layout(spec, st["x"], st["y"],
                                 torch.tensor(scene.mass, dtype=torch.float32),
                                 z, z, torch.tensor(scene.y,
                                                    dtype=torch.float32))
    assert not bool(lay.overflow) and spec.K == 48
    cores = (tfc.make_core(spec, lay.pidx, st["x"], fill=tfc._BIG_X,
                           xshift=spec.DL),
             *(tfc.make_core(spec, lay.pidx, st[k]) for k in ("y", "vx",
                                                              "vy")),
             tfc.make_plain(spec, lay.pidx, st["drho_dt"]))
    return dict(cfg=cfg, spec=spec, lay=lay, cores=cores)


@pytest.fixture(scope="module", params=["ini", "k48"])
def case(request):
    return _ini_case() if request.param == "ini" else _k48_case()


def _walk(spec, lay, xH, yH):
    """The kernels' walk of every visited anchor's window, in numpy:
    (slot, halo'd-core index, window position (dy*3 + dx)*K + j) of each
    valid candidate, in the order the anchor's group takes them. Slots in
    the (iy, k, ix) order; ROWS window rows a span, pieces of 128
    positions (w = dr*3K + dx*K + j - b) a span, as walk_window."""
    K, nx = spec.K, spec.nx
    x, y = xH.numpy(), yH.numpy()
    nyp = x.shape[0] - 2
    R3 = 3 * K
    rows = 3 if 9 * K <= PIECE else 1
    W = rows * R3
    iy, k, ix = (a.reshape(-1) for a in np.meshgrid(
        np.arange(nyp), np.arange(K), np.arange(nx), indexing="ij"))
    occ = lay.occ[:, 0].numpy().repeat(tfc.plan(spec)[0])[:nyp]
    ha = ((iy + 1) * K + k) * (nx + 2) + ix + 1
    xa, ya = x.reshape(-1)[ha], y.reshape(-1)[ha]
    walks = (k < occ[iy]) & (xa < np.float32(5e8))   # visited, not parked
    cut2 = np.float32(spec.cutoff * spec.cutoff)
    DL = np.float32(spec.DL)

    def in_range(xv, yv):
        ddx = xa[:, None] - xv
        if nx < 3:
            ddx = ddx - DL * np.rint(ddx / DL)
        ddy = ya[:, None] - yv
        r2 = ddx * ddx + ddy * ddy
        return (r2 < cut2) & (r2 > np.float32(1e-24))

    out, order = [], 0
    for dy0 in range(0, 3, rows):
        for b in range(0, W, PIECE):
            mask = np.zeros((iy.size, PIECE), bool)
            for dr in range(rows):
                # pass 1: the row's candidates u = 3j + dx, dx fastest,
                # ranks below the row's occupancy bound (none in the
                # y-halo rows)
                row = iy + dy0 + dr
                inside = (row >= 1) & (row <= nyp)
                jn = np.where(inside, occ[np.clip(row - 1, 0, nyp - 1)], 0)
                u = np.arange(3 * K)
                j, dx = u // 3, u % 3
                w = dr * R3 + dx * K + j - b
                i = ((row[:, None] * K + j) * (nx + 2) + ix[:, None] + dx)
                ok = (in_range(x.reshape(-1)[i], y.reshape(-1)[i])
                      & (j[None, :] < jn[:, None])
                      & ((w >= 0) & (w < PIECE))[None, :] & walks[:, None])
                sl, col = np.nonzero(ok)
                mask[sl, w[col]] = True
            # pass 2: the set bits in ascending position, decoded by
            # compares
            sl, pos = np.nonzero(mask)
            w2 = b + pos
            dr2 = (0 if rows == 1
                   else (w2 >= R3).astype(int) + (w2 >= 2 * R3))
            u2 = w2 - dr2 * R3
            dx2 = (u2 >= K).astype(int) + (u2 >= 2 * K)
            j2 = u2 - dx2 * K
            idx = (((iy[sl] + dy0 + dr2) * K + j2) * (nx + 2) + ix[sl]
                   + dx2)
            out.append((sl, idx, ((dy0 + dr2) * 3 + dx2) * K + j2,
                        order * PIECE + pos))
            order += 1
    sl, idx, wpos, key = (np.concatenate(a) for a in zip(*out))
    o = np.lexsort((key, sl))
    return sl[o], idx[o], wpos[o]


def _rebuild(spec, s, walk, xH, yH):
    """Replace the pair geometry of the plain sweeps' state ``s`` by the
    geometry of the walk's candidates alone, recomputed and put back at
    their window positions (+0 elsewhere)."""
    sl, idx, wpos = (torch.as_tensor(a) for a in walk)
    nyp, K, nx = xH.shape[0] - 2, spec.K, spec.nx
    iy, k, ix = sl // (K * nx), (sl // nx) % K, sl % nx
    ha = ((iy + 1) * K + k) * (nx + 2) + ix + 1
    geo = tfc._geometry(spec, xH.reshape(-1)[ha], yH.reshape(-1)[ha],
                        xH.reshape(-1)[idx], yH.reshape(-1)[idx],
                        s.isfC.reshape(-1)[idx])
    assert bool((geo[5] + geo[6] == 1).all())   # every one valid
    for name, v in zip(("r", "ex", "ey", "w", "dw", "m1", "mw"), geo):
        full = torch.zeros((nyp, K, 9 * K, nx))
        full[iy, k, wpos, ix] = v
        setattr(s, name, full)


def _inputs(case):
    spec, lay, cores, cfg = (case[k] for k in ("spec", "lay", "cores",
                                               "cfg"))
    sc = _scalars(cfg, cfg.transport_coeff)
    scal = (*sc[:5], *(torch.tensor(v, dtype=torch.float32)
                       for v in sc[5:]))
    return spec, lay, [*cores, lay.isf_c, lay.mass_c, lay.wvx_c,
                       lay.wvy_c], scal


def _listed(spec, walk, nyp):
    """(nyp, K, 9K, nx) mask of the walk's candidates."""
    sl, _, wpos = (torch.as_tensor(a) for a in walk)
    K, nx = spec.K, spec.nx
    m = torch.zeros((nyp, K, 9 * K, nx), dtype=torch.bool)
    m[sl // (K * nx), (sl // nx) % K, wpos, sl % nx] = True
    return m


def _window_order_sum(monkeypatch, listed=None):
    """torch.sum over the window axis taken one term at a time in window
    order from +0 (the kernels' order), over ``listed`` candidates only
    where given."""
    plain = torch.sum

    def seq(x, dim=None, **kw):
        if dim != 2 or x.dim() != 4:
            return plain(x, dim=dim, **kw)
        acc = torch.zeros_like(x[:, :, 0])
        for j in range(x.shape[2]):
            nxt = acc + x[:, :, j]
            acc = nxt if listed is None else torch.where(
                listed[:, :, j].expand_as(nxt), nxt, acc)
        return acc

    monkeypatch.setattr(torch, "sum", seq)


def test_walk_lists_the_valid_candidates_in_window_order(case):
    """The walk's candidates are the plain list's (cache_list_plain over
    every rank): the valid candidates of each visited anchor, in window
    order."""
    spec, lay, (xH, yH) = case["spec"], case["lay"], case["cores"][:2]
    sl, idx, _ = _walk(spec, lay, xH, yH)
    ref = tfc.cache_list_plain(spec, lay, xH, yH, spec.K)
    n = np.bincount(sl, minlength=ref["n"].numel())
    assert np.array_equal(n, ref["n"].numpy())
    used = np.arange(9 * spec.K)[None, :] < n[:, None]
    assert np.array_equal(idx, ref["idx"].numpy()[used])
    if spec.K == 48:   # ranks past 32 of a window row: a second piece
        assert int(lay.occ.max()) > 32


def test_walk_rebuilds_the_recompute_sweeps(case):
    """Each sweep from the walk's candidates alone, their geometry
    recomputed, equals _sweeps_plain(..., n_cached=0) bit for bit."""
    spec, lay, inputs, scal = _inputs(case)
    dt = torch.tensor(2e-4)
    ref = tfc._sweeps_plain(spec, inputs, lay.occ, dt, scal, 0, 0, 4)
    o = {}
    s = tfc._Sweep(spec, inputs, lay.occ, dt, scal, 0, o)
    _rebuild(spec, s, _walk(spec, lay, inputs[0], inputs[1]), inputs[0],
             inputs[1])
    for i in range(4):
        tfc._SWEEPS[i](s)
    assert set(o) == set(ref)
    for name, v in ref.items():
        assert torch.equal(o[name], v), name


def test_window_order_sums_skip_invalid_candidates_exactly(case,
                                                           monkeypatch):
    """With every window sum taken term by term in window order, the sums
    over the walk's candidates alone equal the sums over all 9K candidates
    bit for bit (as tensors of bits: -0 and +0 apart)."""
    spec, lay, inputs, scal = _inputs(case)
    dt = torch.tensor(2e-4)
    walk = _walk(spec, lay, inputs[0], inputs[1])
    _window_order_sum(monkeypatch)
    every = tfc._sweeps_plain(spec, inputs, lay.occ, dt, scal, 0, 0, 4)
    _window_order_sum(monkeypatch, _listed(spec, walk,
                                           inputs[0].shape[0] - 2))
    walked = tfc._sweeps_plain(spec, inputs, lay.occ, dt, scal, 0, 0, 4)
    for name, v in every.items():
        assert torch.equal(walked[name].view(torch.int32),
                           v.view(torch.int32)), name


@pytest.fixture(scope="module")
def tiny():
    """The tiny jittered grid in the JAX package's layout, the JAX
    recompute step (interpret mode) on it, and the port's inputs."""
    cfg, scene, st = tiny_case()
    cfg = dataclasses.replace(cfg, geom_cache="none")
    f32 = {k: v.astype(np.float32) for k, v in st.items()}
    jspec = jnb.make_grid_spec(cfg, scene, lane_pack=True)
    assert jfc.cache_plan(jspec, np.float32)[0] == "none"
    spec = tnb.make_grid_spec(SPHConfig(**dataclasses.asdict(cfg)), scene,
                              lane_pack=True)
    z = np.zeros(scene.n_total, np.float32)
    jl = jfc.build_fused_layout(jspec, f32["x"], f32["y"],
                                np.asarray(scene.mass, np.float32), z, z,
                                np.asarray(scene.y, np.float32))
    lay = interop.layout_from_numpy(
        {f: np.asarray(getattr(jl, f)) for f in jfc.FusedLayout._fields})
    jc = (jfc.make_core(jspec, jl.pidx, f32["x"], fill=jfc._BIG_X,
                        xshift=jspec.DL),
          *(jfc.make_core(jspec, jl.pidx, f32[k]) for k in ("y", "vx",
                                                            "vy")),
          jfc.make_plain(jspec, jl.pidx, f32["drho_dt"]))
    dt = np.float32(2e-4)
    j = jfc.fused_step_cores(jspec, jl, *jc, dt,
                             *_scalars(cfg, cfg.transport_coeff))
    j = {k: np.asarray(v) for k, v in jax.device_get(j).items()}
    cores = tuple(torch.tensor(np.asarray(a)) for a in jc)
    return dict(cfg=cfg, spec=spec, lay=lay, cores=cores, jax=j, dt=dt)


def test_tiny_grid_is_the_recompute_form(tiny):
    assert tfc.step_form(tiny["spec"], torch.float32) == ("none", 0)


@pytest.fixture(scope="module")
def tiny_walked(tiny):
    """The kernels' sums on the tiny grid: term by term in window order
    over the walk's candidates alone."""
    spec, lay, inputs, scal = _inputs(tiny)
    walk = _walk(spec, lay, inputs[0], inputs[1])
    with pytest.MonkeyPatch.context() as mp:
        _window_order_sum(mp, _listed(spec, walk, inputs[0].shape[0] - 2))
        o = tfc._step_plain(spec, inputs, lay.occ,
                            torch.tensor(tiny["dt"]), scal, 0)
    o["cnt"] = tfc._cnt_rows(spec, o["cnt"])
    return {k: v.numpy() for k, v in o.items()}


@pytest.mark.parametrize("name", STEP_CORES)
def test_walked_step_matches_jax_recompute_kernel(tiny, tiny_walked, name):
    _close(tiny_walked[name], tiny["jax"][name], TOL_STEP, name,
           tiny["cfg"].p0)


def _grid_spec(label):
    cfg = {"a": lambda: load_config(os.path.join(ROOT, "config.ini")),
           "b": lambda: derive_config(**chip_smoke.DP001),
           "d025": lambda: derive_config(**chip_smoke.DP0025),
           "k48": lambda: derive_config(**chip_smoke.K48)}[label]()
    return tnb.make_grid_spec(cfg, build_scene(cfg), lane_pack=True)


@pytest.mark.parametrize("label", ["a", "b", "d025", "k48"])
def test_lane_picker_fits_every_grid(label):
    spec = _grid_spec(label)
    nyp = tfc.plan(spec)[3]
    G = fcc.win_groups(nyp * spec.K * spec.nx)
    assert G in fcc.WIN_GROUPS and G <= 32 and G & (G - 1) == 0
    assert all(g <= 32 and g & (g - 1) == 0 for g in fcc.WIN_GROUPS)
    c = fcc._const(spec, tfc.plan(spec)[0], 1.0, 0.0, 0.0, 0.0, 0.0)
    assert c.wg == G
