"""The geometry-cache form's pair list (``fused_cell.cache_list_plain``,
the plain version of what the cache kernels' sweep 0 writes) on the CPU:
at config.ini's grid and on the tiny jittered grid of
tests/test_pallas.py (through the JAX package's layout).

* n per cached slot is the number of valid candidates that ``_geometry``
  finds in the anchor's window: the port's, and on the tiny grid the JAX
  package's ``_geometry`` inside a ``pallas_call`` in interpret mode;
* idx lists those candidates in the (dy, dx, k) window order, checked
  against a numpy walk of the window;
* sweeps 1-3 fed from the list (its entries put back at their window
  positions) equal ``_sweeps_plain`` on the same cores, bit for bit: the
  list holds every term the sweeps need, and the terms it leaves out are
  the +-0 of invalid candidates.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sph_poiseuille_flow_tpu.ops import fused_cell as jfc
from sph_poiseuille_flow_tpu.ops import neighbors as jnb
from sph_poiseuille_flow_torch import interop
from sph_poiseuille_flow_torch.config import SPHConfig, load_config
from sph_poiseuille_flow_torch.models.poiseuille import build_scene
from sph_poiseuille_flow_torch.ops import fused_cell as tfc
from sph_poiseuille_flow_torch.ops import neighbors as tnb

from test_torch_fused import _scalars, tiny_case

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jitter(cfg, scene, seed=7):
    """The seeded jitter of tests/test_pallas.py:22-39 as numpy float32."""
    rng = np.random.default_rng(seed)
    nf, n = scene.n_fluid, scene.n_total
    x = np.asarray(scene.x, np.float64).copy()
    y = np.asarray(scene.y, np.float64).copy()
    x[:nf] = np.mod(x[:nf] + rng.uniform(-0.35, 0.35, nf) * cfg.dp, cfg.DL)
    y[:nf] += rng.uniform(-0.35, 0.35, nf) * cfg.dp
    vx, vy, dr = (np.zeros(n) for _ in range(3))
    vx[:nf] = rng.normal(0, 0.4, nf)
    vy[:nf] = rng.normal(0, 0.1, nf)
    dr[:nf] = rng.normal(0, 0.05, nf)
    return {k: v.astype(np.float32)
            for k, v in dict(x=x, y=y, vx=vx, vy=vy, drho_dt=dr).items()}


def _ini_case():
    """config.ini's grid (dp=0.05, K=16) with the jitter, port only."""
    cfg = load_config(os.path.join(ROOT, "config.ini"))
    scene = build_scene(cfg)
    spec = tnb.make_grid_spec(cfg, scene, lane_pack=True)
    st = {k: torch.tensor(v) for k, v in _jitter(cfg, scene).items()}
    z = torch.zeros(scene.n_total)
    lay = tfc.build_fused_layout(spec, st["x"], st["y"],
                                 torch.tensor(scene.mass, dtype=torch.float32),
                                 z, z, torch.tensor(scene.y,
                                                    dtype=torch.float32))
    assert not bool(lay.overflow)
    cores = (tfc.make_core(spec, lay.pidx, st["x"], fill=tfc._BIG_X,
                           xshift=spec.DL),
             *(tfc.make_core(spec, lay.pidx, st[k]) for k in ("y", "vx",
                                                              "vy")),
             tfc.make_plain(spec, lay.pidx, st["drho_dt"]))
    return dict(cfg=cfg, spec=spec, lay=lay, cores=cores)


def _tiny_case():
    """The tiny jittered grid in the JAX package's layout, both ways."""
    cfg, scene, st = tiny_case()
    f32 = {k: v.astype(np.float32) for k, v in st.items()}
    jspec = jnb.make_grid_spec(cfg, scene, lane_pack=True)
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
          *(jfc.make_core(jspec, jl.pidx, f32[k]) for k in ("y", "vx", "vy")),
          jfc.make_plain(jspec, jl.pidx, f32["drho_dt"]))
    cores = tuple(torch.tensor(np.asarray(a)) for a in jc)
    return dict(cfg=cfg, spec=spec, lay=lay, cores=cores, jspec=jspec,
                jl=jl, jc=jc)


@pytest.fixture(scope="module", params=["ini", "tiny"])
def case(request):
    return _ini_case() if request.param == "ini" else _tiny_case()


def _valid(spec, lay, cores):
    """(nyp, K, 9K, nx) validity of every anchor rank's window (port
    ``_geometry``) and the (nyp, K, 1, 1) visited mask."""
    xH, yH = cores[0], cores[1]
    *_, m1, mw = tfc._geometry(
        spec, tfc._pair(tfc._anc(xH)), tfc._pair(tfc._anc(yH)),
        tfc._win(spec, xH), tfc._win(spec, yH), tfc._win(spec, lay.isf_c),
        need_w=False)
    vis = tfc._visited(spec, lay.occ, xH.shape[0] - 2).unsqueeze(-1)
    return (m1 + mw) > 0, vis


def _slots(t, k_cut):
    """(nyp, K, ..., nx) -> (ncs, ...) for the ranks k < k_cut, cached
    slot (iy*k_cut + k)*nx + ix."""
    t = t[:, :k_cut]
    return t.movedim(-1, 2).reshape(-1, *t.shape[2:-1])


@pytest.mark.parametrize("k_cut", ["K", 3])
def test_list_counts_are_the_valid_candidates(case, k_cut):
    spec, lay, cores = case["spec"], case["lay"], case["cores"]
    kc = spec.K if k_cut == "K" else k_cut
    got = tfc.cache_list_plain(spec, lay, cores[0], cores[1], kc)
    valid, vis = _valid(spec, lay, cores)
    want = _slots((valid & vis).sum(dim=2), kc)
    assert got["n"].dtype == torch.int32
    assert torch.equal(got["n"].long(), want)
    assert int(got["n"].sum()) > 0
    assert got["idx"].shape == (want.numel(), 9 * spec.K)


def _jax_valid(case):
    """(K, 9K, nyp, nx) validity m1 + mw from the JAX package's _geometry
    of each anchor rank against its window, in a pallas_call in interpret
    mode over (9K, nyp*nx) slabs staged as _stage stages them."""
    jspec, jl, jc = case["jspec"], case["jl"], case["jc"]
    nyp = jfc.plan(jspec)[3]
    K, nx = jspec.K, jspec.nx

    def slab(core):
        c = np.asarray(core)
        return jnp.asarray(np.concatenate(
            [np.concatenate([c[r + dy, :, dx:dx + nx] for r in range(nyp)],
                            axis=1)
             for dy in range(3) for dx in range(3)], axis=0))

    def body(x_ref, y_ref, isf_ref, o_ref):
        for k in range(K):
            *_, m1, mw = jfc._geometry(jspec, k, x_ref, y_ref, isf_ref,
                                       need_w=False)
            o_ref[k * 9 * K:(k + 1) * 9 * K, :] = m1 + mw

    out = pl.pallas_call(
        body, in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((K * 9 * K, nyp * nx), jnp.float32),
        interpret=True)(slab(jc[0]), slab(jc[1]), slab(jl.isf_c))
    return np.asarray(out).reshape(K, 9 * K, nyp, nx) > 0


def test_list_counts_match_jax_geometry():
    """n per cached slot against the JAX package's _geometry (tiny grid):
    the valid candidates of every visited anchor, and no others."""
    case = _tiny_case()
    spec, lay, cores = case["spec"], case["lay"], case["cores"]
    got = tfc.cache_list_plain(spec, lay, cores[0], cores[1], spec.K)
    jvalid = torch.tensor(_jax_valid(case)).permute(2, 0, 1, 3)
    _, vis = _valid(spec, lay, cores)
    want = _slots((jvalid & vis).sum(dim=2), spec.K)
    assert torch.equal(got["n"].long(), want)


def test_list_order_is_the_window_order(case):
    """idx: the valid candidates' halo'd-core indices in (dy, dx, k)
    order, from a numpy walk of each anchor's window; entries past n are
    -1 and zero."""
    spec, lay, cores = case["spec"], case["lay"], case["cores"]
    K, nx = spec.K, spec.nx
    got = tfc.cache_list_plain(spec, lay, cores[0], cores[1], K)
    x, y = cores[0].numpy(), cores[1].numpy()
    nyp = x.shape[0] - 2
    occ = lay.occ[:, 0].numpy().repeat(tfc.plan(spec)[0])[:nyp]
    iy, k, ix = np.meshgrid(np.arange(nyp), np.arange(K), np.arange(nx),
                            indexing="ij")
    xa, ya = x[iy + 1, k, ix + 1], y[iy + 1, k, ix + 1]
    cut2 = np.float32(spec.cutoff * spec.cutoff)
    want = [[] for _ in range(iy.size)]
    for dy in range(3):
        for dx in range(3):
            for j in range(K):
                hv = ((iy + dy) * K + j) * (nx + 2) + ix + dx
                ddx = xa - x.reshape(-1)[hv]
                ddy = ya - y.reshape(-1)[hv]
                r2 = ddx * ddx + ddy * ddy
                ok = (r2 < cut2) & (r2 > np.float32(1e-24)) & (k < occ[iy])
                for s in np.flatnonzero(ok.reshape(-1)):
                    want[s].append(hv.reshape(-1)[s])
    # slots in (iy, k, ix) order are the cached slots at k_cut = K
    idx = got["idx"].numpy()
    n = got["n"].numpy()
    for s, w in enumerate(want):
        assert n[s] == len(w), s
        assert idx[s, :n[s]].tolist() == w, s
    used = np.arange(9 * K)[None, :] < n[:, None]
    assert (idx[~used] == -1).all()
    for name in ("ex", "ey", "r", "c1", "cw"):
        assert not got[name].numpy()[~used].any(), name


def _from_list(spec, s, lst, k_cut):
    """Replace the cached ranks' pair geometry of the plain sweeps' state
    ``s`` by the list's entries at their window positions (zero where the
    list has none): r, ex, ey as listed, dw = c1 + cw (one of them is 0),
    m1 the candidate's fluid flag, mw the rest of the valid mask."""
    nyp, K, nx = s.xC.shape[0] - 2, spec.K, spec.nx
    n = lst["n"].long()
    e = torch.arange(9 * K)[None, :] < n[:, None]
    slot, ent = torch.nonzero(e, as_tuple=True)
    idx = lst["idx"][slot, ent].long()
    iy = slot // (k_cut * nx)
    k = (slot // nx) % k_cut
    ix = slot % nx
    row, col = idx // (nx + 2), idx % (nx + 2)
    dy, j, dx = row // K - iy, row % K, col - ix
    w = (dy * 3 + dx) * K + j
    full = (nyp, K, 9 * K, nx)

    def put(vals, base):
        out = base.expand(full).clone()
        out[:, :k_cut] = 0.0
        out[iy, k, w, ix] = vals
        return out

    valid = put(torch.ones(len(idx)), torch.zeros(()))
    isf = s.isfC.reshape(-1)[idx]
    s.r = put(lst["r"][slot, ent], s.r)
    s.ex = put(lst["ex"][slot, ent], s.ex)
    s.ey = put(lst["ey"][slot, ent], s.ey)
    s.dw = put(lst["c1"][slot, ent] + lst["cw"][slot, ent], s.dw)
    s.m1 = put(isf, s.m1)
    s.mw = torch.where(torch.arange(K)[None, :, None, None] < k_cut,
                       valid - s.m1, s.mw)


@pytest.mark.parametrize("k_cut", ["K", 3])
def test_sweeps_from_the_list_are_the_plain_sweeps(case, k_cut):
    spec, lay, cores = case["spec"], case["lay"], case["cores"]
    cfg = case["cfg"]
    kc = spec.K if k_cut == "K" else k_cut
    inputs = [*cores, lay.isf_c, lay.mass_c, lay.wvx_c, lay.wvy_c]
    sc = _scalars(cfg, cfg.transport_coeff)
    scal = (*sc[:5], *(torch.tensor(v, dtype=torch.float32) for v in sc[5:]))
    dt = torch.tensor(2e-4)
    ref = tfc._sweeps_plain(spec, inputs, lay.occ, dt, scal, kc, 0, 4)
    o = tfc._sweeps_plain(spec, inputs, lay.occ, dt, scal, kc, 0, 1)
    s = tfc._Sweep(spec, inputs, lay.occ, dt, scal, kc, o)
    _from_list(spec, s,
               tfc.cache_list_plain(spec, lay, cores[0], cores[1], kc), kc)
    for i in (1, 2, 3):
        tfc._SWEEPS[i](s)
    assert set(o) == set(ref)
    for name, v in ref.items():
        assert torch.equal(o[name], v), name
