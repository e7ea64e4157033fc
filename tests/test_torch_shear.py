"""The plain versions behind three kernels on the CPU:

* the wall shear over the layout's wall rows only (``shear_row_list``,
  the rows the shear kernel launches over) equals the plain twin over
  every row, slot by slot, the row list is the rows within one cell
  row of a wall slot, and the shear's bound charges those rows only;
* the geometry-cache form takes any K: ``fused_cell_cuda._form`` accepts
  K = 48, and at K = 48, where a window row holds 3K = 144 candidates (two
  pieces of the kernel's 128-bit mask), the plain list's counts match the
  JAX package's ``_geometry`` in interpret mode and its order is the
  window order;
* the one-hot expand's plain version (the product) on rows that hold -0,
  inf and NaN is what ``probes.expand_onehot_values`` says the product is.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sph_poiseuille_flow_tpu.ops import fused_cell as jfc
from sph_poiseuille_flow_tpu.ops import neighbors as jnb
from sph_poiseuille_flow_torch import interop
from sph_poiseuille_flow_torch.config import SPHConfig
from sph_poiseuille_flow_torch.ops import fused_cell as tfc
from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc
from sph_poiseuille_flow_torch.ops import neighbors as tnb
from sph_poiseuille_flow_torch.ops import probes
from sph_poiseuille_flow_torch.utils import roofline

from test_torch_cache_list import (_ini_case, _jax_valid, _jitter, _slots,
                                   _tiny_case, _valid)
from test_torch_fused import _scalars
from test_config import default_cfg
from sph_poiseuille_flow_tpu.models.poiseuille import build_scene

torch.set_num_threads(1)


def _shear_inputs(case):
    """The stepped cores the engine hands the shear (one plain step)."""
    cfg, spec, lay, cores = (case[k] for k in ("cfg", "spec", "lay",
                                               "cores"))
    o = tfc.fused_step_cores_plain(spec, lay, *cores, 2e-4,
                                   *_scalars(cfg, cfg.transport_coeff))
    return (cores[0], cores[1], o["vxH"], o["volH"], o["b11H"], o["b12H"],
            o["b21H"], o["b22H"])


@pytest.fixture(scope="module", params=["ini", "tiny"])
def case(request):
    return _ini_case() if request.param == "ini" else _tiny_case()


def test_shear_over_the_wall_rows_is_the_full_shear(case):
    """Slot by slot, bit for bit: the rows left out hold +0 in both."""
    spec, lay, cfg = case["spec"], case["lay"], case["cfg"]
    sh = _shear_inputs(case)
    mu = torch.tensor(cfg.mu, dtype=torch.float32)
    wf = torch.tensor(cfg.wall_visc_factor, dtype=torch.float32)
    full = torch.stack(tfc._shear_plain(spec, lay, *sh, mu, wf))
    assert torch.equal(full, tfc.fused_wall_shear_slots_plain(
        spec, lay, *sh, cfg.mu, cfg.wall_visc_factor, every_row=True))
    rows = lay.shear_rows.to(torch.int64)
    part = tfc.fused_wall_shear_slots_plain(spec, lay, *sh, cfg.mu,
                                            cfg.wall_visc_factor)
    assert 0 < rows.numel() < full.shape[1]
    assert torch.equal(part, full)
    assert int((full != 0).sum()) > 0
    assert not full[:, np.setdiff1d(np.arange(full.shape[1]),
                                    rows.numpy())].any()
    tb, tt = tfc.fused_wall_shear_cores(spec, lay, *sh, cfg.mu,
                                        cfg.wall_visc_factor)
    assert float(tb) == float(-torch.sum(full[0]) / spec.DL)
    assert float(tt) == float(-torch.sum(full[1]) / spec.DL)


def test_shear_row_list(case):
    """The rows whose window (rows iy-1 .. iy+1) holds a wall slot,
    ascending, and the partials zeroed over the whole plain grid."""
    lay, spec = case["lay"], case["spec"]
    wall = ((lay.wbot_c != 0) | (lay.wtop_c != 0)).flatten(1).any(1).numpy()
    nyp = wall.size - 2
    want = [iy for iy in range(nyp) if wall[iy:iy + 3].any()]
    assert lay.shear_rows.dtype == torch.int32
    assert lay.shear_rows.tolist() == want
    assert lay.shear_tbt.shape == (2, nyp, spec.K, spec.nx)
    assert lay.shear_tbt.dtype == lay.isf_c.dtype
    assert not lay.shear_tbt.any()
    # the bottom wall's rows start the grid; some rows hold no wall slot
    assert want[0] == 0 and 0 < len(want) < nyp


def test_layout_from_jax_builds_the_row_list():
    case = _tiny_case()
    lay = case["lay"]
    rows, tbt = tfc.shear_row_list(lay.wbot_c, lay.wtop_c)
    assert torch.equal(lay.shear_rows, rows)
    assert torch.equal(lay.shear_tbt, tbt)


def test_shear_bound_counts_the_wall_rows_only(case):
    """The shear's bound charges the listed rows: the seven window cores
    over the halo'd rows the windows span, five anchor cores and two
    partials over the listed rows, the tests of their occupied anchors'
    candidates; less than the whole grid's bytes and tests."""
    spec, lay, cores = case["spec"], case["lay"], case["cores"]
    n = roofline.pair_counts(spec, lay, cores[0], cores[1])
    rows = lay.shear_rows.tolist()
    K, nx = spec.K, spec.nx
    assert n["wall_rows"] == len(rows)
    assert n["window_rows"] == len({r + d for r in rows for d in range(3)})
    xa = cores[0][1:-1, :, 1:-1]
    vis = tfc._visited(spec, lay.occ, xa.shape[0])[..., 0]
    held = sum(int(((xa[r] < 1e8) & vis[r, :, None]).sum()) for r in rows)
    assert n["wall_cands"] == held * 9 * K
    assert 0 < n["wall"] and n["wall_cands"] < n["cands"]
    ms, by = roofline.bound("shear", spec, n)
    nbytes = (7 * n["window_rows"] * K * (nx + 2) * 4
              + 7 * len(rows) * K * nx * 4
              + 4 * (len(rows) + lay.occ.numel()))
    ops = (n["wall_cands"] * roofline.TEST_OPS
           + n["wall"] * roofline.SHEAR_PAIR_OPS)
    assert ms == pytest.approx(1e3 * max(nbytes / roofline.PEAK_BYTES,
                                         ops / roofline.PEAK_OPS))
    assert by == ("bytes" if nbytes / roofline.PEAK_BYTES
                  > ops / roofline.PEAK_OPS else "operations")
    nyp = xa.shape[0]
    assert nbytes < 12 * (nyp + 2) * K * (nx + 2) * 4 + 2 * nyp * K * nx * 4


@pytest.mark.parametrize("form", ["full", "ring", "partial"])
@pytest.mark.parametrize("K", [42, 43, 48, 64])
def test_cache_form_takes_any_k(form, K):
    """No cap on K: a window row of 3K candidates is walked in pieces of
    128 positions on the card."""
    assert fcc._form(form, K // 2 if form == "partial" else K, K) == (
        1, K // 2 if form == "partial" else K)


def _k48_case():
    """A dense tiny grid at K = 48: dp = 0.025 in the tiny box with three
    cell columns, so the jittered cells hold up to 47 particles and ranks
    past 32 land in the second piece of a window row (positions
    dx*K + j >= 128)."""
    cfg = default_cfg(DL=1.0, DH=0.5, dp=0.025, end_time=0.5,
                      output_interval=0.25, cell_capacity=48,
                      lane_pack_nx=3, plan_r=2)
    scene = build_scene(cfg)
    f32 = _jitter(cfg, scene)
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
          jfc.make_core(jspec, jl.pidx, f32["y"]))
    cores = tuple(torch.tensor(np.asarray(a)) for a in jc)
    return dict(cfg=cfg, spec=spec, lay=lay, cores=cores, jspec=jspec,
                jl=jl, jc=jc)


@pytest.fixture(scope="module")
def k48():
    return _k48_case()


def test_k48_grid_fills_the_second_piece(k48):
    spec, lay = k48["spec"], k48["lay"]
    assert spec.K == 48 and spec.nx == 3 and not bool(lay.overflow)
    assert int(lay.occ.max()) > 32
    assert tfc.chunk_form(spec, torch.float32)[0] in ("full", "ring",
                                                      "partial")


def test_k48_list_counts_match_jax_geometry(k48):
    spec, lay, cores = k48["spec"], k48["lay"], k48["cores"]
    got = tfc.cache_list_plain(spec, lay, cores[0], cores[1], spec.K)
    jvalid = torch.tensor(_jax_valid(k48)).permute(2, 0, 1, 3)
    _, vis = _valid(spec, lay, cores)
    want = _slots((jvalid & vis).sum(dim=2), spec.K)
    assert torch.equal(got["n"].long(), want)
    assert int(got["n"].sum()) > 0


def test_k48_list_order_is_the_window_order(k48):
    """idx in (dy, dx, k) order, from a direct walk of the windows of the
    anchors that hold the most candidates."""
    spec, lay, cores = k48["spec"], k48["lay"], k48["cores"]
    K, nx = spec.K, spec.nx
    got = tfc.cache_list_plain(spec, lay, cores[0], cores[1], K)
    x, y = cores[0].numpy(), cores[1].numpy()
    cut2 = np.float32(spec.cutoff * spec.cutoff)
    n = got["n"].numpy()
    for s in np.argsort(-n)[:20]:
        iy, k, ix = s // (K * nx), (s // nx) % K, s % nx
        xa, ya = x[iy + 1, k, ix + 1], y[iy + 1, k, ix + 1]
        want = []
        for dy in range(3):
            for dx in range(3):
                for j in range(K):
                    hv = ((iy + dy) * K + j) * (nx + 2) + ix + dx
                    ddx = xa - x.reshape(-1)[hv]
                    ddy = ya - y.reshape(-1)[hv]
                    r2 = ddx * ddx + ddy * ddy
                    if r2 < cut2 and r2 > np.float32(1e-24):
                        want.append(hv)
        assert got["idx"][s, :n[s]].tolist() == want


def _expand_rows(bx):
    """Rows of the expand's input: values that need more than 10 mantissa
    bits, then rows with -0 (one all negative), inf and NaN."""
    rng = np.random.default_rng(3)
    v = np.where(rng.random((8, bx)) < 0.5,
                 rng.integers(1, 8192, (8, bx)) * 2 + 1,
                 rng.random((8, bx)) * 3.0).astype(np.float32)
    v[1] = -np.abs(v[1])
    v[1, 0] = -0.0
    v[2, bx // 2] = -0.0
    v[3, 1] = np.inf
    v[3, 2] = np.nan
    v[4, 0] = -np.inf
    v[5, bx - 1] = np.nan
    return torch.tensor(v)


@pytest.mark.parametrize("bx,K", [(8, 4), (100, 14), (5, 3)])
def test_expand_plain_semantics(bx, K):
    """The product on the CPU is v + 0 where no other entry of the row is
    non-finite and v is not NaN (-0 becomes +0), NaN elsewhere; the finite
    rows are v tiled K times."""
    v = _expand_rows(bx)
    got = probes.expand_onehot_plain(v, K)
    want = probes.expand_onehot_values(v, K)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok].view(torch.int32), want[ok].view(torch.int32))
    zeros = got[1:3] == 0
    assert zeros.any() and not torch.signbit(got[1:3][zeros]).any()
    finite = torch.isfinite(v).all(dim=1)
    assert torch.equal(got[finite], (v[finite] + 0.0).repeat(1, K))
    # an inf and a NaN in one row: each column meets a non-finite product
    assert torch.isnan(got[3]).all()
    # a lone -inf survives in its own columns only
    assert got[4, 0] == -float("inf") and got[4, bx] == -float("inf")
    assert torch.isnan(got[4]).sum() == K * (bx - 1)
    assert torch.isnan(got[5]).all()


def test_expand_values_reference():
    """The reference on a hand-made row: -0 -> +0, the inf kept where it
    is the only non-finite entry, NaN everywhere a NaN or a second
    non-finite entry meets."""
    v = torch.tensor([[-0.0, -1.0, 2.0], [1.0, float("inf"), -0.0],
                      [float("inf"), float("nan"), 3.0]])
    got = probes.expand_onehot_values(v, 2)
    assert got.shape == (3, 6)
    assert got[0, 0] == 0 and not torch.signbit(got[0, 0])
    assert got[0, 1] == -1 and got[0, 5] == 2
    assert torch.isnan(got[1, 0]) and torch.isinf(got[1, 1])
    assert torch.isnan(got[1, 2]) and torch.isnan(got[2]).all()
