"""The port's slot assignment, fused layout and drift guard against the JAX
package: ``assign_slots`` and ``build_fused_layout`` must be identical
(the slot order fixes every reduction order), and ``pair_drift_bounds``
must agree on the cases of tests/test_drift_guard.py. Inputs are made with
numpy from a seed and handed to both packages."""

import dataclasses

import numpy as np
import pytest
import torch

from sph_poiseuille_flow_tpu.models.poiseuille import build_scene
from sph_poiseuille_flow_tpu.ops import cellgrid as jcg
from sph_poiseuille_flow_tpu.ops import fused_cell as jfc
from sph_poiseuille_flow_tpu.ops import neighbors as jnb
from sph_poiseuille_flow_torch import interop
from sph_poiseuille_flow_torch.config import SPHConfig
from sph_poiseuille_flow_torch.ops import cellgrid as tcg
from sph_poiseuille_flow_torch.ops import fused_cell as tfc
from sph_poiseuille_flow_torch.ops import neighbors as tnb

from test_config import default_cfg

torch.set_num_threads(1)

# the tiny box of tests/test_pallas.py, the drift-guard box of
# tests/test_drift_guard.py, and the validated dp=0.01 channel with the
# shipping knobs (skin 0.3dp, K=14, nx=100)
CASES = {
    "tiny": dict(DL=1.0, DH=0.5, dp=0.05, end_time=0.5,
                 output_interval=0.25),
    "guard": dict(DL=1.0, DH=0.5, dp=0.05, neighbor_skin=0.02,
                  cell_capacity=18),
    "dp001": dict(DL=3.0, DH=1.0, dp=0.01, neighbor_skin=0.003,
                  rebuild_every=128, cell_capacity=14, lane_pack_nx=100),
}


def _setup(name):
    cfg = default_cfg(**CASES[name])
    scene = build_scene(cfg)
    jspec = jnb.make_grid_spec(cfg, scene, lane_pack=True)
    tspec = tnb.make_grid_spec(port_cfg(cfg), scene, lane_pack=True)
    return cfg, scene, jspec, tspec


def port_cfg(cfg):
    """The port's SPHConfig with every field of the JAX package's."""
    return SPHConfig(**dataclasses.asdict(cfg))


def jittered_positions(cfg, scene, seed, amp=0.35):
    """Fluid positions jittered by +-amp*dp (tests/test_pallas.py:22-39),
    float32, x wrapped into [0, DL)."""
    rng = np.random.default_rng(seed)
    nf = scene.n_fluid
    x = np.asarray(scene.x, np.float64).copy()
    y = np.asarray(scene.y, np.float64).copy()
    x[:nf] = np.mod(x[:nf] + rng.uniform(-amp, amp, nf) * cfg.dp, cfg.DL)
    y[:nf] += rng.uniform(-amp, amp, nf) * cfg.dp
    return x.astype(np.float32), y.astype(np.float32)


def _statics(scene):
    n = scene.n_total
    z = np.zeros(n, np.float32)
    return (np.asarray(scene.mass, np.float32), z, z,
            np.asarray(scene.y, np.float32))


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("name,seed", [("tiny", 7), ("tiny", 11),
                                       ("guard", 3), ("dp001", 5)])
def test_assign_slots_identical(name, seed):
    cfg, scene, jspec, tspec = _setup(name)
    x, y = jittered_positions(cfg, scene, seed)
    js, jo = jcg.assign_slots(jspec, x, y)
    ts, to = tcg.assign_slots(tspec, _t(x), _t(y))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert bool(to) == bool(jo)


def test_assign_slots_overflow_sentinel():
    """A cell filled past K: the extra particles get the n_cells*K
    sentinel in both packages, and both raise the flag."""
    cfg, scene, jspec, tspec = _setup("tiny")
    x, y = jittered_positions(cfg, scene, 1)
    nf = scene.n_fluid
    x[:nf:3] = x[0]
    y[:nf:3] = y[0]
    js, jo = jcg.assign_slots(jspec, x, y)
    ts, to = tcg.assign_slots(tspec, _t(x), _t(y))
    assert bool(jo) and bool(to)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def layout_pair(name, seed, state_fields=0):
    """The same jittered positions through both packages' layout build."""
    cfg, scene, jspec, tspec = _setup(name)
    x, y = jittered_positions(cfg, scene, seed)
    statics = _statics(scene)
    rng = np.random.default_rng(seed + 100)
    extra = [rng.normal(0, 1, scene.n_total).astype(np.float32)
             for _ in range(state_fields)]
    jl = jfc.build_fused_layout(jspec, x, y, *statics,
                                state_fields=tuple(extra))
    tl = tfc.build_fused_layout(tspec, _t(x), _t(y),
                                *(_t(a) for a in statics),
                                state_fields=tuple(_t(a) for a in extra))
    return cfg, scene, jspec, tspec, jl, tl


@pytest.mark.parametrize("name,seed", [("tiny", 7), ("guard", 3),
                                       ("dp001", 5)])
def test_build_fused_layout_identical(name, seed):
    *_, jl, tl = layout_pair(name, seed, state_fields=3)
    (jlay, jcores), (tlay, tcores) = jl, tl
    for f in jfc.FusedLayout._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tlay, f)),
                                      np.asarray(getattr(jlay, f)),
                                      err_msg=f)
    assert tlay.occ.dtype == torch.int32
    for jc, tc in zip(jcores, tcores):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_layout_interop_round_trip():
    """interop.layout_from_numpy carries the JAX layout across unchanged:
    identical to the port's own build."""
    *_, jl, tl = layout_pair("tiny", 7)
    carried = interop.layout_from_numpy(
        {f: np.asarray(getattr(jl, f)) for f in jfc.FusedLayout._fields})
    for f in tfc.FusedLayout._fields:
        a, b = getattr(carried, f), getattr(tl, f)
        assert a.dtype == b.dtype, f
        assert torch.equal(a, b), f


@pytest.mark.parametrize("core", ["plain", "halo", "halo_x"])
def test_scatter_and_halo_identical(core):
    cfg, scene, jspec, tspec, jl, tl = layout_pair("tiny", 7)
    vals = np.random.default_rng(4).normal(0, 1, scene.n_total).astype(
        np.float32)
    if core == "plain":
        j = jfc.make_plain(jspec, jl.pidx, vals)
        t = tfc.make_plain(tspec, tl.pidx, _t(vals))
    else:
        kw = (dict(fill=jfc._BIG_X, xshift=jspec.DL) if core == "halo_x"
              else {})
        j = jfc.make_core(jspec, jl.pidx, vals, **kw)
        t = tfc.make_core(tspec, tl.pidx, _t(vals), **kw)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tfc.take_p(tl, tfc.make_plain(
        tspec, tl.pidx, _t(vals))).numpy(), vals)


# ---- pair_drift_bounds (mirrors tests/test_drift_guard.py:33-85) ----


@pytest.fixture(scope="module")
def guard():
    cfg, scene, jspec, tspec = _setup("guard")
    # the pristine lattice, as test_drift_guard builds it
    statics = _statics(scene)
    x0 = np.asarray(scene.x, np.float32)
    y0 = np.asarray(scene.y, np.float32)
    jl = jfc.build_fused_layout(jspec, x0, y0, *statics)
    tl = tfc.build_fused_layout(tspec, _t(x0), _t(y0),
                                *(_t(a) for a in statics))
    return cfg, scene, jspec, tspec, jl, tl, x0, y0


def _bounds(guard, x, y):
    cfg, scene, jspec, tspec, jl, tl, *_ = guard
    jb = jfc.pair_drift_bounds(
        jspec, jl, jfc.make_plain(jspec, jl.pidx, x, fill=jfc._BIG_X),
        jfc.make_plain(jspec, jl.pidx, y))
    tb = tfc.pair_drift_bounds(
        tspec, tl, tfc.make_plain(tspec, tl.pidx, _t(x), fill=tfc._BIG_X),
        tfc.make_plain(tspec, tl.pidx, _t(y)))
    jb = (float(jb[0]), float(jb[1]))
    tb = (float(tb[0]), float(tb[1]))
    assert tb == jb
    return tb


def test_drift_no_motion(guard):
    *_, x0, y0 = guard
    assert _bounds(guard, x0, y0) == (0.0, 0.0)


def test_drift_uniform_translation_anchored_by_walls(guard):
    cfg, scene, *_, x0, y0 = guard
    d = 0.4 * cfg.dp
    x = x0.copy()
    x[:scene.n_fluid] += d
    bx, by = _bounds(guard, x, y0)
    assert abs(bx - d) < 1e-6 and by == 0.0


def test_drift_single_particle(guard):
    cfg, scene, *_, x0, y0 = guard
    i = scene.n_fluid // 2
    x, y = x0.copy(), y0.copy()
    x[i] += 0.3 * cfg.dp
    y[i] += -0.25 * cfg.dp
    bx, by = _bounds(guard, x, y)
    assert abs(bx - 0.3 * cfg.dp) < 1e-6
    assert abs(by - 0.25 * cfg.dp) < 1e-6


@pytest.mark.parametrize("frac,tripped", [(0.9, False), (1.1, True)])
def test_drift_exceeded_thresholds(guard, frac, tripped):
    cfg, scene, jspec, tspec, jl, tl, x0, y0 = guard
    y = y0.copy()
    y[scene.n_fluid // 3] += frac * tspec.skin_y
    jflag = jfc.pair_drift_exceeded(
        jspec, jl, jfc.make_plain(jspec, jl.pidx, x0, fill=jfc._BIG_X),
        jfc.make_plain(jspec, jl.pidx, y))
    tflag = tfc.pair_drift_exceeded(
        tspec, tl, tfc.make_plain(tspec, tl.pidx, _t(x0), fill=tfc._BIG_X),
        tfc.make_plain(tspec, tl.pidx, _t(y)))
    assert bool(tflag) == bool(jflag) == tripped


def test_drift_random_displacements_match(guard):
    cfg, scene, *_, x0, y0 = guard
    rng = np.random.default_rng(12)
    nf = scene.n_fluid
    x, y = x0.copy(), y0.copy()
    x[:nf] += rng.normal(0, 0.1, nf).astype(np.float32) * cfg.dp
    y[:nf] += rng.normal(0, 0.1, nf).astype(np.float32) * cfg.dp
    bx, by = _bounds(guard, x, y)
    assert bx > 0.0 and by > 0.0
