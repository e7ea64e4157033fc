"""The port's fused engine (plain twins on the CPU) against the JAX
package: ``init`` and one short interval against the XLA ``CellEngine``
(tests/test_pallas.py:48-95), the drift-guard rollback with the predictor
off (tests/test_drift_guard.py:86), the group loop's handling of a
crossing, and split dispatch bit-equal to the unsplit interval inside the
port (tests/test_split_dispatch.py:68)."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sph_poiseuille_flow_tpu.models.poiseuille import build_scene
from sph_poiseuille_flow_tpu.stepper import CellEngine
from sph_poiseuille_flow_tpu.stepper import initial_state as jinitial_state
from sph_poiseuille_flow_torch import interop
from sph_poiseuille_flow_torch.config import SPHConfig
from sph_poiseuille_flow_torch.stepper import (PallasCellEngine, State,
                                               initial_state, make_engine)

from test_config import default_cfg

torch.set_num_threads(1)


def port_cfg(cfg, **kw):
    return dataclasses.replace(SPHConfig(**dataclasses.asdict(cfg)), **kw)


def jittered(cfg, scene, seed=7):
    """The jittered state of tests/test_pallas.py:22-39, as numpy."""
    rng = np.random.default_rng(seed)
    nf, n = scene.n_fluid, scene.n_total
    x = np.asarray(scene.x, np.float64).copy()
    y = np.asarray(scene.y, np.float64).copy()
    x[:nf] = np.mod(x[:nf] + rng.uniform(-0.35, 0.35, nf) * cfg.dp, cfg.DL)
    y[:nf] += rng.uniform(-0.35, 0.35, nf) * cfg.dp
    vx, vy, dr = (np.zeros(n, np.float32) for _ in range(3))
    vx[:nf] = rng.normal(0, 0.4, nf)
    vy[:nf] = rng.normal(0, 0.1, nf)
    dr[:nf] = rng.normal(0, 0.05, nf)
    return dict(x=x.astype(np.float32), y=y.astype(np.float32), vx=vx,
                vy=vy, drho_dt=dr)


@pytest.fixture(scope="module")
def tiny():
    cfg = default_cfg(DL=1.0, DH=0.5, dp=0.05, end_time=0.5,
                      output_interval=0.25)
    scene = build_scene(cfg)
    return cfg, scene, CellEngine(cfg, scene), PallasCellEngine(
        port_cfg(cfg), scene, "cpu")


@pytest.fixture(scope="module")
def inits(tiny):
    cfg, scene, jeng, teng = tiny
    arrays = jittered(cfg, scene)
    js0 = jinitial_state(cfg, scene)._replace(
        **{k: jnp.asarray(v) for k, v in arrays.items()})
    ts0 = interop.state_from_numpy(
        arrays, base=initial_state(teng.cfg, scene, "cpu"))
    js, _, _, jov = jeng.init(js0)
    ts, _, _, tov = teng.init(ts0)
    assert not bool(jov) and not bool(tov)
    return js, ts


@pytest.mark.parametrize("name", ["rho", "vol", "b11", "b12", "b21", "b22",
                                  "p"])
def test_init_matches_cellgrid(inits, name):
    """tests/test_pallas.py:56-61 tolerances: the fused and the XLA cell
    layouts sum the same pairs in another order (different grids)."""
    js, ts = inits
    tol = (dict(rtol=5e-3, atol=5e-4) if name == "p"
           else dict(rtol=2e-4, atol=2e-5))
    np.testing.assert_allclose(getattr(ts, name).numpy(),
                               np.asarray(getattr(js, name)), **tol)


@pytest.fixture(scope="module")
def intervals(tiny):
    cfg, scene, jeng, teng = tiny
    js, jl, jg, _ = jeng.init(jinitial_state(cfg, scene))
    jr = jeng.run_interval(js, jl, jg, np.float32(0.02))
    ts, tl, tg, _ = teng.init(initial_state(teng.cfg, scene, "cpu"))
    tr = teng.run_interval(ts, tl, tg, np.float32(0.02))
    return jr, tr


def test_interval_n_steps_equal(intervals):
    jr, tr = intervals
    assert tr.n_steps == int(jr.n_steps) > 0
    assert not bool(tr.overflow) and not tr.skin_guard


def test_interval_n_pairs_equal(intervals):
    jr, tr = intervals
    assert int(tr.n_pairs) == int(jr.n_pairs) > 0


def test_interval_v_max_close(intervals):
    jr, tr = intervals
    assert float(tr.v_max) == pytest.approx(float(jr.v_max), rel=1e-3,
                                            abs=1e-6)


@pytest.mark.parametrize("wall", ["tau_bottom", "tau_top"])
def test_interval_wall_shear_close(intervals, wall):
    """tests/test_pallas.py:75-78: the monitor agrees to 1e-3."""
    jr, tr = intervals
    assert float(getattr(tr, wall)) == pytest.approx(
        float(getattr(jr, wall)), rel=1e-3, abs=1e-6)


def test_interval_counts_host_syncs(intervals):
    """One host sync per sub-chunk: with the default rebuild_every=1 each
    step is a sub-chunk of its own."""
    _, tr = intervals
    assert tr.n_syncs == tr.n_steps


class _CrossingRun:
    """A sub-chunk runner each of whose sub-chunks crosses the y budget
    (1.2x it), one step a 1e-4 s."""

    def __init__(self):
        self.calls, self.kept = [], 0

    def __call__(self, n_sub, t, t_comp):
        self.calls.append(n_sub)
        # two host syncs: one inside the call and its final read
        return (np.float32(0.0), np.float32(1.2e-3),
                np.float32(t + 1e-4 * n_sub), t_comp, n_sub, 2)

    def keep(self):
        self.kept += 1


@pytest.mark.parametrize("sub_len,steps,kept,rollbacks,next_len", [
    (1, 1, 1, 0, 2),    # one step straight out of the rebuild: kept
    (4, 0, 0, 1, 2),    # a longer sub-chunk: rolled back, halved
])
def test_group_crossing(sub_len, steps, kept, rollbacks, next_len):
    """A drift-budget crossing ends the group. A one-step sub-chunk
    straight out of a rebuild cannot have missed a pair (its pair terms
    are taken at the positions the candidates were built from), so it is
    kept and counted, with no rollback and no flag; a longer one is rolled
    back, not counted, and the next group's sub-chunk is half as long."""
    eng = types.SimpleNamespace(
        _np_dtype=np.float32,
        spec=types.SimpleNamespace(skin_x=1e-3, skin_y=1e-3))
    run = _CrossingRun()
    t, _, done, nrb, nxt, syncs, n_kept = PallasCellEngine._run_group(
        eng, run, True, np.float32(0.5), np.float32(0.0),
        np.float32(0.0), sub_len, 128, 16)
    assert run.calls == [sub_len]
    assert (done, run.kept, n_kept, nrb, nxt, syncs) == (
        steps, kept, kept, rollbacks, next_len, 2)
    assert t == np.float32(1e-4 * steps)


def test_rollback_with_predictor_off(monkeypatch):
    """tests/test_drift_guard.py:86 in the port: with the predictive stop
    off, every sub-chunk group runs to a genuine drift-budget crossing,
    is rolled back and re-run shorter on fresh candidates. The run must
    report rollbacks, must not hard-flag, and must land where the
    predictor-scheduled run lands (only reduction order differs)."""
    cfg = port_cfg(default_cfg(DL=1.0, DH=0.55, dp=0.05, neighbor_skin=0.001,
                               cell_capacity=18, rebuild_every=64))
    scene = build_scene(cfg)
    rng = np.random.default_rng(3)
    nf, n = scene.n_fluid, scene.n_total
    vx = np.zeros(n, np.float32)
    vy = np.zeros(n, np.float32)
    vx[:nf] = rng.normal(0, 0.8, nf)
    vy[:nf] = rng.normal(0, 0.4, nf)
    monkeypatch.setenv("SPH_SUB_STEPS", "4")

    def run(predictor):
        monkeypatch.setenv("SPH_DRIFT_PREDICTOR", predictor)
        eng = PallasCellEngine(cfg, scene, "cpu")
        s0 = initial_state(cfg, scene, "cpu")._replace(
            vx=torch.tensor(vx), vy=torch.tensor(vy))
        s, lay, geom, ov = eng.init(s0)
        assert not bool(ov)
        return eng.run_interval(s, lay, geom, np.float32(0.08))

    r_trip = run("0")
    r_sched = run("1")
    assert r_trip.n_rollbacks > 0
    assert not r_trip.skin_guard
    assert r_sched.n_rollbacks == 0
    assert r_trip.n_steps == r_sched.n_steps
    for name in ("x", "y", "vx", "vy", "rho"):
        np.testing.assert_allclose(getattr(r_trip.state, name).numpy(),
                                   getattr(r_sched.state, name).numpy(),
                                   rtol=2e-3, atol=5e-4, err_msg=name)


def test_split_dispatch_bit_equal():
    """tests/test_split_dispatch.py:68 in the port: one interval split into
    step-bounded calls (carrying the Kahan clock and the rollback chunk
    length) equals the single call bit for bit."""
    cfg = port_cfg(default_cfg(DL=1.0, DH=0.5, dp=0.05, end_time=0.5,
                               output_interval=0.25,
                               neighbor_skin=0.75 * 0.05, rebuild_every=8,
                               cell_capacity=32))
    scene = build_scene(cfg)
    eng = PallasCellEngine(cfg, scene, "cpu")
    interval = np.float32(0.04)
    s1, c1, g1, _ = eng.init(initial_state(cfg, scene, "cpu"))
    once = eng.run_interval(s1, c1, g1, interval)

    s, c, g, _ = eng.init(initial_state(cfg, scene, "cpu"))
    t_loc = t_cmp = np.float32(0.0)
    sub_len = None
    total = calls = 0
    while True:
        kw = {} if sub_len is None else {"sub_len0": sub_len}
        r = eng.run_interval(s, c, g, interval, max_steps=7,
                             t_local0=t_loc, t_comp0=t_cmp, **kw)
        assert r.n_steps <= 7 + cfg.rebuild_every - 1
        total += r.n_steps
        calls += 1
        s, c, g = r.state, r.cands, r.geom
        t_loc, t_cmp, sub_len = r.t_local, r.t_comp, r.sub_len
        if t_loc >= interval or r.n_steps == 0:
            break
    assert calls >= 3, "max_steps never bound"
    assert total == once.n_steps
    for name in State._fields:
        assert torch.equal(getattr(r.state, name),
                           getattr(once.state, name)), name
    assert float(r.tau_bottom) == float(once.tau_bottom)
    assert float(r.tau_top) == float(once.tau_top)


@pytest.mark.parametrize("engine", ["auto", "pallas"])
def test_engine_names_give_the_fused_engine(engine):
    cfg = port_cfg(default_cfg(), engine=engine)
    eng = make_engine(cfg, build_scene(cfg), "cpu")
    assert isinstance(eng, PallasCellEngine)
    assert eng.cfg.engine == "pallas"


def test_step_log_raises():
    """step_log_every > 0 no longer raises: the interval runs step by step
    and returns a row every 5 steps, numbered from ``step_base``."""
    cfg = port_cfg(default_cfg(DL=1.0, DH=0.5), step_log_every=5)
    scene = build_scene(cfg)
    eng = make_engine(cfg, scene, "cpu")
    s, lay, g, _ = eng.init(initial_state(cfg, scene, "cpu"))
    r = eng.run_interval(s, lay, g, np.float32(0.01), step_base=100)
    assert r.n_steps >= 5 and r.step_log_n == r.n_steps // 5
    np.testing.assert_array_equal(r.step_log[:r.step_log_n, 0],
                                  100 + 5 * np.arange(1, r.step_log_n + 1))
    assert r.n_syncs == r.n_steps + 1


def test_float64_on_cuda_raises():
    """The fused kernels are float32 (as Pallas compiles f32 only): the
    fused engine asked for float64 on CUDA still raises, before any device
    is touched, and names the engine that runs float64 there."""
    cfg = port_cfg(default_cfg(), engine="pallas", dtype="float64")
    with pytest.raises(NotImplementedError, match="cellgrid"):
        make_engine(cfg, build_scene(cfg), "cuda")
