"""The port's cell-layout engine (``stepper.CellEngine`` over
``ops/cellgrid.py``, plain torch on the CPU) against the JAX package's XLA
``CellEngine``: ``init`` and one step on the jittered state of
tests/test_pallas.py:22-39 in float32 (that file's tolerances, :56-78) and
in float64 (1e-10 relative), ``n_steps``, ``v_max`` and the wall shear over
a short window (cf. tests/test_cellgrid.py:126); the float64 init against
tests/oracle_numpy.py; inside the port, the engine names, a split dispatch
bit-equal to one call, the step log, and the CLI in float64 with its
restart file and L2 verdict."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sph_poiseuille_flow_tpu.models.poiseuille import build_scene
from sph_poiseuille_flow_tpu.stepper import CellEngine as JCellEngine
from sph_poiseuille_flow_tpu.stepper import initial_state as jinitial_state
from sph_poiseuille_flow_torch import interop
from sph_poiseuille_flow_torch import run as cli
from sph_poiseuille_flow_torch.ops import cellgrid as tcg
from sph_poiseuille_flow_torch.stepper import (CellEngine, PallasCellEngine,
                                               initial_state, make_engine,
                                               resolve_engine_name)

from test_config import default_cfg
from test_torch_engine import jittered, port_cfg

torch.set_num_threads(1)

INIT_FIELDS = ("rho", "vol", "b11", "b12", "b21", "b22", "p")
STEP_FIELDS = ("x", "y", "vx", "vy", "rho", "p", "drho_dt", "fx", "fy",
               "fpx", "fpy", "vol", "b11", "b12", "b21", "b22")


def _tiny(dtype="float32"):
    cfg = default_cfg(DL=1.0, DH=0.5, dp=0.05, end_time=0.5,
                      output_interval=0.25, dtype=dtype)
    return cfg, build_scene(cfg)


def _host(out):
    """(state fields, dt, tau_bottom, tau_top) of a ``step`` as numpy."""
    st = out[0]
    return ({n: np.asarray(getattr(st, n)) for n in st._fields},
            float(out[3]), float(out[6]), float(out[7]))


def _run_both(dtype):
    """init, one step and a 0.05 s interval of both engines from the same
    jittered state."""
    cfg, scene = _tiny(dtype)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    arrays = jittered(cfg, scene)
    with jax.enable_x64(dtype == "float64"):
        jeng = JCellEngine(cfg, scene)
        js0 = jinitial_state(cfg, scene)._replace(
            **{k: jnp.asarray(v, jdt) for k, v in arrays.items()})
        js, jl, jg, jov = jeng.init(js0)
        jinit = {n: np.asarray(getattr(js, n)) for n in INIT_FIELDS}
        jstep = _host(jeng.step(js, jl, jg, remain=1.0))
        jr = jeng.run_interval(js, jl, jg, np.dtype(dtype).type(0.05))
        jint = (int(jr.n_steps), float(jr.v_max), float(jr.tau_bottom),
                float(jr.tau_top), int(jr.n_pairs), bool(jov))
    teng = CellEngine(port_cfg(cfg), scene, "cpu")
    ts0 = interop.state_from_numpy(
        arrays, dtype=getattr(torch, dtype),
        base=initial_state(teng.cfg, scene, "cpu"))
    ts, tl, tg, tov = teng.init(ts0)
    tinit = {n: getattr(ts, n).numpy() for n in INIT_FIELDS}
    tstep = _host(teng.step(ts, tl, tg, remain=1.0))
    tr = teng.run_interval(ts, tl, tg, np.dtype(dtype).type(0.05))
    tint = (tr.n_steps, float(tr.v_max), float(tr.tau_bottom),
            float(tr.tau_top), int(tr.n_pairs), bool(tov))
    return dict(init=(jinit, tinit), step=(jstep, tstep),
                interval=(jint, tint))


@pytest.fixture(scope="module")
def f32():
    return _run_both("float32")


@pytest.fixture(scope="module")
def f64():
    return _run_both("float64")


@pytest.mark.parametrize("name", INIT_FIELDS)
def test_init_matches_jax_cellengine_f32(f32, name):
    """tests/test_pallas.py:56-61 tolerances."""
    j, t = f32["init"]
    tol = (dict(rtol=5e-3, atol=5e-4) if name == "p"
           else dict(rtol=2e-4, atol=2e-5))
    assert t[name].dtype == np.float32
    np.testing.assert_allclose(t[name], j[name], **tol)


@pytest.mark.parametrize("name", STEP_FIELDS)
def test_step_matches_jax_cellengine_f32(f32, name):
    """tests/test_pallas.py:63-72 tolerances, in particle order."""
    (j, *_), (t, *_) = f32["step"]
    tols = {"p": dict(rtol=1e-2, atol=2.5e-2),
            "drho_dt": dict(rtol=5e-3, atol=5e-3)}
    np.testing.assert_allclose(t[name], j[name],
                               **tols.get(name, dict(rtol=2e-3, atol=5e-4)))


def test_step_dt_and_shear_match_f32(f32):
    """dt to 1e-6 and the wall shear to 1e-3 (tests/test_pallas.py:68,
    :73-78)."""
    (_, jdt, jtb, jtt), (_, tdt, ttb, ttt) = f32["step"]
    assert tdt == pytest.approx(jdt, rel=1e-6)
    assert ttb == pytest.approx(jtb, rel=1e-3, abs=1e-6)
    assert ttt == pytest.approx(jtt, rel=1e-3, abs=1e-6)


@pytest.mark.parametrize("part", ["init", "step"])
def test_matches_jax_cellengine_f64(f64, part):
    """float64: every field within 1e-10 of its largest magnitude, dt and
    the wall shear within 1e-10 relative."""
    j, t = f64[part]
    if part == "step":
        (j, *js), (t, *ts) = j, t
        np.testing.assert_allclose(ts, js, rtol=1e-10, atol=1e-14)
    for name, r in j.items():
        assert t[name].dtype == np.float64, name
        np.testing.assert_allclose(
            t[name], r, rtol=0, atol=1e-10 * max(1.0, np.max(np.abs(r))),
            err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_interval_matches_jax_cellengine(f32, f64, dtype):
    """Over 0.05 s: the same n_steps and n_pairs, no overflow, v_max and
    tau within 1e-4 relative (f32 summation order) or 1e-10 (f64)."""
    j, t = (f32 if dtype == "float32" else f64)["interval"]
    assert t[0] == j[0] and t[0] > 10
    assert t[4] == j[4]
    assert not j[5] and not t[5]
    rel = 1e-4 if dtype == "float32" else 1e-10
    for a, b in zip(t[1:4], j[1:4]):
        assert a == pytest.approx(b, rel=rel, abs=1e-12)


@pytest.mark.parametrize("engine,dtype,want", [
    ("auto", "float32", "pallas"), ("auto", "float64", "cellgrid"),
    ("cellgrid", "float32", "cellgrid"), ("cellgrid", "float64", "cellgrid"),
    ("pallas", "float64", "pallas")])
def test_resolve_engine_name(engine, dtype, want):
    """"auto" sends float64 to the cell-layout engine, as the JAX
    package's does; float32 stays with the fused engine."""
    cfg = port_cfg(default_cfg(), engine=engine, dtype=dtype)
    assert resolve_engine_name(cfg) == want


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_make_engine_builds_cellengine(dtype):
    cfg = port_cfg(default_cfg(), engine="auto" if dtype == "float64"
                   else "cellgrid", dtype=dtype)
    eng = make_engine(cfg, build_scene(cfg), "cpu")
    assert isinstance(eng, CellEngine)
    assert not isinstance(eng, PallasCellEngine)
    assert eng.cfg.engine == "cellgrid" and eng.dtype == getattr(torch,
                                                                  dtype)
    # the cell-layout engine's grid is the JAX CellEngine's (no lane pack)
    assert eng.spec.nx == int(np.floor(cfg.DL / (2 * cfg.h)))


def test_split_dispatch_is_bit_equal():
    """Step-bounded calls that carry the Kahan clock reproduce one call
    bit for bit (tests/test_split_dispatch.py:68), with the rebuild cadence
    carried by ``steps_done0``."""
    cfg, scene = _tiny()
    cfg = port_cfg(cfg, neighbor_skin=0.01, rebuild_every=4)
    eng = CellEngine(cfg, scene, "cpu")
    arrays = jittered(cfg, scene)
    s0 = interop.state_from_numpy(arrays,
                                  base=initial_state(cfg, scene, "cpu"))
    s, lay, geom, _ = eng.init(s0)
    il = np.float32(0.02)
    once = eng.run_interval(s, lay, geom, il)
    t_loc = t_cmp = np.float32(0.0)
    done = 0
    while t_loc < il:
        r = eng.run_interval(s, lay, geom, il, max_steps=3, t_local0=t_loc,
                             t_comp0=t_cmp, steps_done0=done)
        s, lay, geom = r.state, r.cands, r.geom
        t_loc, t_cmp = r.t_local, r.t_comp
        done += r.n_steps
    assert done == once.n_steps
    for name in s._fields:
        assert torch.equal(getattr(s, name), getattr(once.state, name)), name
    assert float(r.tau_bottom) == float(once.tau_bottom)


def test_step_log_rows():
    """step_log_every > 0: a row every 4 steps from ``step_base``, tau
    every step (the value of the final row equals the interval's)."""
    cfg, scene = _tiny()
    cfg = port_cfg(cfg, engine="cellgrid", step_log_every=4)
    eng = make_engine(cfg, scene, "cpu")
    s, lay, g, _ = eng.init(initial_state(cfg, scene, "cpu"))
    r = eng.run_interval(s, lay, g, np.float32(0.01), step_base=40)
    assert r.step_log_n == r.n_steps // 4 and r.n_steps >= 8
    np.testing.assert_array_equal(r.step_log[:r.step_log_n, 0],
                                  40 + 4 * np.arange(1, r.step_log_n + 1))
    assert r.n_syncs == r.n_steps + 1
    if r.n_steps % 4 == 0:
        assert r.step_log[r.step_log_n - 1, 5] == np.float32(r.tau_bottom)


def test_guards_of_the_layout():
    """displacement_exceeded is the half-skin test against the rebuild's
    positions; step_displacement_exceeded the same for one step."""
    from sph_poiseuille_flow_torch.ops import neighbors as tnb
    cfg, scene = _tiny()
    cfg = port_cfg(cfg, neighbor_skin=0.01)
    eng = CellEngine(cfg, scene, "cpu")
    s = initial_state(cfg, scene, "cpu")
    lay = eng._rebuild(s.x, s.y)
    x = s.x.clone()
    x[0] += 0.0049
    assert not bool(tcg.displacement_exceeded(eng.spec, lay, x, s.y))
    assert not bool(tnb.step_displacement_exceeded(eng.spec, s.x, s.y, x,
                                                   s.y))
    x[0] += 0.0002
    assert bool(tcg.displacement_exceeded(eng.spec, lay, x, s.y))
    assert bool(tnb.step_displacement_exceeded(eng.spec, s.x, s.y, x, s.y))


def test_cli_float64_cellgrid(tmp_path, capsys):
    """``--dtype float64`` runs end to end through the cell-layout engine:
    the log, the restart file in float64 and the L2 verdict."""
    ini = tmp_path / "c.ini"
    ini.write_text("[physical]\nDL = 1.0\nDH = 0.5\ndp = 0.05\nrho0 = 1.0\n"
                   "mu = 0.1\nU_bulk = 0.666667\nc_f = 15.0\n[simulation]\n"
                   "end_time = 0.04\noutput_interval = 0.02\n"
                   "sort_interval = 100\nrestart_from_file = 0\n")
    rc = cli.main(["--config", str(ini), "--base-dir", str(tmp_path),
                   "--device", "cpu", "--dtype", "float64"])
    out = capsys.readouterr().out
    assert rc in (0, 1)
    assert "L2 relative error" in out and "output point: t=0.040000" in out
    with np.load(tmp_path / "restart.npz") as z:
        assert z["vx"].dtype == np.float64
        assert float(z["t"]) == pytest.approx(0.04)


def test_init_matches_numpy_oracle_f64():
    """float64 init (density, Vol, KGC B) against tests/oracle_numpy.py, the
    independent store-once pair-list implementation of the reference's
    operators, on a jittered state."""
    import oracle_numpy
    cfg, scene = _tiny("float64")
    rng = np.random.default_rng(11)
    nf, n = scene.n_fluid, scene.n_total
    x = np.asarray(scene.x, np.float64).copy()
    y = np.asarray(scene.y, np.float64).copy()
    x[:nf] = np.mod(x[:nf] + rng.uniform(-0.3, 0.3, nf) * cfg.dp, cfg.DL)
    y[:nf] += rng.uniform(-0.3, 0.3, nf) * cfg.dp
    pairs = oracle_numpy.build_pairs(x, y, nf, cfg.DL, cfg.h)
    rho_o, vol_o, b_o = oracle_numpy.density_correction(
        pairs, np.asarray(scene.mass, np.float64), nf, n, cfg.rho0, cfg.h,
        cfg.inv_sigma0)
    eng = CellEngine(port_cfg(cfg), scene, "cpu")
    s0 = interop.state_from_numpy(dict(x=x, y=y), dtype=torch.float64,
                                  base=initial_state(eng.cfg, scene, "cpu"))
    s, _, _, ovf = eng.init(s0)
    assert not bool(ovf)
    np.testing.assert_allclose(s.rho.numpy(), rho_o, rtol=1e-10)
    np.testing.assert_allclose(s.vol.numpy(), vol_o, rtol=1e-10)
    b = np.stack([getattr(s, f).numpy() for f in ("b11", "b12", "b21",
                                                  "b22")], axis=1)
    np.testing.assert_allclose(b, b_o, rtol=1e-9, atol=1e-12)
