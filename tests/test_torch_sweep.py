"""The port's (g, mu) sweeps (``sph_poiseuille_flow_torch.parallel``) on
the CPU, on the tiny box of tests/test_parallel.py:22-24 over two output
points (0.04 s): ``make_workloads`` against the JAX package's; the fused
sweep (plain twins), each lane bit-equal to a fresh single
``PallasCellEngine`` run built from the lane's config; the lane-batched
``CellEngine`` and ``Engine`` sweeps, each lane against its own single
run (float64 to 1e-10 relative, float32 at tests/test_parallel.py:60's
tolerance), and one lane a chunk equal to one chunk of every lane; the
port's cellgrid sweep against the JAX package's ``run_sweep`` (its
vmapped path); the fused and cellgrid sweeps against each other
(tests/test_parallel.py:63-80); and the per-lane restarts and handoff
files of both paths, a second run under ``restart_from_file`` taking no
step and reproducing the final state (tests/test_parallel.py:83-151).

The lanes are mu = 0.1 (acoustic dt) and mu = 0.8 (viscous dt), so they
take different step counts and the batched loop freezes the finished
lane while the other runs on."""

import dataclasses

import numpy as np
import pytest
import torch

from sph_poiseuille_flow_tpu.parallel import make_workloads as jmake_workloads
from sph_poiseuille_flow_tpu.parallel import run_sweep as jrun_sweep
from sph_poiseuille_flow_torch.models.poiseuille import build_scene
from sph_poiseuille_flow_torch.parallel import make_workloads, run_sweep
from sph_poiseuille_flow_torch.parallel.sweep import _lane_cfg
from sph_poiseuille_flow_torch.simulation import SimulationPaths
from sph_poiseuille_flow_torch.stepper import initial_state, make_engine
from sph_poiseuille_flow_torch.utils import postprocess as pp

from test_config import default_cfg
from test_torch_engine import port_cfg

torch.set_num_threads(1)

MUS = (0.1, 0.8)
FIELDS = ("x", "y", "vx", "vy", "rho", "p", "drho_dt", "fx", "fy", "fpx",
          "fpy", "vol", "b11", "b12", "b21", "b22")
F32_TOL = dict(rtol=1e-4, atol=1e-6)       # tests/test_parallel.py:60


def _jcfg(**kw):
    return default_cfg(DL=1.0, DH=0.5, dp=0.05, end_time=0.04,
                       output_interval=0.02, **kw)


def _cfg(**kw):
    return port_cfg(_jcfg(), **kw)


def _paths(d):
    return SimulationPaths(restart=str(d / "restart.npz"),
                           result_png=str(d / "r.png"),
                           profile_evolution_png=str(d / "p.png"),
                           postprocess_npz=str(d / "post.npz"))


def _quiet(_):
    pass


def _driven(d, cfg, **kw):
    """A sweep with per-lane files in ``d``, the handoff files as the run
    left them, and a second run under restart_from_file."""
    out, singles = _with_singles(cfg, paths=_paths(d), **kw)
    post = [pp.load_postprocess_npz(str(d / f"post_lane{k}.npz"))
            for k in range(len(MUS))]
    again = _sweep(dataclasses.replace(cfg, restart_from_file=True),
                   paths=_paths(d))
    return dict(out=out, singles=singles, post=post, again=again, dir=d,
                cfg=cfg)


def _single(cfg, g=None, mu=None):
    """One workload run alone to cfg.end_time on the CPU: (final state as
    numpy, steps)."""
    scene = build_scene(cfg)
    eng = make_engine(cfg, scene, "cpu")
    state, lay, geom, ovf = eng.init(initial_state(cfg, scene, "cpu"))
    assert not bool(ovf)
    f = np.dtype(cfg.dtype).type
    t, steps = 0.0, 0
    while t < cfg.end_time - 1e-9:
        target = min(t + cfg.output_interval, cfg.end_time)
        res = eng.run_interval(state, lay, geom, f(target - t), g, mu)
        assert not bool(res.overflow) and not res.skin_guard
        state, lay, geom = res.state, res.cands, res.geom
        steps += res.n_steps
        t = target
    return {n: getattr(state, n).numpy() for n in FIELDS}, steps


def _sweep(cfg, **kw):
    gs, mus = make_workloads(cfg, MUS)
    return run_sweep(cfg, gs, mus, log=_quiet, device="cpu", **kw)


def _with_singles(cfg, fused=False, **kw):
    """The sweep and each lane's single run: the fused engine's from the
    lane's own config, the per-step engines' with (g, mu) as arguments."""
    out = _sweep(cfg, **kw)
    gs, mus = make_workloads(cfg, MUS)
    singles = [_single(_lane_cfg(cfg, g, mu)) if fused
               else _single(cfg, float(g), float(mu))
               for g, mu in zip(gs, mus)]
    return out, singles


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    return _driven(tmp_path_factory.mktemp("fused"), _cfg(engine="pallas"),
                   fused=True)


@pytest.fixture(scope="module")
def cell32(tmp_path_factory):
    return _driven(tmp_path_factory.mktemp("cell32"),
                   _cfg(engine="cellgrid"))


# the float64 cellgrid and both gather sweeps (one with a skin and a
# rebuild cadence, so lanes rebuild on their own drift), each with one
# lane a chunk too
BATCHED = {
    "cellgrid-float64": dict(engine="cellgrid", dtype="float64"),
    "gather-float32": dict(engine="gather"),
    "gather-float64": dict(engine="gather", dtype="float64"),
    "gather-float64-skin": dict(engine="gather", dtype="float64",
                                neighbor_skin=0.3 * 0.05, rebuild_every=8),
}


@pytest.fixture(scope="module")
def batched():
    runs = {}
    for name, kw in BATCHED.items():
        cfg = _cfg(**kw)
        out, singles = _with_singles(cfg)
        runs[name] = dict(out=out, singles=singles, cfg=cfg,
                          chunk1=_sweep(cfg, lane_chunk=1))
    return runs


@pytest.fixture(scope="module")
def jax_cell():
    jcfg = _jcfg(engine="cellgrid")
    gs, mus = jmake_workloads(jcfg, MUS)
    return jrun_sweep(jcfg, gs, mus, log=_quiet)


@pytest.mark.parametrize("mus", [MUS, (0.05, 0.1, 0.3)])
def test_make_workloads_matches_jax(mus):
    gs, m = make_workloads(_cfg(), mus)
    jgs, jm = jmake_workloads(_jcfg(), mus)
    np.testing.assert_array_equal(gs, jgs)
    np.testing.assert_array_equal(m, jm)
    assert _lane_cfg(_cfg(), gs[-1], m[-1]).signature != _cfg().signature


@pytest.mark.parametrize("k", [0, 1])
def test_fused_lane_equals_single_run_bitwise(fused, k):
    """Lane k of the fused sweep equals a fresh single run of the lane's
    own config bit for bit: (g, mu) reach the kernels' plain twins at run
    time and no lane inherits another's state."""
    st = fused["out"]["final_states"]
    ref, steps = fused["singles"][k]
    for n in FIELDS:
        np.testing.assert_array_equal(getattr(st, n)[k], ref[n], err_msg=n)


def test_fused_lanes_take_their_own_steps(fused):
    steps = [s for _, s in fused["singles"]]
    assert steps[0] != steps[1]
    assert fused["out"]["total_lane_steps"] == sum(steps)
    assert fused["out"]["final_states"].x.shape == (2, build_scene(
        fused["cfg"]).n_total)


@pytest.mark.parametrize("k", [0, 1])
def test_cellgrid32_lane_matches_single_run(cell32, k):
    st = cell32["out"]["final_states"]
    ref, _ = cell32["singles"][k]
    for n in FIELDS:
        np.testing.assert_allclose(getattr(st, n)[k], ref[n], err_msg=n,
                                   **F32_TOL)
    assert cell32["out"]["total_lane_steps"] == sum(
        s for _, s in cell32["singles"])


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("name", list(BATCHED))
def test_batched_lane_matches_single_run(batched, name, k):
    """float64 lanes to 1e-10 of each field's scale, float32 at
    tests/test_parallel.py:60's tolerance."""
    run = batched[name]
    st = run["out"]["final_states"]
    ref, _ = run["singles"][k]
    assert run["out"]["total_lane_steps"] == sum(s for _, s in
                                                 run["singles"])
    for n in FIELDS:
        got = getattr(st, n)[k]
        assert got.dtype == np.dtype(run["cfg"].dtype)
        if run["cfg"].dtype == "float64":
            scale = max(1.0, float(np.abs(ref[n]).max()))
            assert float(np.abs(got - ref[n]).max()) <= 1e-10 * scale, n
        else:
            np.testing.assert_allclose(got, ref[n], err_msg=n, **F32_TOL)


@pytest.mark.parametrize("name", list(BATCHED))
def test_lane_chunk_one_equals_one_chunk(batched, name):
    run = batched[name]
    a, b = run["out"], run["chunk1"]
    assert a["total_lane_steps"] == b["total_lane_steps"]
    np.testing.assert_array_equal(a["l2_errors"], b["l2_errors"])
    for n in FIELDS:
        np.testing.assert_array_equal(getattr(a["final_states"], n),
                                      getattr(b["final_states"], n))


def test_cellgrid_sweep_matches_jax(cell32, jax_cell):
    """The port's batched cellgrid sweep against the JAX package's vmapped
    one on the same inputs: per-lane final vx at tests/test_parallel.py:60's
    tolerance and the same lane-steps."""
    out = cell32["out"]
    assert out["total_lane_steps"] == int(jax_cell["total_lane_steps"])
    for k in range(len(MUS)):
        np.testing.assert_allclose(out["final_states"].vx[k],
                                   np.asarray(jax_cell["final_states"].vx[k]),
                                   **F32_TOL)
    np.testing.assert_allclose(out["l2_errors"], jax_cell["l2_errors"],
                               rtol=1e-4, atol=1e-6)


def test_fused_sweep_matches_cellgrid_sweep(fused, cell32):
    """tests/test_parallel.py:63-80 in the port."""
    p, x = fused["out"], cell32["out"]
    assert p["total_lane_steps"] == x["total_lane_steps"]
    np.testing.assert_allclose(p["l2_errors"], x["l2_errors"], rtol=2e-2,
                               atol=2e-3)
    for k in range(len(MUS)):
        np.testing.assert_allclose(p["final_states"].vx[k],
                                   x["final_states"].vx[k], rtol=5e-3,
                                   atol=5e-4)


@pytest.mark.parametrize("path", ["fused", "cell32"])
def test_lane_driver_parity(request, path):
    """Each lane's restart and postprocess handoff (carrying the lane's
    nu and g, a monitor sample at t=0 and at both output points), and a
    second run under restart_from_file that takes no step and reproduces
    the final state exactly: the fields the restart carries and ``init``
    keeps (it recomputes rho, p, vol and B, as the JAX package's does)."""
    run = request.getfixturevalue(path)
    d, cfg = run["dir"], run["cfg"]
    gs, mus = make_workloads(cfg, MUS)
    assert run["out"]["lane_artifacts"] == [str(d / f"post_lane{k}.npz")
                                            for k in range(len(MUS))]
    for k, data in enumerate(run["post"]):
        assert (d / f"restart_lane{k}.npz").exists()
        assert float(data["cfg_nu"]) == pytest.approx(mus[k] / cfg.rho0)
        assert float(data["cfg_gravity_g"]) == pytest.approx(gs[k])
        assert data["mid_profile_u"].shape[1] == 3
    again = run["again"]
    assert again["total_lane_steps"] == 0
    for n in ("x", "y", "vx", "vy", "drho_dt", "fx", "fy", "fpx", "fpy"):
        np.testing.assert_array_equal(getattr(again["final_states"], n),
                                      getattr(run["out"]["final_states"], n))


def test_run_sweep_runs_on_the_card_by_default():
    """No device given: the sweep runs on the card, and without one it
    raises instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the CPU-only case is moot")
    cfg = _cfg(engine="gather")
    gs, mus = make_workloads(cfg, MUS)
    with pytest.raises((RuntimeError, AssertionError)):
        run_sweep(cfg, gs, mus, log=_quiet)
