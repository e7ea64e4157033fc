"""The PyTorch port's framework-free layer against the JAX package: config
derivation, scene, grid spec and row-group plan, restart files in both
directions, and the postprocess L2 on one handoff file."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import sph_poiseuille_flow_tpu.config as jcfg
import sph_poiseuille_flow_tpu.models.poiseuille as jscene
import sph_poiseuille_flow_tpu.ops.fused_cell as jfc
import sph_poiseuille_flow_tpu.ops.neighbors as jnb
import sph_poiseuille_flow_tpu.utils.checkpoint as jck
import sph_poiseuille_flow_tpu.utils.postprocess as jpp
import sph_poiseuille_flow_torch.config as tcfg
import sph_poiseuille_flow_torch.models.poiseuille as tscene
import sph_poiseuille_flow_torch.ops.fused_cell as tfc
import sph_poiseuille_flow_torch.ops.neighbors as tnb
import sph_poiseuille_flow_torch.utils.checkpoint as tck
import sph_poiseuille_flow_torch.utils.postprocess as tpp
from sph_poiseuille_flow_torch import interop
from sph_poiseuille_flow_torch.stepper import State

BASE = dict(DL=3.0, DH=1.0, dp=0.05, rho0=1.0, mu=0.1, U_bulk=0.666667,
            c_f=15.0, end_time=20.0, output_interval=1.0, sort_interval=100,
            restart_from_file=False)

# the shipped preset, the test box of tests/test_pallas.py, its shipping-
# pick box, and the three lane-packed grids of docs/SCALING.md
CONFIGS = {
    "preset": {},
    "tiny": dict(DL=1.0, DH=0.5, end_time=0.5, output_interval=0.25),
    "tiny_shipping": dict(DL=1.2, DH=0.5, neighbor_skin=0.015,
                          cell_capacity=14, rebuild_every=32),
    "dp0025": dict(dp=0.025, neighbor_skin=0.3 * 0.025, rebuild_every=128,
                   cell_capacity=14, lane_pack_nx=40),
    "dp001": dict(dp=0.01, neighbor_skin=0.3 * 0.01, rebuild_every=128,
                  cell_capacity=14, lane_pack_nx=100),
    "dp0005": dict(dp=0.005, neighbor_skin=0.3 * 0.005, rebuild_every=128,
                   cell_capacity=14, lane_pack_nx=200),
}


def _cfgs(name):
    kw = dict(BASE, **CONFIGS[name])
    return jcfg.derive_config(**kw), tcfg.derive_config(**kw)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_derive_config_field_for_field(name):
    jc, tc = _cfgs(name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.signature == jc.signature
    assert tc.tau_target == jc.tau_target and tc.n_bins == jc.n_bins


@pytest.mark.parametrize("name", ["preset", "tiny", "tiny_shipping"])
def test_build_scene_equal_arrays(name):
    jc, tc = _cfgs(name)
    js, ts = jscene.build_scene(jc), tscene.build_scene(tc)
    assert (ts.n_fluid, ts.n_wall) == (js.n_fluid, js.n_wall)
    for f in ("x", "y", "mass", "wall_normal", "wall_measure",
              "wall_thickness_arr"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f),
                                      err_msg=f)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_grid_spec_and_plan_equal(name):
    jc, tc = _cfgs(name)
    scene = jscene.build_scene(jc)
    jspec = jnb.make_grid_spec(jc, scene, lane_pack=True)
    tspec = tnb.make_grid_spec(tc, scene, lane_pack=True)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert tfc.plan(tspec) == jfc.plan(jspec)


def test_dp001_grid_is_the_published_shape():
    """The validated dp=0.01 channel: 32,400 particles on a 100 x 39 cell
    grid, K=14, halo'd core 41 x 14 x 102 (docs/VALIDATION.md)."""
    _, tc = _cfgs("dp001")
    scene = tscene.build_scene(tc)
    spec = tnb.make_grid_spec(tc, scene, lane_pack=True)
    R, L, n_groups, nyp = tfc.plan(spec)
    assert scene.n_total == 32400
    assert (spec.nx, spec.ny, spec.K, R) == (100, 39, 14, 1)
    assert (nyp + 2, spec.K, spec.nx + 2) == (41, 14, 102)


def _random_state(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {f: rng.normal(0, 1, n).astype(dtype) for f in State._fields}


def test_restart_jax_to_port(tmp_path):
    jc, tc = _cfgs("tiny")
    n = jscene.build_scene(jc).n_total
    arrays = _random_state(n, 1)
    path = str(tmp_path / "restart.npz")
    jck.save_restart(path, jc.signature, type("S", (), arrays), 0.75, 42)
    payload, reason = tck.load_restart(path, tc.signature, n)
    assert reason == "ok"
    assert payload["t"] == 0.75 and payload["step"] == 42
    st = interop.state_from_numpy(payload, base=interop.state_from_numpy(
        arrays))
    for f in ("x", "y", "vx", "vy", "rho", "p", "drho_dt", "fx", "fy",
              "fpx", "fpy"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), arrays[f])


def test_restart_port_to_jax(tmp_path):
    jc, tc = _cfgs("tiny")
    n = jscene.build_scene(jc).n_total
    arrays = _random_state(n, 2)
    st = interop.state_from_numpy(arrays)
    path = str(tmp_path / "restart.npz")
    tck.save_restart(path, tc.signature, st, 1.5, 7)
    payload, reason = jck.load_restart(path, jc.signature, n)
    assert reason == "ok"
    assert payload["t"] == 1.5 and payload["step"] == 7
    for f in ("x", "vx", "drho_dt", "fpy"):
        assert payload[f].dtype == np.float32
        np.testing.assert_array_equal(payload[f], arrays[f])


def test_restart_signature_guard_crosses(tmp_path):
    jc, _ = _cfgs("tiny")
    _, tc_other = _cfgs("preset")
    n = jscene.build_scene(jc).n_total
    path = str(tmp_path / "restart.npz")
    jck.save_restart(path, jc.signature, type("S", (), _random_state(n, 3)),
                     0.5, 1)
    payload, reason = tck.load_restart(path, tc_other.signature, n)
    assert payload is None and reason == "restart signature mismatch"


@pytest.fixture(scope="module")
def handoff(tmp_path_factory):
    """One postprocess handoff npz written by the JAX package from a
    developed-looking noisy profile."""
    jc, _ = _cfgs("tiny")
    scene = jscene.build_scene(jc)
    rng = np.random.default_rng(5)
    nf = scene.n_fluid
    y = scene.y.copy()
    vx = np.zeros(scene.n_total)
    # each particle carries the analytic speed at its bin's centre, so the
    # binned L2 is the noise alone
    n_bins = jc.n_bins
    ib = np.clip(np.floor(y[:nf] / jc.DH * n_bins), 0, n_bins - 1)
    vx[:nf] = (jc.analytic_u((ib + 0.5) / n_bins * jc.DH)
               * (1 + rng.normal(0, 0.02, nf)))
    state = type("S", (), dict(x=scene.x, y=y, vx=vx,
                               vy=rng.normal(0, 1e-3, scene.n_total)))
    times = np.linspace(0.0, 0.5, 3)
    prof = np.stack([jc.analytic_u((np.arange(n_bins) + 0.5) / n_bins
                                   * jc.DH) * (1 + 0.01 * k)
                     for k in range(3)], axis=1)
    d = tmp_path_factory.mktemp("handoff")
    data = jpp.make_postprocess_data(jc, scene, state, times, prof,
                                     str(d / "r.png"), str(d / "p.png"),
                                     full_profile_u=prof)
    path = str(d / "post.npz")
    jpp.save_postprocess_npz(path, data)
    return path


def test_postprocess_l2_same(handoff):
    dj = jpp.load_postprocess_npz(handoff)
    dt = tpp.load_postprocess_npz(handoff)
    lj = jpp.compute_l2_error(*jpp.get_final_profile(dj)[1:])
    lt = tpp.compute_l2_error(*tpp.get_final_profile(dt)[1:])
    assert lt == lj and 0.0 < lt < 0.05
    assert tpp.time_averaged_l2(dt) == jpp.time_averaged_l2(dj)
    assert tpp.edge_seam_metrics(dt) == jpp.edge_seam_metrics(dj)


def test_postprocess_without_matplotlib_keeps_the_verdict(handoff,
                                                          monkeypatch,
                                                          capsys):
    """No matplotlib: the verdict still prints and returns; one line says
    the figures were skipped."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    res = tpp.run_postprocess(tpp.load_postprocess_npz(handoff))
    out = capsys.readouterr().out
    assert "L2 relative error" in out
    assert "figures skipped: matplotlib is not installed" in out
    assert res["passed"] is True or res["passed"] == np.True_


def test_make_postprocess_data_takes_tensors():
    jc, tc = _cfgs("tiny")
    scene = tscene.build_scene(tc)
    rng = np.random.default_rng(9)
    arrays = {f: rng.normal(0, 1, scene.n_total) for f in ("x", "y", "vx",
                                                            "vy")}
    st_np = type("S", (), arrays)
    st_t = type("S", (), {k: torch.as_tensor(v) for k, v in arrays.items()})
    args = (np.zeros(1), np.zeros((tc.n_bins, 1)), "r.png", "p.png")
    dj = jpp.make_postprocess_data(jc, scene, st_np, *args)
    dt = tpp.make_postprocess_data(tc, scene, st_t, *args)
    for k in ("fluid_x", "fluid_y", "fluid_u", "fluid_v", "u_mean"):
        np.testing.assert_array_equal(dt[k], dj[k], err_msg=k)


def test_config_module_is_a_copy():
    """config.py and models/poiseuille.py are numpy-only copies: the
    parsing rules must not drift apart (tests/test_torch_cli.py checks
    that the package imports no jax)."""
    text = "[physical]\nDL = 3.0 # c\n[simulation]\nend_time = 2 ; c\n"
    assert tcfg.parse_ini_text(text) == jcfg.parse_ini_text(text)
    for mod in (tcfg, tscene):
        src = open(mod.__file__).read()
        assert "import jax" not in src and "import torch" not in src


def test_cubic_spline_matches():
    """ops/kernels.py: W and dW/dr across both branches and the support
    edge, float32 (the same formulas in the same order)."""
    import sph_poiseuille_flow_tpu.ops.kernels as jk
    import sph_poiseuille_flow_torch.ops.kernels as tk
    h = 0.065
    r = np.linspace(0.0, 2.2 * h, 97).astype(np.float32)
    jw, jdw = jk.cubic_spline(r, h)
    tw, tdw = tk.cubic_spline(torch.tensor(r), h)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6 * float(np.max(np.abs(jw))))
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), rtol=1e-6,
                               atol=1e-6 * float(np.max(np.abs(jdw))))
    assert tk.sigma_2d(h) == jk.sigma_2d(h) and tk.w0(h) == jk.w0(h)
