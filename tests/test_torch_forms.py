"""The fused kernels' forms in the port against the JAX package: the
layout-knob resolution (geometry cache "none"/"full"/"ring"/"partial",
the candidate-row-outer "rows" loop, and the single step's downgrade), the
forms held against each other inside the port
(tests/test_pallas.py:179-248), the row-outer step and the per-step log
path against JAX ``PallasCellEngine`` (interpret mode), and the log-line
schema of tests/test_e2e.py:193-225.

Tolerances. The forms against each other use the JAX test's bounds: "ring"
is "full" (one cache form here), "none" and "partial" differ from "full"
only in the association of sweep 1's rf, rtol 1e-5 and atol 5e-5. The
per-step path against JAX runs the same float32 operations per pair in
another summation order (the JAX rows form walks (dy, k, dx), the port
(dy, dx, k)) over three steps: 2e-5 of each logged value's scale for a
step, 2e-4 of each field's scale for the state after three steps (the
chunk bound of tests/test_torch_fused.py), the pair count and the step
numbers exact.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sph_poiseuille_flow_tpu.config import derive_config
from sph_poiseuille_flow_tpu.models.poiseuille import build_scene
from sph_poiseuille_flow_tpu.ops import fused_cell as jfc
from sph_poiseuille_flow_tpu.ops import neighbors as jnb
from sph_poiseuille_flow_tpu.stepper import PallasCellEngine as JEngine
from sph_poiseuille_flow_tpu.stepper import initial_state as jinitial_state
from sph_poiseuille_flow_torch import interop
from sph_poiseuille_flow_torch.config import SPHConfig
from sph_poiseuille_flow_torch.ops import fused_cell as tfc
from sph_poiseuille_flow_torch.ops import neighbors as tnb
from sph_poiseuille_flow_torch.simulation import Simulation, SimulationPaths
from sph_poiseuille_flow_torch.stepper import PallasCellEngine, initial_state

from test_config import default_cfg

torch.set_num_threads(1)


def port_cfg(cfg, **kw):
    return dataclasses.replace(SPHConfig(**dataclasses.asdict(cfg)), **kw)


# ---------------------------------------------------------------------------
# form resolution: arithmetic only, no kernel runs
# ---------------------------------------------------------------------------

def _grid_cfg(dp):
    """config.ini's grid (CLI defaults) at dp=0.05; the shipping knobs of
    tests/test_pallas.py:290-328 at the finer grids."""
    if dp == 0.05:
        return default_cfg()
    return derive_config(
        DL=3.0, DH=1.0, dp=dp, rho0=1.0, mu=0.1, U_bulk=0.666667, c_f=15.0,
        end_time=20.0, output_interval=0.5, sort_interval=100,
        restart_from_file=False, engine="pallas", neighbor_skin=0.3 * dp,
        rebuild_every=128, cell_capacity=14, lane_pack_nx=round(1.0 / dp),
        neighbor_capacity=56)


_SCENES = {}


def _specs(dp, **knobs):
    cfg = dataclasses.replace(_grid_cfg(dp), **knobs)
    if dp not in _SCENES:
        _SCENES[dp] = build_scene(cfg)
    scene = _SCENES[dp]
    return (jnb.make_grid_spec(cfg, scene, lane_pack=True),
            tnb.make_grid_spec(port_cfg(cfg), scene, lane_pack=True))


def _jax_forms(spec):
    """(chunk form, step form) as JAX fused_chunk_call (:1724-1725) and
    _fused_call (:1482-1501) resolve them."""
    f32 = jnp.float32
    rows = jfc.use_rows(spec, f32)
    cm, kc = ("none", 0) if rows else jfc.cache_plan(spec, f32)
    chunk = ("rows", 0) if rows else (cm, kc)
    if (cm in ("ring", "partial")
            and jfc._cache_bytes(spec, f32, jfc._RING_DEPTH,
                                 kc if cm == "partial" else None)
            > (jfc._RING_CACHE_BUDGET if cm == "ring"
               else jfc._PARTIAL_CACHE_BUDGET)):
        cm, kc = ("full", spec.K) if jfc.use_geom_cache(spec, f32) \
            else ("none", 0)
    return chunk, (("rows", 0) if rows else (cm, kc))


KNOBS = [
    pytest.param({}, {}, id="auto"),
    pytest.param(dict(geom_cache="none"), {}, id="none"),
    pytest.param(dict(geom_cache="full"), {}, id="full"),
    pytest.param(dict(geom_cache="ring"), {}, id="ring"),
    pytest.param(dict(geom_cache="partial"), {}, id="partial"),
    pytest.param(dict(geom_cache="partial", geom_kcut=5), {},
                 id="partial-kcut5"),
    pytest.param(dict(fused_rows="1"), {}, id="rows"),
    pytest.param(dict(fused_rows="0", geom_cache="ring"), {}, id="rows0"),
    pytest.param(dict(geom_cache="full"), dict(SPH_GEOM_CACHE="none"),
                 id="env-none"),
    pytest.param({}, dict(SPH_GEOM_CACHE="partial", SPH_GEOM_KCUT="6",
                          SPH_FUSED_UNROLL="4"), id="env-partial-unroll4"),
    pytest.param({}, dict(SPH_FUSED_ROWS="1"), id="env-rows"),
]


@pytest.mark.parametrize("knobs,env", KNOBS)
@pytest.mark.parametrize("dp", [0.05, 0.025, 0.01, 0.005])
def test_form_resolution_matches_jax(monkeypatch, dp, knobs, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jspec, tspec = _specs(dp, **knobs)
    assert tfc.plan(tspec) == jfc.plan(jspec)
    assert tfc.cache_plan(tspec, torch.float32) == \
        jfc.cache_plan(jspec, jnp.float32)
    assert tfc.cache_mode(tspec, torch.float32) == \
        jfc.cache_mode(jspec, jnp.float32)
    assert tfc.use_rows(tspec, torch.float32) == \
        jfc.use_rows(jspec, jnp.float32)
    chunk, step = _jax_forms(jspec)
    assert tfc.chunk_form(tspec, torch.float32) == chunk
    assert tfc.step_form(tspec, torch.float32) == step


# ---------------------------------------------------------------------------
# the forms against each other inside the port (plain twins on the CPU)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def form_runs():
    """tests/test_pallas.py:179-248 in the port: the tall domain (6+ row
    groups), one 0.005 s interval and one single step per form."""
    base = port_cfg(default_cfg(DL=1.0, DH=5.0, dp=0.05, end_time=0.2,
                                output_interval=0.1, engine="pallas",
                                rebuild_every=8))
    scene = build_scene(base)
    out = {}
    for mode in ("full", "ring", "none", "partial"):
        cfg = dataclasses.replace(base, geom_cache=mode)
        eng = PallasCellEngine(cfg, scene, "cpu")
        s, lay, g, _ = eng.init(initial_state(cfg, scene, "cpu"))
        r = eng.run_interval(s, lay, g, np.float32(0.005))
        o = eng.step(s, lay, 0, 1.0)
        out[mode] = (eng, r, o)
    return out


def test_forms_resolve_as_asked(form_runs):
    eng = form_runs["partial"][0]
    assert tfc.plan(eng.spec)[2] > tfc._RING_DEPTH
    kc = tfc.chunk_form(eng.spec, torch.float32)[1]
    assert 2 <= kc < eng.spec.K
    for mode in ("full", "ring", "none"):
        assert tfc.chunk_form(form_runs[mode][0].spec,
                              torch.float32)[0] == mode


@pytest.mark.parametrize("mode", ["ring", "none", "partial"])
def test_forms_agree_with_full(form_runs, mode):
    _, r_full, o_full = form_runs["full"]
    _, r, o = form_runs[mode]
    assert r.n_steps == r_full.n_steps
    assert int(r.n_pairs) == int(r_full.n_pairs)

    def cmp(a, b, msg):
        a, b = a.numpy(), b.numpy()
        if mode == "ring":
            np.testing.assert_array_equal(a, b, err_msg=msg)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=5e-5,
                                       err_msg=msg)

    for name in r_full.state._fields:
        cmp(getattr(r.state, name), getattr(r_full.state, name), name)
        cmp(getattr(o[0], name), getattr(o_full[0], name), f"step {name}")
    cmp(r.tau_bottom, r_full.tau_bottom, "tau_bottom")


def test_cache_association_is_in_effect(form_runs):
    """The cached sweep 1 associates rf differently (:743-762): the cached
    and recompute steps are close but not identical."""
    o_full, o_none = form_runs["full"][2][0], form_runs["none"][2][0]
    assert any(not torch.equal(getattr(o_full, f), getattr(o_none, f))
               for f in ("b11", "b12", "b21", "b22"))


# ---------------------------------------------------------------------------
# the per-step path with the row-outer step and the step log, against JAX
# ---------------------------------------------------------------------------

T_BASE, STEP_BASE = np.float32(0.1), 20


@pytest.fixture(scope="module")
def step_log_runs():
    """JAX PallasCellEngine (rows form, interpret mode, R=2 row groups) and
    the port over the same three logged steps from the same jittered state
    (tests/test_pallas.py:22-39). The rebuild cadence min(4, 8) rebuilds
    after the first step and not after the next two, with the absolute
    displacement guard on (skin 0.75dp). JAX's init is skipped: both start
    from a layout built from the same positions and geom 0."""
    cfg = default_cfg(DL=1.0, DH=0.5, dp=0.05, end_time=0.5,
                      output_interval=0.25, plan_r=2, fused_rows="1",
                      step_log_every=1, neighbor_skin=0.75 * 0.05,
                      rebuild_every=4, cell_capacity=24)
    scene = build_scene(cfg)
    rng = np.random.default_rng(7)
    nf, n = scene.n_fluid, scene.n_total
    x = np.asarray(scene.x, np.float64).copy()
    y = np.asarray(scene.y, np.float64).copy()
    x[:nf] = np.mod(x[:nf] + rng.uniform(-0.35, 0.35, nf) * cfg.dp, cfg.DL)
    y[:nf] += rng.uniform(-0.35, 0.35, nf) * cfg.dp
    arrays = dict(x=x, y=y, vx=np.zeros(n), vy=np.zeros(n),
                  drho_dt=np.zeros(n))
    arrays["vx"][:nf] = rng.normal(0, 0.4, nf)
    arrays["vy"][:nf] = rng.normal(0, 0.1, nf)
    arrays["drho_dt"][:nf] = rng.normal(0, 0.05, nf)
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    interval = np.float32(0.003)

    jeng = JEngine(cfg, scene)
    assert jfc.use_rows(jeng.spec, jnp.float32) and jfc.plan(jeng.spec)[0] == 2
    js = jinitial_state(cfg, scene)._replace(
        **{k: jnp.asarray(v) for k, v in arrays.items()})
    z = jnp.zeros(n, jnp.float32)
    jl = jfc.build_fused_layout(jeng.spec, js.x, js.y,
                                jnp.asarray(scene.mass, jnp.float32), z, z,
                                jnp.asarray(scene.y, jnp.float32))
    jr = jeng.run_interval(js, jl, jnp.int32(0), interval, t_base=T_BASE,
                           step_base=np.int32(STEP_BASE))

    teng = PallasCellEngine(port_cfg(cfg), scene, "cpu")
    assert tfc.chunk_form(teng.spec, torch.float32) == ("rows", 0)
    ts = interop.state_from_numpy(
        arrays, base=initial_state(teng.cfg, scene, "cpu"))
    tl = teng._rebuild(ts.x, ts.y)
    tr = teng.run_interval(ts, tl, 0, interval, t_base=T_BASE,
                           step_base=STEP_BASE)
    return cfg, jr, tr


def test_step_log_counts_match_jax(step_log_runs):
    _, jr, tr = step_log_runs
    assert tr.n_steps == int(jr.n_steps) == 3
    assert tr.step_log_n == int(jr.step_log_n) == 3
    assert not bool(tr.overflow) and not bool(jr.overflow)
    assert tr.skin_guard == bool(jr.skin_guard) is False
    assert tr.n_syncs == tr.n_steps + 1


@pytest.mark.parametrize("col,name", [(0, "step"), (1, "t"), (2, "dt"),
                                      (3, "pairs"), (4, "v_max"),
                                      (5, "tau_bottom"), (6, "tau_top")])
def test_step_log_rows_match_jax(step_log_runs, col, name):
    _, jr, tr = step_log_runs
    n = tr.step_log_n
    got = np.asarray(tr.step_log[:n, col], np.float64)
    ref = np.asarray(jr.step_log[:n, col], np.float64)
    if name == "step":
        np.testing.assert_array_equal(got, STEP_BASE + np.arange(1, n + 1))
    if name in ("step", "pairs"):
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=2e-5 * max(1.0, np.max(np.abs(ref))))


@pytest.mark.parametrize("name", ["x", "y", "vx", "vy", "rho", "p",
                                  "drho_dt", "vol", "b11", "b22"])
def test_step_path_state_matches_jax(step_log_runs, name):
    cfg, jr, tr = step_log_runs
    ref = np.asarray(getattr(jr.state, name), np.float64)
    got = getattr(tr.state, name).numpy().astype(np.float64)
    scale = cfg.p0 if name == "p" else max(1.0, np.max(np.abs(ref)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4 * scale)


def test_step_log_line_schema(tmp_path):
    """tests/test_e2e.py:193-225 in the port: the reference's per-step log
    schema (SPH_Poiseuille.m:285-291) with global step numbers, drained
    per interval, each row followed by its tau line."""
    cfg = port_cfg(default_cfg(DL=1.0, DH=0.5, dp=0.05, end_time=0.03,
                               output_interval=0.015, step_log_every=5))
    paths = SimulationPaths(
        restart=str(tmp_path / "restart.npz"),
        result_png=str(tmp_path / "result.png"),
        profile_evolution_png=str(tmp_path / "evolution.png"),
        postprocess_npz=str(tmp_path / "post.npz"))
    lines = []
    result = Simulation(cfg, paths, log=lines.append, device="cpu").run()
    pat = re.compile(
        r"step=(\d+), t=(\d+\.\d{6})/(\d+\.\d{6}), dt=(\d\.\d{4}e[+-]\d+), "
        r"pairs=(\d+), vmax=(\d+\.\d{4})$")
    rows = [pat.match(ln) for ln in lines if pat.match(ln)]
    assert len(rows) >= 2, lines
    steps = [int(m.group(1)) for m in rows]
    assert all(s % 5 == 0 for s in steps)
    assert steps == sorted(set(steps))
    assert steps[-1] > int(result["step"]) - 5 * 2
    for i, ln in enumerate(lines):
        if pat.match(ln):
            assert lines[i + 1].startswith(
                "  [thick-wall-noslip] tau_bot="), lines[i + 1]
