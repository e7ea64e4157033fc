"""The port's packed-gather engine (``stepper.Engine`` over
``ops/neighbors.py``, ``density.py``, ``viscosity.py``, ``transport.py``,
``integration.py`` and ``monitors.py``; plain torch on the CPU) against
the JAX package's ``Engine`` and its operators, and against
tests/oracle_numpy.py.

* Candidates on the jittered tiny box of tests/test_ops.py:28-66: every
  index and mask equal to the JAX package's exactly (the compaction keeps
  its column order), the geometry within a few ulp.
* Operators, fed the JAX candidate set through
  ``interop.candidates_from_numpy``: against the JAX operator in float32
  (within 1e-5 of each output's largest magnitude; both add the same
  float32 terms, in another order), and against the float64 oracle at
  tests/test_ops.py's tolerances, in float32 and float64.
* The engine against JAX ``Engine``: init and one step from rest
  (tests/test_cellgrid.py:34-69's tolerances) and from a jittered state
  (:83-117's), float64 init and step to 1e-10, a 0.05 s interval from
  rest with the same step and pair counts and v_max and tau within
  :128-134's tolerances; inside the port against ``CellEngine``; split
  dispatch bit-equal to one call; the engine names and the CLI.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import oracle_numpy as oracle
from jax_ops_helpers import take_j
from sph_poiseuille_flow_tpu.models.poiseuille import build_scene
from sph_poiseuille_flow_tpu.ops import density as jden
from sph_poiseuille_flow_tpu.ops import integration as jint
from sph_poiseuille_flow_tpu.ops import monitors as jmon
from sph_poiseuille_flow_tpu.ops import neighbors as jnb
from sph_poiseuille_flow_tpu.ops.transport import (
    transport_correction as jtransport)
from sph_poiseuille_flow_tpu.ops.viscosity import viscous_force as jviscous
from sph_poiseuille_flow_tpu.stepper import Engine as JEngine
from sph_poiseuille_flow_tpu.stepper import initial_state as jinitial_state
from sph_poiseuille_flow_torch import interop
from sph_poiseuille_flow_torch import run as cli
from sph_poiseuille_flow_torch.ops import density as tden
from sph_poiseuille_flow_torch.ops import integration as tint
from sph_poiseuille_flow_torch.ops import monitors as tmon
from sph_poiseuille_flow_torch.ops import neighbors as tnb
from sph_poiseuille_flow_torch.ops.transport import transport_correction
from sph_poiseuille_flow_torch.ops.viscosity import viscous_force
from sph_poiseuille_flow_torch.stepper import (CellEngine, Engine,
                                               initial_state, make_engine,
                                               resolve_engine_name)

from test_config import default_cfg
from test_torch_cellgrid import STEP_FIELDS
from test_torch_engine import jittered, port_cfg

torch.set_num_threads(1)

F32 = np.float32
CAND_FIELDS = ("jsafe", "cvalid", "is_fluid_j", "mass_j", "wvx_j", "wvy_j",
               "wall_bot", "wall_top", "overflow")
GEOM_FIELDS = ("dx", "dy", "r", "ex", "ey", "w", "dw", "mask_f", "mask_w",
               "x_j", "y_j", "vol_j")
INIT_FIELDS = ("rho", "p", "vol", "b11", "b12", "b21", "b22")


# ---------------------------------------------------------------- operators

@pytest.fixture(scope="module")
def ops():
    """The jittered tiny box of tests/test_ops.py:28-66 (walls, velocities,
    drho, prior forces; float32-exact inputs), its JAX candidates and
    geometry, the oracle's pair list and density pass."""
    cfg = default_cfg(DL=1.0, DH=0.5, dp=0.05, end_time=1.0)
    scene = build_scene(cfg)
    rng = np.random.default_rng(42)
    nf, n = scene.n_fluid, scene.n_total
    x = scene.x.copy()
    y = scene.y.copy()
    x[:nf] += rng.uniform(-0.3, 0.3, nf) * cfg.dp
    y[:nf] += rng.uniform(-0.3, 0.3, nf) * cfg.dp
    x[:nf] = np.mod(x[:nf], cfg.DL)
    x = np.asarray(x, F32).astype(np.float64)
    y = np.asarray(y, F32).astype(np.float64)
    vel = np.zeros((n, 2))
    vel[:nf] = rng.normal(0, 0.3, (nf, 2))
    vel = np.asarray(vel, F32).astype(np.float64)
    drho = np.zeros(n)
    drho[:nf] = rng.normal(0, 0.05, nf)
    drho = np.asarray(drho, F32).astype(np.float64)
    fprior = np.zeros((n, 2))
    fprior[:nf] = rng.normal(0, 0.01, (nf, 2))
    fprior = np.asarray(fprior, F32).astype(np.float64)

    pairs = oracle.build_pairs(x, y, nf, cfg.DL, cfg.h)
    # tests/jax_ops_helpers.build_cands_geom, jitted (eager, its first
    # call compiles each op on its own: ~5 s)
    spec = jnb.make_grid_spec(cfg, scene)
    mass32 = np.asarray(scene.mass, F32)
    z = np.zeros(n, F32)
    jc = jax.jit(jnb.build_candidates, static_argnums=0)(
        spec, x.astype(F32), y.astype(F32), mass32, z, z)
    jg = jax.jit(jnb.compute_geometry, static_argnums=0)(
        spec, jc, x.astype(F32), y.astype(F32), mass32)
    assert not bool(jc.overflow)
    rho_o, vol_o, B_o = oracle.density_correction(
        pairs, scene.mass, nf, n, cfg.rho0, cfg.h, cfg.inv_sigma0)
    return dict(cfg=cfg, scene=scene, spec=spec, jc=jc, jg=jg, x=x, y=y,
                vel=vel, drho=drho, fprior=fprior, pairs=pairs, rho_o=rho_o,
                vol_o=vol_o, B_o=B_o)


def _port(s, dtype):
    """The port's view of ``ops``: the JAX candidate set carried across,
    its geometry, and a converter of numpy arrays to ``dtype`` tensors."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype)
    cands = interop.candidates_from_numpy(
        {k: np.asarray(v) for k, v in s["jc"]._asdict().items()},
        dtype=dtype)
    return cands, t


def _scale(ref):
    return max(1.0, float(np.max(np.abs(ref))))


def _near_jax(got, ref, name, tol=1e-5):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * _scale(ref),
                               err_msg=name)


def test_build_candidates_equal_jax(ops):
    """Every index and mask of the candidate set equals the JAX package's
    exactly: the same bins, cutoff test and stable compaction."""
    s = ops
    cfg, scene = s["cfg"], s["scene"]
    spec = tnb.make_grid_spec(cfg, scene)
    assert spec == tnb.GridSpec(**vars(s["spec"]))
    z = torch.zeros(scene.n_total)
    tc = tnb.build_candidates(
        spec, torch.tensor(s["x"], dtype=torch.float32),
        torch.tensor(s["y"], dtype=torch.float32),
        torch.tensor(scene.mass, dtype=torch.float32), z, z)
    for name in CAND_FIELDS:
        j = np.asarray(getattr(s["jc"], name))
        t = getattr(tc, name).numpy()
        assert t.shape == j.shape, name
        np.testing.assert_array_equal(t, j, err_msg=name)
    assert tc.jsafe.dtype == torch.int64
    assert tc.cvalid.dtype == torch.float32


@pytest.mark.parametrize("name", GEOM_FIELDS)
def test_compute_geometry_matches_jax(ops, name):
    """The geometry over the same candidates: the masks exactly, the rest
    within 1e-6 of each field's scale (sqrt and division round alike)."""
    s = ops
    cands, t = _port(s, torch.float32)
    vol = np.asarray(s["scene"].mass, F32)
    tg = tnb.compute_geometry(s["spec"], cands, t(s["x"]), t(s["y"]), t(vol))
    j = np.asarray(getattr(s["jg"], name))
    got = getattr(tg, name).numpy()
    if name.startswith("mask"):
        np.testing.assert_array_equal(got, j)
    else:
        _near_jax(got, j, name, tol=1e-6)


def _jax_and_port(s, dtype):
    """Every operator of the gather engine on ``ops``' state, through the
    JAX package (float32) and through the port (``dtype``). Returns
    {operator: (jax outputs, port outputs)} as numpy."""
    cfg, scene, spec = s["cfg"], s["scene"], s["spec"]
    jc, jg = s["jc"], s["jg"]
    cands, t = _port(s, dtype)
    nf = scene.n_fluid
    mass32 = np.asarray(scene.mass, F32)
    b32 = tuple(s["B_o"][:, k].astype(F32) for k in range(4))
    vx32, vy32 = (s["vel"][:, k].astype(F32) for k in range(2))
    vol32 = s["vol_o"].astype(F32)
    fpx32, fpy32 = (s["fprior"][:, k].astype(F32) for k in range(2))
    rho32 = s["rho_o"].astype(F32)
    dt = np.float32(1e-3)
    tg = tnb.compute_geometry(spec, cands, t(s["x"]), t(s["y"]),
                              t(s["vol_o"]))
    jg = jg._replace(vol_j=take_j(jc, vol32)[0])
    T = {k: t(v) for k, v in dict(
        mass=mass32, vx=vx32, vy=vy32, vol=vol32, fpx=fpx32, fpy=fpy32,
        rho=rho32, drho=s["drho"], b11=b32[0], b12=b32[1], b21=b32[2],
        b22=b32[3]).items()}
    if dtype == torch.float64:
        # the oracle's own float64 inputs, not their float32 roundings
        T.update(mass=t(scene.mass), vx=t(s["vel"][:, 0]),
                 vy=t(s["vel"][:, 1]), vol=t(s["vol_o"]),
                 fpx=t(s["fprior"][:, 0]), fpy=t(s["fprior"][:, 1]),
                 rho=t(s["rho_o"]), **{f"b{k}": t(s["B_o"][:, i]) for i, k
                                       in enumerate((11, 12, 21, 22))})
    bT = tuple(T[f"b{k}"] for k in (11, 12, 21, 22))
    out = {}

    rho, vol = jden.density_sums(spec, s["jg"], jc, mass32, cfg.rho0,
                                 cfg.inv_sigma0)
    b = jden.kernel_gradient_correction(spec, s["jg"],
                                        take_j(jc, np.asarray(vol))[0])
    tgeom0 = tnb.compute_geometry(spec, cands, t(s["x"]), t(s["y"]),
                                  T["mass"])
    trho, tvol = tden.density_sums(spec, tgeom0, cands, T["mass"], cfg.rho0,
                                   cfg.inv_sigma0)
    (tvol_j,) = tnb.gather_pack(cands.jsafe, (tvol,))
    tb = tden.kernel_gradient_correction(spec, tgeom0, tvol_j)
    out["density"] = ((rho, vol) + tuple(b), (trho, tvol) + tuple(tb))

    jj = take_j(jc, vol32, *b32, vx32, vy32)
    tj = tnb.gather_pack(cands.jsafe, (T["vol"],) + bT + (T["vx"], T["vy"]))
    out["viscous"] = (
        jviscous(spec, jg, jc, vx32, vy32, vol32, *b32, *jj, cfg.mu, cfg.h),
        viscous_force(spec, tg, cands, T["vx"], T["vy"], T["vol"], *bT, *tj,
                      cfg.mu, cfg.h))
    x32, y32 = s["x"].astype(F32), s["y"].astype(F32)
    out["transport"] = (
        jtransport(spec, jg, x32, y32, *b32, *jj[:5], cfg.h,
                   cfg.transport_coeff),
        transport_correction(spec, tg, t(s["x"]), t(s["y"]), *bT, *tj[:5],
                             cfg.h, cfg.transport_coeff))

    rh, ph = jint.half_kick_eos(spec, rho32, s["drho"].astype(F32), dt,
                                cfg.rho0, cfg.p0)
    trh, tph = tint.half_kick_eos(spec, T["rho"], T["drho"],
                                  torch.tensor(dt, dtype=dtype), cfg.rho0,
                                  cfg.p0)
    out["half_kick_eos"] = ((rh, ph), (trh, tph))
    jrj, jpj = take_j(jc, np.asarray(rh), np.asarray(ph))
    trj, tpj = tnb.gather_pack(cands.jsafe, (trh, tph))
    out["pressure"] = (
        jint.pressure_force(spec, jg, jc, rh, ph, mass32, vx32, vy32, fpx32,
                            fpy32, vol32, *b32, *jj, jrj, jpj, cfg.rho0,
                            cfg.c_f),
        tint.pressure_force(spec, tg, cands, trh, tph, T["mass"], T["vx"],
                            T["vy"], T["fpx"], T["fpy"], T["vol"], *bT, *tj,
                            trj, tpj, cfg.rho0, cfg.c_f))
    jvx2, jvy2 = (np.asarray(v) for v in jj[5:7])
    out["continuity"] = (
        (jint.continuity_rate(spec, jg, jc, rh, vx32, vy32, jj[0], jvx2,
                              jvy2),),
        (tint.continuity_rate(spec, tg, cands, trh, T["vx"], T["vy"], tj[0],
                              tj[5], tj[6]),))
    out["wall_shear"] = (
        jmon.wall_shear(spec, jg, jc, vx32, vol32, *b32, cfg.DL, cfg.mu,
                        cfg.h),
        tmon.wall_shear(spec, tg, cands, T["vx"], T["vol"], *bT, cfg.DL,
                        cfg.mu, cfg.h))
    out["verlet_step"] = (
        jint.verlet_step(spec, s["jg"], jc, vol32, *b32, rho32, mass32,
                         x32, y32, vx32, vy32, s["drho"].astype(F32), fpx32,
                         fpy32, dt, cfg.rho0, cfg.p0, cfg.c_f),
        tint.verlet_step(spec, tgeom0, cands, T["vol"], *bT, T["rho"],
                         T["mass"], t(s["x"]), t(s["y"]), T["vx"], T["vy"],
                         T["drho"], T["fpx"], T["fpy"],
                         torch.tensor(dt, dtype=dtype), cfg.rho0, cfg.p0,
                         cfg.c_f))
    return {k: (tuple(np.asarray(a) for a in j),
                tuple(a.numpy() for a in p)) for k, (j, p) in out.items()}


@pytest.fixture(scope="module")
def op_outputs(ops):
    return {torch.float32: _jax_and_port(ops, torch.float32),
            torch.float64: _jax_and_port(ops, torch.float64)}


OPERATORS = ("density", "viscous", "transport", "half_kick_eos", "pressure",
             "continuity", "wall_shear", "verlet_step")


@pytest.mark.parametrize("op", OPERATORS)
def test_operator_matches_jax_f32(op_outputs, op):
    """float32, the same candidates and inputs: each output within 1e-5 of
    its largest magnitude (the row sums add the same float32 terms in
    another order). ``p`` is p0 = 225 times rho's rounding, so it is held
    in rho's units."""
    j, t = op_outputs[torch.float32][op]
    assert len(j) == len(t)
    for k, (a, b) in enumerate(zip(j, t)):
        assert b.dtype == np.float32 and b.shape == a.shape, (op, k)
        scale = 225.0 if (op, k) in (("half_kick_eos", 1),
                                     ("verlet_step", 1)) else 1.0
        _near_jax(b / scale, a / scale, f"{op}[{k}]")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", ["density", "viscous", "transport",
                                "verlet_step", "wall_shear"])
def test_operator_matches_oracle(ops, op_outputs, op, dtype):
    """Against the independent float64 store-once oracle, at
    tests/test_ops.py's tolerances."""
    s = ops
    cfg, scene = s["cfg"], s["scene"]
    nf, n = scene.n_fluid, scene.n_total
    wall_vel = np.zeros((n, 2))
    pos = np.stack([s["x"], s["y"]], axis=1)
    got = op_outputs[dtype][op][1]
    if op == "density":
        rho, vol, *b = got
        np.testing.assert_allclose(rho, s["rho_o"], rtol=2e-5)
        np.testing.assert_allclose(vol, s["vol_o"], rtol=2e-5)
        np.testing.assert_allclose(np.stack(b, axis=1), s["B_o"],
                                   rtol=5e-3, atol=2e-4)
    elif op == "viscous":
        f_o = oracle.viscous_force(s["pairs"], s["vel"], s["vol_o"],
                                   s["B_o"], cfg.mu, cfg.h, nf, n, wall_vel)
        for k in range(2):
            np.testing.assert_allclose(got[k], f_o[:, k], rtol=1e-3,
                                       atol=5e-7)
    elif op == "transport":
        pos_o = oracle.transport_correction(
            s["pairs"], s["vol_o"], s["B_o"], pos, cfg.h, nf, n,
            cfg.transport_coeff)
        for k in range(2):
            np.testing.assert_allclose(got[k], pos_o[:, k], rtol=1e-5,
                                       atol=2e-6)
    elif op == "verlet_step":
        rho2, p2, pos2, vel2, drho2, force = oracle.integration_verlet(
            s["pairs"], s["vol_o"], s["B_o"], s["rho_o"], scene.mass, pos,
            s["vel"], s["drho"], s["fprior"], 1e-3, nf, n, cfg.rho0, cfg.p0,
            cfg.c_f, wall_vel)
        rho, p, x, y, vx, vy, drho, fx, fy = got
        np.testing.assert_allclose(rho, rho2, rtol=1e-5)
        np.testing.assert_allclose(p, p2, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(x, pos2[:, 0], atol=2e-6)
        np.testing.assert_allclose(y, pos2[:, 1], atol=2e-6)
        for a, b, tol in ((vx, vel2[:, 0], 1e-5), (vy, vel2[:, 1], 1e-5),
                          (drho, drho2, 1e-4), (fx, force[:, 0], 1e-5),
                          (fy, force[:, 1], 1e-5)):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=tol)
    else:
        tb_o, tt_o = oracle.wall_shear_monitor(
            s["pairs"], pos, s["vel"], wall_vel, s["vol_o"], s["B_o"], nf,
            cfg.DL, cfg.DH, cfg.mu, cfg.h)
        assert float(got[0]) == pytest.approx(tb_o, rel=1e-3, abs=1e-6)
        assert float(got[1]) == pytest.approx(tt_o, rel=1e-3, abs=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stage_operators_match_oracle(ops, op_outputs, dtype):
    """The Verlet step's parts on their own: the half-kick EOS, the
    stage-1 pressure pass (force and Riemann dissipation rate) against the
    oracle's integration_first, and the continuity rate against its
    integration_second on the same velocities, at tests/test_ops.py's
    verlet tolerances."""
    s = ops
    cfg, scene = s["cfg"], s["scene"]
    nf, n = scene.n_fluid, scene.n_total
    pos = np.stack([s["x"], s["y"]], axis=1)
    rho1, p1, _, force, drho_diss = oracle.integration_first(
        s["pairs"], s["vol_o"], s["B_o"], s["rho_o"], scene.mass, pos,
        s["vel"], s["drho"], s["fprior"], 1e-3, nf, n, cfg.rho0, cfg.p0,
        cfg.c_f)
    _, rate = oracle.integration_second(s["pairs"], s["vol_o"], rho1, pos,
                                        s["vel"], 1e-3, nf, n,
                                        np.zeros((n, 2)))
    got = op_outputs[dtype]
    (rh, ph), (fx, fy, diss) = got["half_kick_eos"][1], got["pressure"][1]
    np.testing.assert_allclose(rh, rho1, rtol=1e-5)
    np.testing.assert_allclose(ph, p1, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(fx, force[:, 0], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(fy, force[:, 1], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(diss, drho_diss, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got["continuity"][1][0], rate, rtol=1e-3,
                               atol=1e-4)


def test_profile_monitors_match_jax(ops):
    """binned_profile_mean and mid_channel_profile: the same bins, the
    same means within float32 rounding, NaN in the same empty bins."""
    s = ops
    cfg, scene = s["cfg"], s["scene"]
    spec = s["spec"]
    x32, y32 = s["x"].astype(F32), s["y"].astype(F32)
    vx32 = s["vel"][:, 0].astype(F32)
    args = (cfg.DL, cfg.DH, 0.5 * cfg.DL, 2.0 * cfg.dp, 40)
    jy, ju = jmon.mid_channel_profile(spec, x32, y32, vx32, *args)
    ty, tu = tmon.mid_channel_profile(spec, torch.tensor(x32),
                                      torch.tensor(y32), torch.tensor(vx32),
                                      *args)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6)
    assert np.array_equal(np.isnan(tu.numpy()), np.isnan(np.asarray(ju)))
    assert np.isnan(np.asarray(ju)).any() and np.isfinite(
        np.asarray(ju)).any()
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5,
                               atol=1e-7)


def test_guards_and_pair_count(ops):
    """displacement_exceeded is the half-skin test against the rebuild's
    positions; count_pairs is the JAX package's count."""
    s = ops
    cands, t = _port(s, torch.float32)
    tg = tnb.compute_geometry(s["spec"], cands, t(s["x"]), t(s["y"]),
                              t(s["vol_o"]))
    assert int(tnb.count_pairs(tg)) == int(jnb.count_pairs(s["jg"]))
    spec = dataclasses.replace(tnb.GridSpec(**vars(s["spec"])), skin=0.01)
    x = t(s["x"])
    x[0] += 0.0049
    assert not bool(tnb.displacement_exceeded(spec, cands, x, t(s["y"])))
    x[0] += 0.0002
    assert bool(tnb.displacement_exceeded(spec, cands, x, t(s["y"])))
    spec0 = dataclasses.replace(spec, skin=0.0)
    assert not bool(tnb.displacement_exceeded(spec0, cands, x, t(s["y"])))


# ------------------------------------------------------------------- engine

def _tiny(dtype="float32"):
    cfg = default_cfg(DL=1.0, DH=0.5, dp=0.05, end_time=0.5,
                      output_interval=0.25, dtype=dtype)
    return cfg, build_scene(cfg)


def _host(out):
    st = out[0]
    return ({n: np.asarray(getattr(st, n)) for n in st._fields},
            float(out[3]), float(out[6]), float(out[7]))


@pytest.fixture(scope="module")
def jax_engines():
    """One JAX ``Engine`` and its jitted step per dtype for the module, so
    each compiles once."""
    engines = {}

    def get(cfg, scene):
        if cfg.dtype not in engines:
            eng = JEngine(cfg, scene)
            engines[cfg.dtype] = (eng, jax.jit(eng.step))
        return engines[cfg.dtype]
    return get


def _run_both(jax_engine, dtype, jitter, interval=None):
    """init and one step (and a 0.05 s interval when ``interval``) of JAX
    ``Engine`` and the port's, from the same state: at rest, or jittered
    with velocities and drho (tests/test_pallas.py:22-39)."""
    cfg, scene = _tiny(dtype)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    arrays = jittered(cfg, scene) if jitter else {}
    out = {}
    with jax.enable_x64(dtype == "float64"):
        jeng, jstep_fn = jax_engine(cfg, scene)
        js0 = jinitial_state(cfg, scene)._replace(
            **{k: jnp.asarray(v, jdt) for k, v in arrays.items()})
        js, jc, jg, jov = jeng.init(js0)
        jinit = {n: np.asarray(getattr(js, n)) for n in INIT_FIELDS}
        jstep = _host(jstep_fn(js, jc, jg, 0, 1.0))
        if interval:
            jr = jeng.run_interval(js, jc, jg, np.dtype(dtype).type(interval))
            out["jint"] = (int(jr.n_steps), int(jr.n_pairs), float(jr.v_max),
                           float(jr.tau_bottom), float(jr.tau_top),
                           bool(jov) or bool(jr.overflow))
    teng = Engine(port_cfg(cfg), scene, "cpu")
    ts0 = interop.state_from_numpy(
        arrays, dtype=getattr(torch, dtype),
        base=initial_state(teng.cfg, scene, "cpu"))
    ts, tc, tg, tov = teng.init(ts0)
    tinit = {n: getattr(ts, n).numpy() for n in INIT_FIELDS}
    tstep = _host(teng.step(ts, tc, tg, remain=1.0))
    if interval:
        tr = teng.run_interval(ts, tc, tg, np.dtype(dtype).type(interval))
        out["tint"] = (tr.n_steps, int(tr.n_pairs), float(tr.v_max),
                       float(tr.tau_bottom), float(tr.tau_top),
                       bool(tov) or bool(tr.overflow))
    out.update(init=(jinit, tinit), step=(jstep, tstep))
    return out


@pytest.fixture(scope="module")
def rest32(jax_engines):
    return _run_both(jax_engines, "float32", False, 0.05)


@pytest.fixture(scope="module")
def jit32(jax_engines):
    return _run_both(jax_engines, "float32", True, 0.05)


@pytest.fixture(scope="module")
def jit64(jax_engines):
    return _run_both(jax_engines, "float64", True)


# tests/test_cellgrid.py:34-46 (init) and :53-62 (step) from rest;
# :97-117 jittered
INIT_TOL = {"rest": ({"p": (5e-3, 2e-4)}, (5e-5, 1e-5)),
            "jittered": ({"p": (5e-3, 5e-4)}, (2e-4, 2e-5))}
STEP_TOL = {"rest": ({"p": (5e-3, 5e-4)}, (2e-4, 2e-5)),
            "jittered": ({"p": (1e-2, 2.5e-2), "drho_dt": (5e-3, 5e-3)},
                         (2e-3, 5e-4))}


@pytest.mark.parametrize("case", ["rest", "jittered"])
@pytest.mark.parametrize("name", INIT_FIELDS)
def test_init_matches_jax_engine(rest32, jit32, case, name):
    j, t = (rest32 if case == "rest" else jit32)["init"]
    special, default = INIT_TOL[case]
    rtol, atol = special.get(name, default)
    assert t[name].dtype == np.float32
    np.testing.assert_allclose(t[name], j[name], rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", ["rest", "jittered"])
@pytest.mark.parametrize("name", STEP_FIELDS)
def test_step_matches_jax_engine(rest32, jit32, case, name):
    (j, *_), (t, *_) = (rest32 if case == "rest" else jit32)["step"]
    special, default = STEP_TOL[case]
    rtol, atol = special.get(name, default)
    np.testing.assert_allclose(t[name], j[name], rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", ["rest", "jittered"])
def test_step_dt_and_shear_match_jax_engine(rest32, jit32, case):
    """dt to 1e-6 and the wall shear to 1e-3 (tests/test_cellgrid.py:55,
    :64-69)."""
    (_, jdt, jtb, jtt), (_, tdt, ttb, ttt) = (
        rest32 if case == "rest" else jit32)["step"]
    assert tdt == pytest.approx(jdt, rel=1e-6)
    assert ttb == pytest.approx(jtb, rel=1e-3, abs=1e-6)
    assert ttt == pytest.approx(jtt, rel=1e-3, abs=1e-6)


@pytest.mark.parametrize("part", ["init", "step"])
def test_matches_jax_engine_f64(jit64, part):
    """float64, jittered: every field within 1e-10 of its largest
    magnitude, dt and the wall shear within 1e-10 relative."""
    j, t = jit64[part]
    if part == "step":
        (j, *js), (t, *ts) = j, t
        np.testing.assert_allclose(ts, js, rtol=1e-10, atol=1e-14)
    for name, r in j.items():
        assert t[name].dtype == np.float64, name
        np.testing.assert_allclose(
            t[name], r, rtol=0, atol=1e-10 * max(1.0, np.max(np.abs(r))),
            err_msg=name)


def test_interval_matches_jax_engine(rest32):
    """0.05 s from rest: the same n_steps and n_pairs, no overflow, v_max
    within 1e-3 and tau within 2e-3 relative (tests/test_cellgrid.py:
    128-134)."""
    j, t = rest32["jint"], rest32["tint"]
    assert t[0] == j[0] and t[0] > 10
    assert t[1] == j[1]
    assert not j[5] and not t[5]
    assert t[2] == pytest.approx(j[2], rel=1e-3)
    for a, b in zip(t[3:5], j[3:5]):
        assert a == pytest.approx(b, rel=2e-3, abs=1e-5)


def test_interval_matches_jax_engine_jittered(jit32):
    """0.05 s from the jittered state, same tolerances on v_max and tau.
    The step count may differ by one: the Kahan clock of either package
    can end one ulp short of the output point after dt's last bits
    differ, and then takes one more remainder step a few ns long (on this
    state the port's clock ends at 0.04999999702 and adds a 3.7e-9 s
    step; the JAX package's ends at 0.05)."""
    j, t = jit32["jint"], jit32["tint"]
    assert abs(t[0] - j[0]) <= 1 and t[0] > 10
    assert not j[5] and not t[5]
    assert t[2] == pytest.approx(j[2], rel=1e-3)
    for a, b in zip(t[3:5], j[3:5]):
        assert a == pytest.approx(b, rel=2e-3, abs=1e-5)


def test_step_matches_port_cellengine():
    """Inside the port: one jittered step of ``Engine`` against
    ``CellEngine`` (tests/test_cellgrid.py:77-117's check and
    tolerances)."""
    cfg, scene = _tiny()
    cfg = port_cfg(cfg)
    arrays = jittered(cfg, scene)
    outs = []
    for kind in (Engine, CellEngine):
        eng = kind(cfg, scene, "cpu")
        s0 = interop.state_from_numpy(arrays,
                                      base=initial_state(cfg, scene, "cpu"))
        s, lay, geom, ovf = eng.init(s0)
        assert not bool(ovf)
        outs.append(eng.step(s, lay, geom, remain=1.0))
    special, default = STEP_TOL["jittered"]
    for name in STEP_FIELDS:
        rtol, atol = special.get(name, default)
        np.testing.assert_allclose(getattr(outs[1][0], name).numpy(),
                                   getattr(outs[0][0], name).numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)
    assert float(outs[1][3]) == pytest.approx(float(outs[0][3]), rel=1e-6)
    for k in (6, 7):
        assert float(outs[1][k]) == pytest.approx(float(outs[0][k]),
                                                  rel=1e-3, abs=1e-6)


def test_split_dispatch_is_bit_equal():
    """Step-bounded calls that carry the Kahan clock and ``steps_done0``
    reproduce one call bit for bit (tests/test_split_dispatch.py:68),
    with a skin, so the rebuild cadence matters."""
    cfg, scene = _tiny()
    cfg = port_cfg(cfg, neighbor_skin=0.01, rebuild_every=4)
    eng = Engine(cfg, scene, "cpu")
    s0 = interop.state_from_numpy(jittered(cfg, scene),
                                  base=initial_state(cfg, scene, "cpu"))
    s, cands, geom, _ = eng.init(s0)
    il = np.float32(0.02)
    once = eng.run_interval(s, cands, geom, il)
    t_loc = t_cmp = np.float32(0.0)
    done = 0
    while t_loc < il:
        r = eng.run_interval(s, cands, geom, il, max_steps=3,
                             t_local0=t_loc, t_comp0=t_cmp,
                             steps_done0=done, sub_len0=5)
        s, cands, geom = r.state, r.cands, r.geom
        t_loc, t_cmp = r.t_local, r.t_comp
        done += r.n_steps
    assert done == once.n_steps > 6
    for name in s._fields:
        assert torch.equal(getattr(s, name), getattr(once.state, name)), name
    assert float(r.tau_bottom) == float(once.tau_bottom)
    assert float(r.tau_top) == float(once.tau_top)


def test_step_log_rows():
    """step_log_every > 0: a row every 3 steps, numbered from
    ``step_base``; the last row's tau is the interval's when it falls on
    the last step."""
    cfg, scene = _tiny()
    cfg = port_cfg(cfg, engine="gather", step_log_every=3)
    eng = make_engine(cfg, scene, "cpu")
    s, c, g, _ = eng.init(initial_state(cfg, scene, "cpu"))
    r = eng.run_interval(s, c, g, np.float32(0.01), step_base=30)
    assert r.step_log_n == r.n_steps // 3 and r.n_steps >= 6
    np.testing.assert_array_equal(r.step_log[:r.step_log_n, 0],
                                  30 + 3 * np.arange(1, r.step_log_n + 1))
    assert (r.step_log[:r.step_log_n, 3] > 0).all()
    if r.n_steps % 3 == 0:
        assert r.step_log[r.step_log_n - 1, 5] == np.float32(r.tau_bottom)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_make_engine_gives_the_gather_engine(dtype):
    cfg = port_cfg(default_cfg(), engine="gather", dtype=dtype)
    assert resolve_engine_name(cfg) == "gather"
    eng = make_engine(cfg, build_scene(cfg), "cpu")
    assert type(eng) is Engine
    assert eng.cfg.engine == "gather" and eng.dtype == getattr(torch, dtype)
    # the gather engine's grid is the JAX Engine's (no lane pack)
    assert eng.spec.nx == int(np.floor(cfg.DL / (2 * cfg.h)))


def test_cli_engine_gather(tmp_path, capsys):
    """``--engine gather --device cpu`` runs tests/data/quick.ini, cut to
    0.1 s, to its L2 line and writes its restart file."""
    ini = os.path.join(os.path.dirname(__file__), "data", "quick.ini")
    rc = cli.main(["--config", ini, "--base-dir", str(tmp_path), "--device",
                   "cpu", "--engine", "gather", "--set",
                   "simulation.end_time=0.1"])
    out = capsys.readouterr().out
    assert rc in (0, 1)
    assert "L2 relative error" in out and "output point: t=0.100000" in out
    with np.load(tmp_path / "restart.npz") as z:
        assert np.isfinite(z["vx"]).all() and z["vx"].dtype == np.float32
