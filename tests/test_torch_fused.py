"""The port's plain fused step, chunk and wall shear against the JAX
package's Pallas kernels, which run in interpret mode on the CPU, on the
tiny spec of tests/test_pallas.py:16 (with R=2 row groups, see
``tiny_case``) and its jittered state (:22-39). The
JAX side runs once, in a module-scoped fixture; every output core is a
case of its own. A float64 case holds the port's plain step against the
JAX package's XLA ``cellgrid.cell_step`` in particle order.

Tolerances. Port and JAX run the same float32 operations in the same order
per pair and differ only in the order of the 9K-term window sums (torch's
reduction against a Mosaic sublane sum), so one step agrees to a few ulp
of the largest term of a core: we hold each core to 2e-5 of its largest
magnitude (tests/test_pallas.py:56-78 allows 2e-4..2e-3 between two
different algorithms; this is the same algorithm). ``p`` is rho times
p0 = 225, so its bound is p0 times rho's. ``cnt`` counts pairs and must
match exactly in one step. Three chunk steps compound the rounding
through dt and the positions: 2e-4 of the scale, ``cnt`` within one pair.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sph_poiseuille_flow_tpu.models.poiseuille import build_scene
from sph_poiseuille_flow_tpu.ops import cellgrid as jcg
from sph_poiseuille_flow_tpu.ops import fused_cell as jfc
from sph_poiseuille_flow_tpu.ops import neighbors as jnb
from sph_poiseuille_flow_torch import interop
from sph_poiseuille_flow_torch.config import SPHConfig
from sph_poiseuille_flow_torch.ops import fused_cell as tfc
from sph_poiseuille_flow_torch.ops import neighbors as tnb

from test_config import default_cfg

torch.set_num_threads(1)

STEP_CORES = ("volH", "b11H", "b12H", "b21H", "b22H", "vxH", "vyH", "rhoP",
              "pP", "drP", "fxP", "fyP", "fpxP", "fpyP", "xP", "yP", "cnt")
CHUNK_STATE = ("xH", "yH", "vxH", "vyH", "drP", "xP", "yP")
CHUNK_AUX = ("volH", "b11H", "b12H", "b21H", "b22H", "rhoP", "pP", "drP",
             "fxP", "fyP", "fpxP", "fpyP", "cnt")
TOL_STEP = 2e-5
TOL_CHUNK = 2e-4
N_SUB = 3


def tiny_case(seed=7):
    """Config, scene and the jittered numpy state of tests/test_pallas.py.
    The row groups are forced to R=2 rows (the auto pick is R=5): interpret
    mode traces the kernels' staging once per row of a group, so this cuts
    the JAX side's trace and compile to under half, and it still holds
    groups of several rows (each bounded by the group's occupancy) and a
    padding row (9 rows in 5 groups)."""
    cfg = default_cfg(DL=1.0, DH=0.5, dp=0.05, end_time=0.5,
                      output_interval=0.25, plan_r=2)
    scene = build_scene(cfg)
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
    return cfg, scene, dict(x=x, y=y, vx=vx, vy=vy, drho_dt=dr)


def _scalars(cfg, transport_coeff):
    return (cfg.rho0, cfg.p0, cfg.c_f, cfg.inv_sigma0, transport_coeff,
            cfg.gravity_g, cfg.mu, cfg.wall_visc_factor)


@pytest.fixture(scope="module")
def case():
    """Both packages' outputs for the same inputs: the JAX Pallas kernels
    (interpret mode) once, the port's plain twins through the public entry
    points (CPU tensors)."""
    cfg, scene, st = tiny_case()
    f32 = {k: v.astype(np.float32) for k, v in st.items()}
    jspec = jnb.make_grid_spec(cfg, scene, lane_pack=True)
    tspec = tnb.make_grid_spec(SPHConfig(**dataclasses.asdict(cfg)), scene,
                               lane_pack=True)
    z = np.zeros(scene.n_total, np.float32)
    jl = jfc.build_fused_layout(jspec, f32["x"], f32["y"],
                                np.asarray(scene.mass, np.float32), z, z,
                                np.asarray(scene.y, np.float32))
    tl = interop.layout_from_numpy(
        {f: np.asarray(getattr(jl, f)) for f in jfc.FusedLayout._fields})

    def jcores():
        return (jfc.make_core(jspec, jl.pidx, f32["x"], fill=jfc._BIG_X,
                              xshift=jspec.DL),
                *(jfc.make_core(jspec, jl.pidx, f32[k])
                  for k in ("y", "vx", "vy")),
                jfc.make_plain(jspec, jl.pidx, f32["drho_dt"]))

    jc = jcores()
    tc = tuple(torch.tensor(np.asarray(a)) for a in jc)
    # the step's dt as the engines take it (verlet_dt over the fluid)
    nf = scene.n_fluid
    vmax = np.sqrt(np.max(f32["vx"][:nf] ** 2 + f32["vy"][:nf] ** 2))
    dt = np.float32(min(0.25 * cfg.h / (cfg.c_f + vmax),
                        0.125 * cfg.h ** 2 / cfg.nu))

    # one trace of the interpret-mode step serves both dt cases (tracing
    # the kernel is most of its cost; dt rides the kernel's params row)
    jstep = jax.jit(lambda lay, cores, dt: jfc.fused_step_cores(
        jspec, lay, *cores, dt, *_scalars(cfg, cfg.transport_coeff)))
    j0 = jstep(jl, jc, np.float32(0.0))
    j1 = jstep(jl, jc, dt)
    jch = jfc.fused_chunk_call(jspec, jl, *jc, 0.0, 0.0, 1.0, N_SUB,
                               *_scalars(cfg, cfg.transport_coeff))
    jsh_in = (jc[0], jc[1], j1["vxH"], j1["volH"], j1["b11H"], j1["b12H"],
              j1["b21H"], j1["b22H"], cfg.mu, cfg.wall_visc_factor)
    jsh = jfc.fused_wall_shear_cores(jspec, jl, *jsh_in)

    t0 = tfc.fused_step_cores(tspec, tl, *tc, 0.0,
                              *_scalars(cfg, cfg.transport_coeff))
    t1 = tfc.fused_step_cores(tspec, tl, *tc, float(dt),
                              *_scalars(cfg, cfg.transport_coeff))
    tch = tfc.fused_chunk_call(tspec, tl, *tc, 0.0, 0.0, 1.0, N_SUB,
                               *_scalars(cfg, cfg.transport_coeff))
    tsh_in = tuple(torch.tensor(np.asarray(a)) for a in jsh_in[:8]) \
        + jsh_in[8:]
    tsh = tfc.fused_wall_shear_cores(tspec, tl, *tsh_in)

    def host(d):
        return {k: np.asarray(v) for k, v in d.items()}

    return dict(
        cfg=cfg, specs=(jspec, tspec),
        step={"dt0": (host(j0), host({k: v.numpy() for k, v in t0.items()})),
              "dt": (host(j1), host({k: v.numpy() for k, v in t1.items()}))},
        chunk=(jch, tch), shear=(jsh, tsh))


def test_cores_run_the_full_geometry_cache(case):
    """The JAX side runs "auto", which is the full geometry cache on this
    grid; the port resolves the same, so every core test above holds the
    port's cached form against the JAX package's."""
    jspec, tspec = case["specs"]
    K = jspec.K
    assert jfc.cache_plan(jspec, jnp.float32) == ("full", K)
    assert tfc.step_form(tspec, torch.float32) == ("full", K)
    assert tfc.chunk_form(tspec, torch.float32) == ("full", K)


def _close(got, ref, tol, name, p0):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    # empty slots of the x cores sit at 1e9 and must pass through exactly
    parked = np.abs(ref) >= 1e8
    np.testing.assert_array_equal(got[parked], ref[parked], err_msg=name)
    got, ref = np.where(parked, 0.0, got), np.where(parked, 0.0, ref)
    if name == "cnt":
        bound = 0.0 if tol == TOL_STEP else 1.0
    elif name == "pP":
        bound = tol * p0
    else:
        bound = tol * max(1.0, np.max(np.abs(ref)))
    err = np.max(np.abs(got - ref))
    assert err <= bound, f"{name}: max abs error {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("dt_case", ["dt0", "dt"])
@pytest.mark.parametrize("name", STEP_CORES)
def test_step_core_matches_pallas(case, dt_case, name):
    j, t = case["step"][dt_case]
    _close(t[name], j[name], TOL_STEP, name, case["cfg"].p0)


@pytest.mark.parametrize("part,name",
                         [(0, k) for k in CHUNK_STATE]
                         + [(1, k) for k in CHUNK_AUX])
def test_chunk_core_matches_pallas(case, part, name):
    j, t = case["chunk"]
    _close(t[part][name].numpy(), np.asarray(j[part][name]), TOL_CHUNK,
           name, case["cfg"].p0)


def test_chunk_clock_matches_pallas(case):
    (_, _, jsteps, jt, jtc), (_, _, tsteps, tt, ttc) = case["chunk"]
    assert int(tsteps) == int(jsteps) == N_SUB
    assert float(tt) == pytest.approx(float(jt), rel=1e-6)
    assert abs(float(ttc) - float(jtc)) <= 1e-6 * float(jt)


def test_chunk_leaves_inputs_intact():
    """The chunk copies its inputs into the working state: the rollback
    of the interval loop needs the pre-chunk cores."""
    cfg, scene, st = tiny_case(seed=3)
    spec = tnb.make_grid_spec(SPHConfig(**dataclasses.asdict(cfg)), scene,
                              lane_pack=True)
    t = {k: torch.tensor(v, dtype=torch.float32) for k, v in st.items()}
    zeros = torch.zeros(scene.n_total)
    lay = tfc.build_fused_layout(spec, t["x"], t["y"],
                                 torch.tensor(scene.mass, dtype=torch.float32),
                                 zeros, zeros,
                                 torch.tensor(scene.y, dtype=torch.float32))
    cores = (tfc.make_core(spec, lay.pidx, t["x"], fill=tfc._BIG_X,
                           xshift=spec.DL),
             *(tfc.make_core(spec, lay.pidx, t[k]) for k in ("y", "vx", "vy")),
             tfc.make_plain(spec, lay.pidx, t["drho_dt"]))
    before = [c.clone() for c in cores]
    st2, _, steps, _, _ = tfc.fused_chunk_call(
        spec, lay, *cores, 0.0, 0.0, 1.0, 2, *_scalars(cfg, 0.3))
    assert int(steps) == 2
    for a, b in zip(cores, before):
        assert torch.equal(a, b)
    assert not torch.equal(st2["xP"], cores[0][1:-1, :, 1:-1])


def test_chunk_stops_at_the_interval_end():
    """steps < n_sub once the clock reaches the interval: the remainder
    clamp lands t exactly on it (Kahan clock)."""
    cfg, scene, st = tiny_case(seed=4)
    spec = tnb.make_grid_spec(SPHConfig(**dataclasses.asdict(cfg)), scene,
                              lane_pack=True)
    t = {k: torch.tensor(v, dtype=torch.float32) for k, v in st.items()}
    zeros = torch.zeros(scene.n_total)
    lay = tfc.build_fused_layout(spec, t["x"], t["y"],
                                 torch.tensor(scene.mass, dtype=torch.float32),
                                 zeros, zeros,
                                 torch.tensor(scene.y, dtype=torch.float32))
    cores = (tfc.make_core(spec, lay.pidx, t["x"], fill=tfc._BIG_X,
                           xshift=spec.DL),
             *(tfc.make_core(spec, lay.pidx, t[k]) for k in ("y", "vx", "vy")),
             tfc.make_plain(spec, lay.pidx, t["drho_dt"]))
    interval = np.float32(2.5e-3)
    _, _, steps, tt, _ = tfc.fused_chunk_call(
        spec, lay, *cores, 0.0, 0.0, interval, 16, *_scalars(cfg, 0.3))
    assert 1 < int(steps) < 16
    assert float(tt) == float(interval)


@pytest.mark.parametrize("wall", [0, 1])
def test_wall_shear_matches_pallas(case, wall):
    j, t = case["shear"]
    assert float(t[wall]) == pytest.approx(float(j[wall]), rel=TOL_STEP,
                                           abs=1e-7)


def test_kernel_path_refuses_other_devices(case):
    """A tensor that is neither on the CPU nor on a CUDA card is refused:
    the entry points never pick a path other than the kernel (CUDA) or its
    plain twin (CPU)."""
    cfg = case["cfg"]
    scene = build_scene(cfg)
    spec = tnb.make_grid_spec(SPHConfig(**dataclasses.asdict(cfg)), scene,
                              lane_pack=True)
    meta = torch.empty((3, 16, 9), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfc.fused_step_cores(spec, None, meta, meta, meta, meta, meta, 0.0,
                             *_scalars(cfg, 0.0))


def test_kernel_build_needs_nvcc(monkeypatch):
    """Without the CUDA toolkit the build raises; it never falls back."""
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(fcc.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fcc.build()


@pytest.mark.parametrize("form,k_cut", [("bogus", 0), ("partial", 0),
                                        ("full", 99)])
def test_kernel_forms_refuse_what_they_cannot_serve(case, form, k_cut):
    """A form the kernels do not have, or a cache that cannot cover its
    ranks, raises before anything is built or launched: no form gives way
    to another."""
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc
    spec = case["specs"][1]
    with pytest.raises(ValueError, match="form"):
        fcc.step(spec, 2, None, None, None, None, None, None, 0.0,
                 (0.0,) * 8, form, k_cut)


def test_f64_step_matches_cellgrid():
    """float64: the port's plain fused_cell_step against the JAX package's
    XLA cellgrid.cell_step (Pallas compiles f32 only), in particle order,
    to 1e-9 of each field's largest magnitude. x64 is enabled for this
    test alone."""
    cfg, scene, st = tiny_case(seed=9)
    n = scene.n_total
    dt = 1e-3
    sc = _scalars(cfg, cfg.transport_coeff)
    with jax.enable_x64(True):
        spec = jnb.make_grid_spec(cfg, scene)
        f64 = {k: jnp.asarray(v, jnp.float64) for k, v in st.items()}
        mass = jnp.asarray(scene.mass, jnp.float64)
        z = jnp.zeros(n, jnp.float64)
        lay = jcg.build_layout(spec, f64["x"], f64["y"], mass, z, z,
                               jnp.asarray(scene.y, jnp.float64))
        # one jit of the whole step: far cheaper than its eager ops
        step = jax.jit(lambda lay, x, y, vx, vy, dr: jcg.cell_step(
            spec, lay, jcg.compute_geometry(spec, lay, x, y), mass, x, y,
            vx, vy, dr, jnp.asarray(dt, jnp.float64), *sc))
        ref = step(lay, f64["x"], f64["y"], f64["vx"], f64["vy"],
                   f64["drho_dt"])
        ref = {k: np.asarray(v) for k, v in ref.items()}
    tspec = tnb.make_grid_spec(SPHConfig(**dataclasses.asdict(cfg)), scene,
                               lane_pack=True)
    t = {k: torch.tensor(v, dtype=torch.float64) for k, v in st.items()}
    tmass = torch.tensor(scene.mass, dtype=torch.float64)
    tz = torch.zeros(n, dtype=torch.float64)
    tlay = tfc.build_fused_layout(tspec, t["x"], t["y"], tmass, tz, tz,
                                  torch.tensor(scene.y, dtype=torch.float64))
    got = tfc.fused_cell_step(tspec, tlay, t["x"], t["y"], t["vx"], t["vy"],
                              t["drho_dt"], dt, *sc)
    for k, r in ref.items():
        g = got[k].numpy()
        assert g.dtype == np.float64, k
        np.testing.assert_allclose(
            g, r, rtol=0, atol=1e-9 * max(1.0, np.max(np.abs(r))),
            err_msg=k)
