"""The port's probe kernels against the JAX package's Pallas calls, which
run in interpret mode on the CPU: the fused step cut to a sweep range as
experiments/profile_r3.py:115-127 launches it, the no-op of
profile_r3.py:170-185 and the one-hot expand of
tests/test_pallas.py:155-172; and the probe entry point
(``python -m sph_poiseuille_flow_torch.probe``) on the CPU.

Tolerances: the sweep range is the step's own arithmetic, so its cores
are held as tests/test_torch_fused.py holds the step's (2e-5 of each
core's largest magnitude, the pair count exact). Inside the port the plain
prefixes are the plain step's operations in the same order, so they are
held bit for bit, and so are the no-op (a copy) and the expand (one
product by 1.0 and sums of zeros per element).
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sph_poiseuille_flow_tpu import derive_config as jax_derive_config
from sph_poiseuille_flow_tpu.models.poiseuille import build_scene
from sph_poiseuille_flow_tpu.ops import cellgrid as jcg
from sph_poiseuille_flow_tpu.ops import fused_cell as jfc
from sph_poiseuille_flow_tpu.ops import neighbors as jnb
from sph_poiseuille_flow_torch import interop, probe
from sph_poiseuille_flow_torch.config import SPHConfig
from sph_poiseuille_flow_torch.ops import fused_cell as tfc
from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc
from sph_poiseuille_flow_torch.ops import neighbors as tnb
from sph_poiseuille_flow_torch.ops import probes

from test_torch_fused import _scalars, tiny_case

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5


@pytest.fixture(scope="module")
def case():
    """The tiny jittered case (R=2) in both packages' layouts."""
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
    jc = (jfc.make_core(jspec, jl.pidx, f32["x"], fill=jfc._BIG_X,
                        xshift=jspec.DL),
          *(jfc.make_core(jspec, jl.pidx, f32[k]) for k in ("y", "vx", "vy")),
          jfc.make_plain(jspec, jl.pidx, f32["drho_dt"]))
    tc = tuple(torch.tensor(np.asarray(a)) for a in jc)
    return dict(cfg=cfg, jspec=jspec, tspec=tspec, jl=jl, tl=tl, jc=jc,
                tc=tc, dt=np.float32(1e-3))


def _pallas_probe(case, kernel, grid, n_out=jfc._N_OUT):
    """A pallas_call over the step's buffers, built as
    experiments/profile_r3.py:99-127 builds it, in interpret mode."""
    spec, jl, cfg = case["jspec"], case["jl"], case["cfg"]
    R, L, n_groups, nyp = jfc.plan(spec)
    nx, K, dtype = spec.nx, spec.K, jnp.float32
    halo, plain = (nyp + 2, K, nx + 2), (nyp, K, nx)
    out_shape = ([jax.ShapeDtypeStruct(halo, dtype)] * jfc._HALO_OUT
                 + [jax.ShapeDtypeStruct(plain, dtype)] * jfc._PLAIN_OUT
                 + [jax.ShapeDtypeStruct((n_groups, L), dtype)])
    scratch = ([pltpu.VMEM((9 * K, L), dtype) for _ in range(jfc._N_SCR_FULL)]
               + [pltpu.VMEM((K, L), dtype) for _ in range(jfc._N_ACC)]
               + [pltpu.VMEM((K, L), dtype) for _ in range(jfc._N_ASIDE)]
               + [pltpu.VMEM(halo, dtype), pltpu.VMEM(halo, dtype),
                  pltpu.VMEM(plain, dtype), pltpu.VMEM(plain, dtype)])
    params = jnp.asarray([[case["dt"], cfg.gravity_g, cfg.mu,
                           cfg.wall_visc_factor]], dtype)
    call = pl.pallas_call(
        kernel, grid=grid,
        in_specs=([pl.BlockSpec(memory_space=pltpu.VMEM)] * 9
                  + [pl.BlockSpec(memory_space=pltpu.SMEM)] * 2),
        out_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * n_out,
        out_shape=out_shape, scratch_shapes=scratch, interpret=True)
    outs = call(*case["jc"], jl.isf_c, jl.mass_c, jl.wvx_c, jl.wvy_c,
                jl.occ, params)
    names = ("volH", "b11H", "b12H", "b21H", "b22H", "vxH", "vyH", "rhoP",
             "pP", "drP", "fxP", "fyP", "fpxP", "fpyP", "xP", "yP", "cnt")
    return {k: np.asarray(v) for k, v in zip(names, outs)}


def _close(got, ref, name):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    if name == "cnt":
        np.testing.assert_array_equal(got, ref, err_msg=name)
        return
    err = np.max(np.abs(got - ref))
    bound = TOL * max(1.0, np.max(np.abs(ref)))
    assert err <= bound, f"{name}: max abs error {err:.3e} > {bound:.3e}"


@pytest.fixture(scope="module")
def jax_prefix(case):
    """One trace of the JAX recompute step on the grid (2, n_groups):
    sweeps 0-1 (profile_r3.py:115-127 with n_sweeps=2, offset 0)."""
    spec, cfg = case["jspec"], case["cfg"]
    R, L, n_groups, nyp = jfc.plan(spec)
    kernel = functools.partial(
        jfc._step_kernel, spec=spec, R=R, L=L, n_groups=n_groups, nyp=nyp,
        scalars=_scalars(cfg, cfg.transport_coeff), sweep_offset=0)
    return _pallas_probe(case, kernel, (2, n_groups))


@pytest.mark.parametrize("name", ["volH", "b11H", "b12H", "b21H", "b22H",
                                  "cnt"])
def test_prefix_matches_pallas(case, jax_prefix, name):
    """(a) Sweeps 0-1 of the recompute step against the JAX grid cut to
    two sweeps (the TPU probe runs the recompute body: no cache)."""
    spec = dataclasses.replace(case["tspec"], geom_cache="none")
    got = probes.fused_step_sweeps(
        spec, case["tl"], *case["tc"], float(case["dt"]),
        *_scalars(case["cfg"], case["cfg"].transport_coeff), first=0,
        count=2)
    _close(got[name].numpy(), jax_prefix[name], name)


def _tiny_port(case, knobs):
    spec = dataclasses.replace(case["tspec"], **knobs)
    args = (spec, case["tl"], *case["tc"], float(case["dt"]),
            *_scalars(case["cfg"], case["cfg"].transport_coeff))
    return spec, args


FORM_KNOBS = {"none": dict(geom_cache="none"),
              "partial": dict(geom_cache="partial", geom_kcut=2),
              "cache": {}}


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("form", ["none", "partial"])
def test_plain_prefix_is_the_step(case, form, n):
    """(b) The plain prefix 0..n-1 writes the plain full step's cores bit
    for bit and leaves every other core zero."""
    spec, args = _tiny_port(case, FORM_KNOBS[form])
    if form == "partial":
        assert tfc.step_form(spec, torch.float32) == ("partial", 2)
    full = tfc.fused_step_cores(*args)
    got = probes.fused_step_sweeps(*args, first=0, count=n)
    written = {k for s in range(n) for k in probes.SWEEP_WRITES[s]}
    assert set(got) == set(probes.STEP_CORES + probes.SCRATCH)
    for k, v in got.items():
        if k in written:
            if k in full:
                assert torch.equal(v, full[k]), k
        else:
            assert not bool(v.any()), k


@pytest.mark.parametrize("s", [0, 1, 2, 3])
@pytest.mark.parametrize("form", ["none", "partial", "cache"])
def test_plain_sweep_relaunch_is_idempotent(case, form, s):
    """(b) Sweep s alone over a completed step's cores (the plain
    counterpart of a relaunch on the kernel's buffers) writes them again
    bit for bit."""
    spec, args = _tiny_port(case, FORM_KNOBS[form])
    full = probes.fused_step_sweeps_plain(*args)
    got = probes.fused_step_sweeps_plain(*args, first=s, count=1,
                                         prior=full)
    for k in full:
        assert torch.equal(got[k], full[k]), k


def test_cache_form_sweep_range_needs_sweep_0(case):
    """The cache form's sweeps 1-3 read the list sweep 0 writes: a range
    that starts later raises on fresh buffers, and a range outside 0..3
    raises in every form."""
    spec, args = _tiny_port(case, FORM_KNOBS["cache"])
    assert tfc.step_form(spec, torch.float32)[0] == "full"
    with pytest.raises(ValueError, match="list"):
        probes.fused_step_sweeps(*args, first=1, count=1)
    spec, args = _tiny_port(case, FORM_KNOBS["none"])
    for first, count in ((0, 0), (-1, 2), (3, 2)):
        with pytest.raises(ValueError, match="sweep range"):
            probes.fused_step_sweeps(*args, first=first, count=count)


def test_noop_matches_pallas(case):
    """(c) The no-op writes vol[0, 0, :] = x[0, 0, :] exactly, as the JAX
    noop_kernel does; the TPU leaves every other output unwritten (NaN in
    interpret mode), the port's zeroed buffers keep zero."""
    def noop_kernel(*refs):
        refs[jfc._N_IN][0, 0, :] = refs[0][0, 0, :]

    ref = _pallas_probe(case, noop_kernel, ())
    spec, args = _tiny_port(case, FORM_KNOBS["none"])
    got = {k: v.numpy() for k, v in probes.fused_noop(*args).items()}
    np.testing.assert_array_equal(got["volH"][0, 0], ref["volH"][0, 0])
    assert np.all(ref["volH"][0, 0] == case["tc"][0][0, 0].numpy())
    rest = got["volH"].copy()
    rest[0, 0] = 0.0
    assert not rest.any()
    for k in probes.STEP_CORES[1:]:
        assert np.isnan(ref[k]).all(), k
        assert not got[k].any(), k


def _expand_pallas(v, K):
    """tests/test_pallas.py:155-172, in interpret mode."""
    rows, bx = v.shape

    def body(v_ref, o_ref):
        lane = jax.lax.broadcasted_iota(jnp.int32, (bx, K * bx), 1)
        col = jax.lax.broadcasted_iota(jnp.int32, (bx, K * bx), 0)
        E = (lane % bx == col).astype(v_ref.dtype)
        o_ref[:, :] = jnp.dot(v_ref[:, :], E,
                              preferred_element_type=v_ref.dtype,
                              precision=jax.lax.Precision.HIGHEST)

    return np.asarray(pl.pallas_call(
        body, in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((rows, K * bx), jnp.float32),
        interpret=True)(jnp.asarray(v)))


@pytest.mark.parametrize("K,bx", [(4, 8), (14, 100)])
def test_expand_matches_pallas(K, bx):
    """(d) The one-hot expand at the JAX test's shape and seed-3 values
    (odd integers up to 2^14 and full-mantissa positions, which round
    under bf16 and TF32) and at the dp=0.01 grid's (9K, nx): exact, and
    exactly v tiled K times."""
    rows = 9 * K
    rng = np.random.default_rng(3)
    v = np.where(rng.random((rows, bx)) < 0.5,
                 rng.integers(1, 8192, (rows, bx)) * 2 + 1,
                 rng.random((rows, bx)) * 3.0).astype(np.float32)
    got = probes.expand_onehot(torch.tensor(v), K).numpy()
    np.testing.assert_array_equal(got, _expand_pallas(v, K))
    np.testing.assert_array_equal(got, np.concatenate([v] * K, axis=1))


def test_probe_on_the_cpu(capsys):
    """(e) The probe at profile_r3's defaults (dp=0.025, K_cap=18,
    skin 0.75dp) with no warm-up and one call per timing: it prints the
    occupancy lines and a JSON line of host times, and its per-row
    occupancy is what the JAX assign_slots gives on the same state."""
    assert probe.main(["0.025", "0", "--device", "cpu", "--n", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    for head in ("per-row max occ:", "per-group max occ (kmax):",
                 "mean cell occ (occupied cells):"):
        assert any(ln.startswith(head) for ln in out), head
    res = json.loads(out[-1])["probe"]
    assert res["device"] == "cpu" and res["card"] is None
    assert res["form"] == "none"
    assert res["ms"] and all(k.startswith("cpu_") for k in res["ms"])
    assert all(v > 0 for v in res["ms"].values())
    # the expand moves bytes and needs no arithmetic: (9K, nx) in, K copies
    # of it out
    K, nx = res["spec"]["K"], res["spec"]["nx"]
    assert res["bound_by"]["expand"] == "bytes"
    assert res["bound_ms"]["expand"] == pytest.approx(
        1e3 * 4 * 9 * K * nx * (1 + K) / 3.35e12, rel=1e-12)

    cfg = jax_derive_config(
        DL=3.0, DH=1.0, dp=0.025, rho0=1.0, mu=0.1, U_bulk=0.666667,
        c_f=15.0, end_time=20.0, output_interval=0.5, sort_interval=100,
        restart_from_file=False, neighbor_skin=0.75 * 0.025,
        rebuild_every=32, cell_capacity=18, neighbor_capacity=56)
    scene = build_scene(cfg)
    spec = jnb.make_grid_spec(cfg, scene, lane_pack=True)
    slot, _ = jcg.assign_slots(spec, jnp.asarray(scene.x, jnp.float32),
                               jnp.asarray(scene.y, jnp.float32))
    cell = np.asarray(slot) // spec.K
    counts = np.bincount(np.minimum(cell, spec.n_cells - 1),
                         minlength=spec.n_cells).reshape(spec.ny, spec.nx)
    R, L, n_groups, nyp = jfc.plan(spec)
    occ_rows = np.zeros((nyp, spec.nx), np.int64)
    occ_rows[:spec.ny] = counts
    assert res["spec"]["nx"] == spec.nx and res["spec"]["K"] == spec.K
    assert res["occupancy"]["row_max"] == occ_rows.max(axis=1).tolist()
    assert res["occupancy"]["group_max"] == occ_rows.reshape(
        n_groups, R * spec.nx).max(axis=1).tolist()


def test_probe_needs_a_card_for_cuda():
    """Without a card, --device cuda raises: the probe never moves to the
    CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main(["0.025", "0", "--n", "1"])


def test_probe_imports_no_jax():
    """(f) The probe and the modules it imports load without JAX and
    without the JAX package."""
    code = ("import sys, sph_poiseuille_flow_torch.probe; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'sph_poiseuille_flow_tpu'}); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sweep_range_check():
    for first, count in ((0, 1), (0, 4), (3, 1), (1, 3)):
        fcc.check_sweep_range(first, count)
    with pytest.raises(ValueError):
        fcc.check_sweep_range(2, 3)
