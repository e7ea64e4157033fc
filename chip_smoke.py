#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``sph_poiseuille_flow_torch``) on one
CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure before the last line:

1. build the hand-written CUDA kernels from ``csrc/`` with nvcc (sm_90a),
   printing the compiler's register/spill report and the card;
2. hold each kernel against its plain PyTorch version on the card, on a
   seeded, jittered state at each grid the main path runs, in each form
   the layout knobs select (recompute "none", the geometry cache that
   "auto" picks there, "partial" with a forced k_cut that splits K, and
   "rows"): (a) ``config.ini`` with the CLI defaults (dp=0.05, K=16, no
   skin): the fused step at dt=0 with no shift and at a real dt, a
   one-step chunk as the interval loop calls it there, a chunk that
   reaches the interval end mid-chunk, the wall shear; (b) the validated
   dp=0.01 channel with the shipping knobs (skin 0.3dp, rebuild_every 128,
   K=14, nx=100): the fused step at both dts, a 16-step chunk, the wall
   shear. The rows kernels are also held to the recompute kernels, which
   they should equal bit for bit;
2b. the probes' kernels at both grids in every form: each sweep prefix
   of the step (``probes.fused_step_sweeps``) equals the kernel's full step
   bit for bit on the cores it writes, leaves the others zero and holds
   its plain prefix; each sweep relaunched over a completed step's buffers
   (``StepBuffers``) leaves every core bit-equal (the cache form's sweep 1,
   which folds Vol_j into its list in place, after a restore of the list);
   the no-op writes x's first halo row into vol's and nothing else; the
   one-hot expand equals ``repeat`` bit for bit at the JAX test's shape and
   at (b)'s window. Then the probe entry point (``python -m
   sph_poiseuille_flow_torch.probe``) runs at (b) with a short warm-up in
   the recompute, cache and rows forms, with the launch counts reset
   before each run and its kernels nonzero after it; its JSON gives the
   sweeps', the no-op's and the expand's times, plain times and bounds in
   the kernels line;
3. drive the main path through the CLI (``run.main``): (a) ``config.ini``
   as shipped (20 s, "auto", so the geometry cache), which must pass its
   5% L2 gate; (b) the dp=0.01 channel with the shipping knobs for a few
   tenths of a second under "auto" (the cache), ``--geom-cache none`` and
   ``--fused-rows 1``, each of which must stay clean (the simulation
   raises on overflow, on an unrecoverable drift-guard trip and on
   non-finite velocities) with v_max and tau rising; (c) a short
   ``config.ini`` run with ``--step-log-every``, whose log rows are
   printed. The launch counts are reset to 0 before each run and each
   kernel of the form the run selects must be nonzero after it;
4. time each kernel and form against its plain version with CUDA events
   at the (b) shapes and at dp=0.025.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line
(each kernel with its time, its plain version's and the least time the
card could take for the same work) and, last, ``{"ok": true, "device":
{...}}``. Imports nothing of JAX. Outputs go to ``results/chip_smoke/``
(git-ignored).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "results", "chip_smoke")

# The validated dp=0.01 channel (docs/VALIDATION.md) with the shipping
# knobs: 32,400 particles on a 100 x 39 cell grid, K=14.
DP001 = dict(DL=3.0, DH=1.0, dp=0.01, rho0=1.0, mu=0.1, U_bulk=0.666667,
             c_f=15.0, end_time=0.3, output_interval=0.1, sort_interval=100,
             restart_from_file=False, neighbor_skin=0.3 * 0.01,
             rebuild_every=128, cell_capacity=14, lane_pack_nx=100)
# the dp=0.025 shipping grid (4,800 fluid particles, nx=40), for timing
DP0025 = dict(DP001, dp=0.025, neighbor_skin=0.3 * 0.025, lane_pack_nx=40)

# The forms of the step and the chunk, as (label, spec knobs): "cache" is
# what "auto" picks at the grid ("full" at (a) and dp=0.025, "ring" at
# (b), one kernel here); "partial" caches half the anchor ranks.
FORMS = (("none", dict(geom_cache="none")), ("cache", {}),
         ("partial", None), ("rows", dict(fused_rows="1")))

# Kernel vs plain tolerances, as a bound on max|kernel - plain| relative to
# max(1, max|plain|) of each core. Both run the same float32 operations in
# the same order per pair; they differ in the order of the 9K-term window
# sums (a register loop against torch's reduction tree) and in rsqrtf, so
# one step differs by a few ulp of the largest term: 1e-4 leaves two
# decades of room. Sixteen chunk steps compound that through the dt and
# the positions: 1e-3. ``p`` is rho error times p0 = c_f^2 rho0 = 225, so
# its bound is p0 times rho's (absolute). The pair count ``cnt`` is a
# count: one step must match it exactly; over a chunk a pair that drifts
# within an ulp of the cutoff may flip, which moves a lane by 0.5 or 1, so
# a chunk's count gets an absolute bound of 2 pairs per lane.
TOL_STEP = 1e-4
TOL_CHUNK = 1e-3
CNT_CHUNK = 2.0


def _abs_bound(name: str, tol: float, p0: float, cnt: float):
    if name.startswith(("pP", "phH")):
        return tol * p0
    if name.startswith("cnt"):
        return cnt
    return None


def _say(msg: str) -> None:
    print(msg, flush=True)


class Check:
    """Collects kernel-vs-plain errors per kernel."""

    def __init__(self):
        self.max_abs = {}

    def core(self, kernel: str, name: str, got, ref, tol: float,
             absolute: float = None, record: bool = True,
             say: bool = True) -> float:
        """Hold ``got`` to ``ref``; returns the error relative to the
        core's scale."""
        import torch
        if got.shape != ref.shape:
            raise AssertionError(f"{kernel}/{name}: shape {tuple(got.shape)}"
                                 f" vs plain {tuple(ref.shape)}")
        got = got.double()
        ref = ref.double()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{kernel}/{name}: non-finite output")
        # empty slots of the x cores sit at 1e9: they must pass through
        # exactly, and they are left out of the error scale
        parked = ref.abs() >= 1e8
        if not bool((got[parked] == ref[parked]).all()):
            raise AssertionError(f"{kernel}/{name}: empty slots moved")
        got = torch.where(parked, 0.0, got)
        ref = torch.where(parked, 0.0, ref)
        err = float((got - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        bound = tol * scale if absolute is None else absolute
        rel = err / scale
        if say:
            _say(f"  {kernel:17s} {name:18s} max_abs={err:.3e} "
                 f"rel={rel:.3e} bound={bound:.1e}")
        if record:
            self.max_abs[kernel] = max(self.max_abs.get(kernel, 0.0), err)
        if not err <= bound:
            raise AssertionError(f"{kernel}/{name}: kernel vs plain error "
                                 f"{err:.3e} above {bound:.1e}")
        return rel


def _grids():
    """(label, config) of each grid the main path runs: (a) config.ini
    with the CLI defaults, (b) the dp=0.01 channel with the shipping
    knobs."""
    from sph_poiseuille_flow_torch.config import derive_config, load_config
    return (("a", load_config(os.path.join(ROOT, "config.ini"))),
            ("b", derive_config(**DP001)))


def _jittered_case(cfg, device):
    """Spec, scene, layout and halo'd state cores of ``cfg``'s channel with
    a seeded jitter (that of the JAX package's Pallas tests)."""
    import numpy as np
    import torch
    from sph_poiseuille_flow_torch.models.poiseuille import build_scene
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    from sph_poiseuille_flow_torch.ops.neighbors import make_grid_spec

    scene = build_scene(cfg)
    spec = make_grid_spec(cfg, scene, lane_pack=True)
    rng = np.random.default_rng(7)
    nf, n = scene.n_fluid, scene.n_total
    x = np.asarray(scene.x, np.float64).copy()
    y = np.asarray(scene.y, np.float64).copy()
    x[:nf] = np.mod(x[:nf] + rng.uniform(-0.35, 0.35, nf) * cfg.dp, cfg.DL)
    y[:nf] += rng.uniform(-0.35, 0.35, nf) * cfg.dp
    vx, vy, dr = (np.zeros(n) for _ in range(3))
    vx[:nf] = rng.normal(0, 0.4, nf)
    vy[:nf] = rng.normal(0, 0.1, nf)
    dr[:nf] = rng.normal(0, 0.05, nf)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    x, y, vx, vy, dr = map(t, (x, y, vx, vy, dr))
    zeros = torch.zeros(n, dtype=torch.float32, device=device)
    lay = fc.build_fused_layout(spec, x, y, t(scene.mass), zeros, zeros,
                                t(scene.y))
    if bool(lay.overflow):
        raise AssertionError(f"jittered dp={cfg.dp} state overflows "
                             f"K={spec.K}")
    cores = dict(
        xH=fc.make_core(spec, lay.pidx, x, fill=fc._BIG_X, xshift=spec.DL),
        yH=fc.make_core(spec, lay.pidx, y),
        vxH=fc.make_core(spec, lay.pidx, vx),
        vyH=fc.make_core(spec, lay.pidx, vy),
        drP=fc.make_plain(spec, lay.pidx, dr))
    return scene, spec, lay, cores, (vx, vy)


def _form_spec(spec, knobs):
    """``spec`` with a form's layout knobs; ``None`` is "partial" with half
    the anchor ranks cached (a split that is not a multiple of a warp)."""
    if knobs is None:
        knobs = dict(geom_cache="partial", geom_kcut=spec.K // 2)
    return dataclasses.replace(spec, **knobs)


# The chunk cases of each grid, as (n_sub, interval, expected steps): the
# interval loop of (a) calls one-step chunks (rebuild_every 1); the clamp
# case ends its interval mid-chunk (dt is about 1e-3 at dp=0.05), so the
# remainder clamp and the active flag are held too; (b) calls 16 steps.
CHUNKS = {"a": ((1, 1.0, 1), (16, 5.5e-3, None)),
          "b": ((16, 1.0, 16),)}


def phase_build() -> None:
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda
    t0 = time.perf_counter()
    path = fused_cell_cuda.build(verbose=True)
    _say(f"build: {os.path.relpath(path, ROOT)} in "
         f"{time.perf_counter() - t0:.1f} s")


def _check_form(device, check: Check, label: str, cfg, spec, lay, args,
                dt, flabel: str) -> dict:
    """The step at both dts and the grid's chunk cases in one form, each
    against its plain twin in the same form. Returns the kernel outputs."""
    import torch
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc

    sform = fc.step_form(spec, torch.float32)
    cform = fc.chunk_form(spec, torch.float32)
    kstep = fcc.launch_key("fused_step", sform[0])
    kchunk = fcc.launch_key("fused_chunk", cform[0])
    _say(f"  form {flabel} ({label}): step {sform} -> {kstep}, chunk "
         f"{cform} -> {kchunk}")
    if flabel == "partial" and not 0 < cform[1] < spec.K:
        raise AssertionError(f"partial k_cut {cform[1]} does not split "
                             f"K={spec.K}")
    outs = {}
    for dtv, tc in ((0.0, 0.0), (dt, cfg.transport_coeff)):
        sc = (cfg.rho0, cfg.p0, cfg.c_f, cfg.inv_sigma0, tc, cfg.gravity_g,
              cfg.mu, cfg.wall_visc_factor)
        got = fc.fused_step_cores(spec, lay, *args, dtv, *sc)
        ref = fc.fused_step_cores_plain(spec, lay, *args, dtv, *sc)
        torch.cuda.synchronize()
        tag = f"{label}/{flabel}:" + ("" if tc else "@0:")
        for k in sorted(ref):
            check.core(kstep, tag + k, got[k], ref[k], TOL_STEP,
                       _abs_bound(k, TOL_STEP, cfg.p0, 0.0))
        outs[f"step{'' if tc else '@0'}"] = got

    sc = (cfg.rho0, cfg.p0, cfg.c_f, cfg.inv_sigma0, cfg.transport_coeff,
          cfg.gravity_g, cfg.mu, cfg.wall_visc_factor)
    for n_sub, interval, want in CHUNKS[label]:
        got = fc.fused_chunk_call(spec, lay, *args, 0.0, 0.0, interval,
                                  n_sub, *sc)
        ref = fc.fused_chunk_call_plain(spec, lay, *args, 0.0, 0.0, interval,
                                        n_sub, *sc)
        torch.cuda.synchronize()
        gs, rs = int(got[2]), int(ref[2])
        if gs != rs or (want is not None and gs != want):
            raise AssertionError(f"{kchunk} ({label}, n_sub={n_sub}): "
                                 f"steps {gs} / plain {rs}, expected "
                                 f"{want if want is not None else rs}")
        if want is None:
            # the interval ends inside the chunk: the clamp lands on it
            if not 1 < gs < n_sub or float(got[3]) != float(ref[3]):
                raise AssertionError(
                    f"{kchunk} ({label}): {gs} steps, t={float(got[3])!r}"
                    f" / plain {float(ref[3])!r} at interval {interval}")
        tol = TOL_STEP if n_sub == 1 else TOL_CHUNK
        cnt = 0.0 if n_sub == 1 else CNT_CHUNK
        tag = f"{label}/{flabel}{n_sub}:"
        for part in (0, 1):
            for k in sorted(ref[part]):
                check.core(kchunk, tag + k, got[part][k], ref[part][k], tol,
                           _abs_bound(k, tol, cfg.p0, cnt))
        for i, k in ((3, "t"), (4, "t_comp")):
            check.core(kchunk, tag + k, got[i].reshape(1),
                       ref[i].reshape(1), tol * 1e-3)
        _say(f"  {kchunk} ({label}) n_sub={n_sub} interval={interval} "
             f"steps={gs} t={float(got[3]):.9e} plain t={float(ref[3]):.9e}")
        outs[f"chunk{n_sub}"] = {**got[0], **{f"aux:{k}": v
                                              for k, v in got[1].items()}}
    return outs


def phase_kernels(device, check: Check, label: str, cfg) -> dict:
    import torch
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    from sph_poiseuille_flow_torch.ops.integration import verlet_dt

    scene, spec, lay, c, (vx, vy) = _jittered_case(cfg, device)
    R, L, n_groups, nyp = fc.plan(spec)
    _say(f"kernels ({label}): dp={cfg.dp} grid nx={spec.nx} ny={spec.ny} "
         f"K={spec.K} R={R} n_groups={n_groups}, halo'd core "
         f"{(nyp + 2, spec.K, spec.nx + 2)}, {scene.n_total} particles")
    nf = scene.n_fluid
    dt = verlet_dt(vx[:nf], vy[:nf], cfg.c_f, cfg.h, cfg.nu, cfg.gravity_g,
                   1.0)
    args = (c["xH"], c["yH"], c["vxH"], c["vyH"], c["drP"])
    outs = {flabel: _check_form(device, check, label, cfg,
                                _form_spec(spec, knobs), lay, args, dt,
                                flabel)
            for flabel, knobs in FORMS}

    # the rows kernels run the recompute arithmetic in the recompute order
    # from shared memory: they should equal the recompute kernels
    n_eq = n_all = 0
    for case, got in outs["rows"].items():
        step = case.startswith("step")
        tol = TOL_STEP if step else TOL_CHUNK
        for k, v in got.items():
            n_all += 1
            n_eq += int(torch.equal(v, outs["none"][case][k]))
            check.core("fused_step_rows" if step else "fused_chunk_rows",
                       f"{label}/rows-none:{case}:{k}", v,
                       outs["none"][case][k], tol,
                       _abs_bound(k.split(":")[-1], tol, cfg.p0,
                                  0.0 if step else CNT_CHUNK),
                       record=False)
    _say(f"  rows vs recompute kernels ({label}): {n_eq} of {n_all} cores "
         "bit-equal")

    # the wall shear on the stepped cores, as the engine calls it
    sc = (cfg.rho0, cfg.p0, cfg.c_f, cfg.inv_sigma0, cfg.transport_coeff,
          cfg.gravity_g, cfg.mu, cfg.wall_visc_factor)
    o = fc.fused_step_cores_plain(spec, lay, *args, dt, *sc)
    sh = (c["xH"], c["yH"], o["vxH"], o["volH"], o["b11H"], o["b12H"],
          o["b21H"], o["b22H"], cfg.mu, cfg.wall_visc_factor)
    got = fc.fused_wall_shear_cores(spec, lay, *sh)
    ref = fc.fused_wall_shear_cores_plain(spec, lay, *sh)
    for k, gv, rv in (("tau_b", got[0], ref[0]), ("tau_t", got[1], ref[1])):
        check.core("fused_wall_shear", f"{label}:{k}", gv.reshape(1),
                   rv.reshape(1), TOL_STEP)
    _say(f"  tau_bottom ({label})={float(got[0]):.6f} "
         f"plain={float(ref[0]):.6f}")
    return dict(cfg=cfg, spec=spec, lay=lay, args=args, sc=sc, dt=dt, sh=sh)


def _equal(what: str, got: dict, ref: dict, keys) -> None:
    import torch
    bad = [k for k in keys if not torch.equal(got[k], ref[k])]
    if bad:
        raise AssertionError(f"{what}: {bad} not bit-equal")


def phase_probes(device, check: Check, label: str, k: dict) -> None:
    """The probes' kernels at one grid, in every form: the sweep prefixes
    against the kernel's full step (bit for bit on the cores they write,
    zero elsewhere) and against the plain prefixes, each single sweep
    relaunched over a completed step's buffers (bit-equal; the cache
    form's sweep 1 restored first), the no-op; at (b) also the expand.
    Their times come from the probe runs (``phase_probe_cli``)."""
    import torch
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc
    from sph_poiseuille_flow_torch.ops import probes

    cfg, spec, lay, args, sc, dt = (k[n] for n in ("cfg", "spec", "lay",
                                                   "args", "sc", "dt"))
    R = fc.plan(spec)[0]
    for flabel, knobs in FORMS:
        fspec = _form_spec(spec, knobs)
        form = fc.step_form(fspec, torch.float32)
        key = fcc.launch_key("fused_step_sweeps", form[0])
        tag = f"{label}/{flabel}"
        full = fc.fused_step_cores(fspec, lay, *args, dt, *sc)
        worst = 0.0
        for m in range(1, 5):
            got = probes.fused_step_sweeps(fspec, lay, *args, dt, *sc,
                                           first=0, count=m)
            ref = probes.fused_step_sweeps_plain(fspec, lay, *args, dt, *sc,
                                                 first=0, count=m)
            torch.cuda.synchronize()
            written = {c for s in range(m) for c in probes.SWEEP_WRITES[s]}
            _equal(f"{key} ({tag}) prefix {m} vs the step", got, full,
                   written & set(full))
            for name, v in got.items():
                if name not in written:
                    if bool(v.any()):
                        raise AssertionError(f"{key} ({tag}) prefix {m} "
                                             f"wrote {name}")
                    continue
                worst = max(worst, check.core(
                    key, f"{tag}/p{m}:{name}", v, ref[name], TOL_STEP,
                    _abs_bound(name, TOL_STEP, cfg.p0, 0.0), say=False))

        # each sweep again over the completed step's buffers
        b = fcc.StepBuffers(fspec, R, lay, *args, dt, sc, *form)
        b.sweeps(0, 1)
        if b.rewrites:
            b.snapshot()
        b.sweeps(1, 3)
        torch.cuda.synchronize()
        done = {c: v.clone() for c, v in b.outputs().items()}
        _equal(f"{key} ({tag}) buffers vs the step",
               dict(done, cnt=fc._cnt_rows(fspec, done["cnt"])), full, full)
        if b.rewrites:
            try:
                b.sweeps(1, 1)
                raise AssertionError(f"{key}: a second sweep 1 on a folded "
                                     "list did not raise")
            except RuntimeError:
                pass
        for s in range(4):
            if s in b.rewrites:
                b.restore()
            b.sweeps(s, 1)
            torch.cuda.synchronize()
            _equal(f"{key} ({tag}) sweep {s} relaunched", b.outputs(), done,
                   done)

        o = probes.fused_noop(fspec, lay, *args, dt, *sc)
        torch.cuda.synchronize()
        x0 = args[0][0, 0, :]
        if not torch.equal(o["volH"][0, 0, :], x0):
            raise AssertionError(f"fused_noop ({tag}): vol[0, 0, :] != "
                                 "x[0, 0, :]")
        o["volH"][0, 0, :] = 0.0
        if any(bool(v.any()) for v in o.values()):
            raise AssertionError(f"fused_noop ({tag}) wrote past its row")
        check.max_abs["fused_noop"] = 0.0
        _say(f"probes ({tag}) {key}: prefixes 1-4 bit-equal to the step on "
             f"their cores and zero elsewhere, vs plain max rel "
             f"{worst:.2e}; sweeps 0-3 relaunched bit-equal"
             f"{' (sweep 1 restored)' if b.rewrites else ''}; no-op exact")
    if label == "b":
        phase_expand(device, check, spec)


def phase_expand(device, check: Check, spec) -> None:
    """The one-hot expand bit-equal to ``repeat`` at the JAX test's shape
    (K=4, bx=8) and at the (b) window's (9K, nx), on values that need more
    than 10 mantissa bits; what TF32 would make of the product is printed
    as a record."""
    import numpy as np
    import torch
    from sph_poiseuille_flow_torch.ops import probes

    for K, bx in ((4, 8), (spec.K, spec.nx)):
        rng = np.random.default_rng(3)
        rows = 9 * K
        v = np.where(rng.random((rows, bx)) < 0.5,
                     rng.integers(1, 8192, (rows, bx)) * 2 + 1,
                     rng.random((rows, bx)) * 3.0).astype(np.float32)
        v = torch.as_tensor(v, device=device)
        want = v.repeat(1, K)
        got = probes.expand_onehot(v, K)
        ref = probes.expand_onehot_plain(v, K)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(ref, want)):
            raise AssertionError(f"expand_onehot ({rows}, {bx}) x{K}: not "
                                 "v tiled exactly")
        E = probes.onehot_tiling(bx, K, v)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            n_tf32 = int((torch.matmul(v, E) != want).sum())
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        _say(f"expand_onehot ({rows}, {bx}) x{K}: bit-equal to repeat; "
             f"torch.matmul under TF32 gets {n_tf32} of {want.numel()} "
             "elements wrong (a record)")
    check.max_abs["expand_onehot"] = 0.0


# the probe runs at (b): (name, flags, the LAUNCHES key of its sweeps)
PROBE_RUNS = (("none", [], "fused_step_sweeps"),
              ("cache", ["--geom-cache", "auto"], "fused_step_sweeps_cache"),
              ("rows", ["--fused-rows", "1"], "fused_step_sweeps_rows"))


def phase_probe_cli() -> tuple:
    """The probe entry point at (b) with a short warm-up in the default
    form, under the cache and under the rows form: the counts are reset
    before each run and its kernels must have launched in it. Returns
    ({run: launch counts}, {run: the probe's JSON}), whose times, plain
    times and bounds make the probes' entries of the kernels line."""
    from sph_poiseuille_flow_torch import probe
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc

    counts, results = {}, {}
    for name, flags, key in PROBE_RUNS:
        buf = io.StringIO()
        fcc.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            rc = probe.main(["0.01", "0.1", "14", "0.3", "--lane-pack-nx",
                             "100", "--rebuild-every", "128", "--n", "20"]
                            + flags)
        counts[name] = dict(fcc.LAUNCHES)
        out = buf.getvalue().splitlines()
        with open(os.path.join(OUT, f"probe_{name}.txt"), "w") as f:
            f.write(buf.getvalue())
        for ln in out:
            if ln.startswith(("spec:", "developed", "full", "sweep",
                              "sum", "no-op", "one-hot")):
                _say(f"  {ln}")
        _say(out[-1])
        res = results[name] = json.loads(out[-1])["probe"]
        if rc != 0 or res["device"] != "cuda":
            raise AssertionError(f"probe ({name}): rc {rc}, {res['device']}")
        for kk in (key, "fused_noop", "expand_onehot"):
            if counts[name][kk] <= 0:
                raise AssertionError(f"probe ({name}): kernel {kk} was never "
                                     "launched")
        _say(f"probe ({name}) launches={counts[name]}")
    return counts, results


def _probe_times(results: dict) -> dict:
    """{kernels-line name: (ms, plain_ms, bound_ms, bound_by, library_ms)}
    from the probe runs' JSON: each sweep from the run of its form (device
    time on persistent buffers; for the cache form's sweep 1, which must
    be restored before each relaunch, its prefix marginal inside the
    step), the no-op (on buffers) and the expand from the default form's
    run."""
    out = {}
    for name, _, key in PROBE_RUNS:
        r = results[name]
        for s in range(4):
            out[f"{key}:sweep{s}"] = (
                r["ms"].get(f"sweep{s}_in_step", r["ms"][f"sweep{s}"]),
                r["ms"][f"plain_sweep{s}"], r["bound_ms"][f"sweep{s}"],
                r["bound_by"][f"sweep{s}"], None)
    r = results[PROBE_RUNS[0][0]]
    for name, kind, ms in (("fused_noop", "noop", "noop_bufs"),
                           ("expand_onehot", "expand", "expand")):
        out[name] = (r["ms"][ms], r["ms"][f"plain_{kind}"],
                     r["bound_ms"][kind], r["bound_by"][kind],
                     r["ms"][f"library_{kind}"])
    return out


def _run_cli(name: str, ini_text, extra, capture: bool = False) -> dict:
    """One in-process CLI run; returns the result dict of the run (with
    its standard output under "stdout" when ``capture``)."""
    import torch
    from sph_poiseuille_flow_torch import run as cli
    from sph_poiseuille_flow_torch import simulation

    base = os.path.join(OUT, name)
    os.makedirs(base, exist_ok=True)
    if ini_text is None:
        ini = os.path.join(ROOT, "config.ini")
    else:
        ini = os.path.join(base, "config.ini")
        with open(ini, "w") as f:
            f.write(ini_text)
    for k in ("SPH_CONFIG_OVERRIDE", "SPH_RESTART_PATH_OVERRIDE",
              "SPH_RESULT_PNG_OVERRIDE", "SPH_PROFILE_PNG_OVERRIDE",
              "SPH_POSTPROCESS_MAT_OVERRIDE"):
        os.environ.pop(k, None)
    captured = {}
    orig_run = simulation.Simulation.run

    def run_and_keep(self):
        captured["result"] = orig_run(self)
        return captured["result"]

    simulation.Simulation.run = run_and_keep
    buf = io.StringIO()
    try:
        t0 = time.perf_counter()
        with (contextlib.redirect_stdout(buf) if capture
              else contextlib.nullcontext()):
            rc = cli.main(["--config", ini, "--base-dir", base,
                           "--device", "cuda"] + list(extra))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        simulation.Simulation.run = orig_run
    res = captured["result"]
    res["rc"] = rc
    res["wall_total"] = wall
    res["stdout"] = buf.getvalue()
    return res


# the dp=0.01 runs of phase 3: (name, CLI flags, LAUNCHES suffix of the
# form the run selects)
RUNS_B = (("b", [], "_cache"), ("b_none", ["--geom-cache", "none"], ""),
          ("b_rows", ["--fused-rows", "1"], "_rows"))


def _launched(run: str, counts: dict, want: set) -> None:
    """Each kernel in ``want`` ran in the run, and no other form of the
    step or the chunk did: no form gives way to another."""
    for k, v in counts.items():
        if k in want and v <= 0:
            raise AssertionError(f"main ({run}): kernel {k} was never "
                                 "launched")
        if k not in want and v != 0:
            raise AssertionError(f"main ({run}): kernel {k} launched {v} "
                                 "times, outside the run's form")


def phase_main() -> dict:
    import math
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc

    counts = {}
    # (a) config.ini as shipped (20 s), through the CLI with its defaults
    fcc.reset_launch_counts()
    ra = _run_cli("a_config_ini", None, [])
    counts["a"] = dict(fcc.LAUNCHES)
    _say(f"main (a) config.ini: rc={ra['rc']} L2={100 * ra['L2_error']:.4f}% "
         f"(recompute form: 1.7366%, PERF.md) steps={ra['step']} "
         f"t={ra['t']:.3f} tau_bottom={ra['tau_bottom']:.5f} "
         f"psteps/s={ra['particle_steps_per_sec']:.4e} "
         f"host_syncs={ra['host_syncs']} launches={counts['a']}")
    if ra["rc"] != 0 or not ra["passed"]:
        raise AssertionError(f"(a) config.ini: L2 {ra['L2_error']:.4%} "
                             "did not pass the 5% gate")
    if not math.isfinite(ra["tau_bottom"]):
        raise AssertionError("(a) config.ini: non-finite tau")
    _launched("a", counts["a"], {"fused_step_cache", "fused_chunk_cache",
                                 "fused_wall_shear"})

    # (b) the dp=0.01 channel with the shipping knobs, a few tenths of s,
    # in each form a user can select
    ini = ("[physical]\nDL = 3.0\nDH = 1.0\ndp = 0.01\nrho0 = 1.0\n"
           "mu = 0.1\nU_bulk = 0.666667\nc_f = 15.0\n"
           f"[simulation]\nend_time = {DP001['end_time']}\n"
           f"output_interval = {DP001['output_interval']}\n"
           "sort_interval = 100\nrestart_from_file = 0\n")
    from sph_poiseuille_flow_torch.config import derive_config
    tau_target = derive_config(**DP001).tau_target
    runs = {"a": ra}
    for name, flags, suffix in RUNS_B:
        fcc.reset_launch_counts()
        rb = _run_cli(f"{name}_dp001", ini,
                      ["--neighbor-skin", str(DP001["neighbor_skin"]),
                       "--rebuild-every", "128", "--cell-capacity", "14",
                       "--lane-pack-nx", "100"] + flags)
        counts[name] = dict(fcc.LAUNCHES)
        runs[name] = rb
        taus = [tb for _, tb, _ in rb["tau_history"]]
        vmaxs = rb["v_max_history"]
        st = rb["final_state"]
        import torch
        finite = all(bool(torch.isfinite(getattr(st, f)).all())
                     for f in st._fields)
        _say(f"main ({name}) dp=0.01 {' '.join(flags) or 'auto'}: "
             f"steps={rb['step']} t={rb['t']:.3f} "
             f"tau_bottom={['%.5f' % v for v in taus]} "
             f"v_max={['%.4f' % v for v in vmaxs]} "
             f"psteps/s={rb['particle_steps_per_sec']:.4e} "
             f"host_syncs={rb['host_syncs']} launches={counts[name]}")
        if not finite or not all(math.isfinite(v) for v in taus):
            raise AssertionError(f"({name}) dp=0.01: non-finite state or tau")
        if not all(b > a for a, b in zip(taus, taus[1:])) or taus[0] <= 0:
            raise AssertionError(f"({name}) dp=0.01: tau not rising: {taus}")
        if not all(b > a for a, b in zip(vmaxs, vmaxs[1:])) or vmaxs[0] <= 0:
            raise AssertionError(f"({name}) dp=0.01: v_max not rising: "
                                 f"{vmaxs}")
        if not taus[-1] < 1.2 * tau_target:
            raise AssertionError(f"({name}) dp=0.01: tau {taus[-1]} "
                                 f"overshoots tau_target {tau_target}")
        _launched(name, counts[name], {"fused_step" + suffix,
                                       "fused_chunk" + suffix,
                                       "fused_wall_shear"})

    # (c) the per-step log path: config.ini for 0.05 s, a row every 10
    fcc.reset_launch_counts()
    rc = _run_cli("c_step_log", None,
                  ["--step-log-every", "10", "--set",
                   "simulation.end_time=0.05", "--set",
                   "simulation.output_interval=0.025"], capture=True)
    counts["c"] = dict(fcc.LAUNCHES)
    runs["c"] = rc
    pat = re.compile(r"step=(\d+), t=\d+\.\d{6}/\d+\.\d{6}, "
                     r"dt=\d\.\d{4}e[+-]\d+, pairs=\d+, vmax=\d+\.\d{4}$")
    lines = rc["stdout"].splitlines()
    rows = [ln for ln in lines if pat.match(ln)]
    for i, ln in enumerate(lines):
        if pat.match(ln):
            _say(f"  {ln}")
            _say(f"  {lines[i + 1]}")
    steps = [int(pat.match(ln).group(1)) for ln in rows]
    _say(f"main (c) step log: {len(rows)} rows over {rc['step']} steps, "
         f"host_syncs={rc['host_syncs']} launches={counts['c']}")
    if (len(rows) < 2 or any(s % 10 for s in steps)
            or steps != sorted(set(steps))
            or not all(lines[i + 1].startswith("  [thick-wall-noslip]")
                       for i, ln in enumerate(lines) if pat.match(ln))):
        raise AssertionError(f"(c) step log rows malformed: {rows}")
    _launched("c", counts["c"], {"fused_step_cache", "fused_wall_shear"})
    return dict(runs=runs, counts=counts)


def _time(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def phase_timing(device, kern_b: dict) -> dict:
    """Kernel and plain times of every form of step and chunk at the (b)
    shapes and at dp=0.025, and of the shear at (b); with each call's
    bound. Returns {(grid, kernel): (ms, plain_ms, bound_ms, bound_by)}."""
    import torch
    from sph_poiseuille_flow_torch.config import derive_config
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc
    from sph_poiseuille_flow_torch.ops.integration import verlet_dt
    from sph_poiseuille_flow_torch.utils import roofline

    cfg25 = derive_config(**DP0025)
    _, spec25, lay25, c25, (vx, vy) = _jittered_case(cfg25, device)
    nf = int(spec25.n_fluid)
    grids = {"b": kern_b, "d025": dict(
        spec=spec25, lay=lay25,
        args=(c25["xH"], c25["yH"], c25["vxH"], c25["vyH"], c25["drP"]),
        sc=kern_b["sc"], dt=verlet_dt(vx[:nf], vy[:nf], cfg25.c_f, cfg25.h,
                                      cfg25.nu, cfg25.gravity_g, 1.0))}
    out = {}
    for grid, k in grids.items():
        spec, lay, args, sc, dt = (k[n] for n in ("spec", "lay", "args",
                                                  "sc", "dt"))
        n = roofline.pair_counts(spec, lay, args[0], args[1])
        _say(f"timing ({grid}): {n['anchors']:.0f} visited anchors, "
             f"{n['pairs']:.0f} valid pairs, {n['wall']:.0f} wall pairs")
        for flabel, knobs in FORMS:
            fspec = _form_spec(spec, knobs)
            form = fc.chunk_form(fspec, torch.float32)[0]
            pairs = {
                "fused_step": (
                    lambda: fc.fused_step_cores(fspec, lay, *args, dt, *sc),
                    lambda: fc.fused_step_cores_plain(fspec, lay, *args, dt,
                                                      *sc), 20, ("step", 1)),
                "fused_chunk": (
                    lambda: fc.fused_chunk_call(fspec, lay, *args, 0.0, 0.0,
                                                1.0, 16, *sc),
                    lambda: fc.fused_chunk_call_plain(
                        fspec, lay, *args, 0.0, 0.0, 1.0, 16, *sc), 5,
                    ("chunk", 16)),
            }
            # device memory of one step call above its inputs (the cache
            # form allocates 9K entries of 24 bytes per cached slot)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            held = torch.cuda.memory_allocated(device)
            pairs["fused_step"][0]()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device) - held
            _say(f"memory ({grid}) [{flabel:7s}] one step: peak "
                 f"{peak / 2**20:.1f} MiB above its inputs; the cache list "
                 f"holds {n['pairs'] * 24 / 2**20:.1f} MiB of valid pairs")
            for base, (kern, plain, reps, (kind, steps)) in pairs.items():
                # plain first, then kernel, kernel, plain (in turns)
                p1 = _time(plain, reps)
                k1 = _time(kern, reps)
                k2 = _time(kern, reps)
                p2 = _time(plain, reps)
                bound = roofline.bound(kind, spec, n, steps)
                name = fcc.launch_key(base, form)
                _say(f"timing ({grid}) {name:17s} [{flabel:7s}] kernel "
                     f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
                     f"bound {bound[0]:.4f} ms ({bound[1]})")
                key = (grid, name if flabel != "partial"
                       else name + "[partial]")
                out[key] = (min(k1, k2), min(p1, p2)) + bound
    k = kern_b
    sh = k["sh"]
    p1 = _time(lambda: fc.fused_wall_shear_cores_plain(k["spec"], k["lay"],
                                                       *sh), 20)
    k1 = _time(lambda: fc.fused_wall_shear_cores(k["spec"], k["lay"], *sh),
               20)
    k2 = _time(lambda: fc.fused_wall_shear_cores(k["spec"], k["lay"], *sh),
               20)
    p2 = _time(lambda: fc.fused_wall_shear_cores_plain(k["spec"], k["lay"],
                                                       *sh), 20)
    n = roofline.pair_counts(k["spec"], k["lay"], sh[0], sh[1])
    bound = roofline.bound("shear", k["spec"], n)
    _say(f"timing (b) fused_wall_shear  kernel {k1:.4f}/{k2:.4f} ms, plain "
         f"{p1:.4f}/{p2:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    out[("b", "fused_wall_shear")] = (min(k1, k2), min(p1, p2)) + bound
    return out


# the TPU kernel each CUDA kernel replaces: _step_kernel/_kernel_body via
# _fused_call, _chunk_kernel via fused_chunk_call, the geometry cache of
# both (cache_plan), _kernel_body_rows, _shear_kernel via
# fused_wall_shear_cores
_TPU = "sph_poiseuille_flow_tpu/ops/fused_cell.py"
REPLACES = {
    "fused_step": f"{_TPU}:560",
    "fused_step_cache": f"{_TPU}:422",
    "fused_step_rows": f"{_TPU}:1081",
    "fused_chunk": f"{_TPU}:1550",
    "fused_chunk_cache": f"{_TPU}:422",
    "fused_chunk_rows": f"{_TPU}:1081",
    "fused_wall_shear": f"{_TPU}:1928",
}
# the probes' kernels: _step_kernel on a grid cut to a sweep range
# (call_sweeps; prefix_call of experiments/profile_fused.py:72 is the range
# from sweep 0), the no-op body, the one-hot lane tiling
PROBE_REPLACES = {
    **{f"{key}:sweep{s}": "experiments/profile_r3.py:115"
       for _, _, key in PROBE_RUNS for s in range(4)},
    "fused_noop": "experiments/profile_r3.py:170",
    "expand_onehot": "tests/test_pallas.py:155",
}


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import sph_poiseuille_flow_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    if any(m.split(".")[0] == "jax" for m in sys.modules):
        print("chip_smoke: jax was imported", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    os.makedirs(OUT, exist_ok=True)
    from sph_poiseuille_flow_torch.probe import card_line
    card = card_line()
    _say(f"card: {card}; torch {torch.__version__} cuda "
         f"{torch.version.cuda}; python {sys.version.split()[0]}")

    check = Check()
    try:
        t0 = time.perf_counter()
        phase_build()
        kern = {label: phase_kernels(device, check, label, cfg)
                for label, cfg in _grids()}
        t1 = time.perf_counter()
        for label in kern:
            phase_probes(device, check, label, kern[label])
        probe_counts, probe_res = phase_probe_cli()
        probe_times = _probe_times(probe_res)
        _say(f"probe phase done in {time.perf_counter() - t1:.1f} s")
        main_res = phase_main()
        timing = phase_timing(device, kern["b"])
        _say(f"all phases done in {time.perf_counter() - t0:.1f} s")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    if any(m.split(".")[0] == "jax" for m in sys.modules):
        print("chip_smoke: jax was imported", file=sys.stderr)
        return 1

    kernels = []
    for name, where in REPLACES.items():
        ms, plain_ms, bound_ms, bound_by = timing[("b", name)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "sph_poiseuille_flow_torch/csrc/fused_cell.cu",
            "replaces": where,
            "launches": sum(c[name] for c in main_res["counts"].values()),
            "max_abs_err": check.max_abs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
    for name, where in PROBE_REPLACES.items():
        ms, plain_ms, bound_ms, bound_by, library_ms = probe_times[name]
        key = name.split(":")[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "sph_poiseuille_flow_torch/csrc/fused_cell.cu",
            "replaces": where,
            "launches": sum(c[key] for c in probe_counts.values()),
            "max_abs_err": check.max_abs[key], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"timing": {f"{g}:{n}": v
                                 for (g, n), v in timing.items()}}))
    for run, r in main_res["runs"].items():
        print(json.dumps({"run": run, "L2_error": r["L2_error"],
                          "steps": r["step"], "t": r["t"],
                          "tau_bottom": r["tau_bottom"],
                          "particle_steps_per_sec":
                              r["particle_steps_per_sec"],
                          "host_syncs": r["host_syncs"],
                          "wall_time_in_loop": r["wall_time_in_loop"],
                          "launches": main_res["counts"][run]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
