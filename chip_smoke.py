#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``sph_poiseuille_flow_torch``) on one
CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure before the last line:

1. build the hand-written CUDA kernels from ``csrc/`` with nvcc (sm_90a),
   printing the compiler's register/spill report and the card;
2. hold each kernel against its plain PyTorch version on the card, on a
   seeded, jittered state at each grid the main path runs:
   (a) ``config.ini`` with the CLI defaults (dp=0.05, K=16, no skin): the
   fused step at dt=0 with no shift and at a real dt, a one-step chunk as
   the interval loop calls it there, a chunk that reaches the interval end
   mid-chunk, the wall shear; (b) the validated dp=0.01 channel with the
   shipping knobs (skin 0.3dp, rebuild_every 128, K=14, nx=100): the fused
   step at both dts, a 16-step chunk, the wall shear;
3. drive the main path through the CLI (``run.main``): (a) ``config.ini``
   as shipped (20 s), which must pass its 5% L2 gate; (b) the dp=0.01
   channel with the shipping knobs for a few tenths of a second, which must
   stay clean (the simulation raises on overflow, on an unrecoverable
   drift-guard trip and on non-finite velocities) with v_max and tau
   rising. The launch count of each kernel is reset to 0 before each run
   and must be nonzero after it;
4. time each kernel against its plain version with CUDA events at the
   (b) shapes.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Imports nothing of JAX. Outputs
go to ``results/chip_smoke/`` (git-ignored).
"""

from __future__ import annotations

import json
import os
import subprocess
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
    if name.startswith("pP"):
        return tol * p0
    if name.startswith("cnt"):
        return cnt
    return None


def _say(msg: str) -> None:
    print(msg, flush=True)


def _card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


class Check:
    """Collects kernel-vs-plain errors per kernel."""

    def __init__(self):
        self.max_abs = {}

    def core(self, kernel: str, name: str, got, ref, tol: float,
             absolute: float = None) -> None:
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
        _say(f"  {kernel:17s} {name:8s} max_abs={err:.3e} rel={rel:.3e} "
             f"bound={bound:.1e}")
        self.max_abs[kernel] = max(self.max_abs.get(kernel, 0.0), err)
        if not err <= bound:
            raise AssertionError(f"{kernel}/{name}: kernel vs plain error "
                                 f"{err:.3e} above {bound:.1e}")


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
    for dtv, tc in ((0.0, 0.0), (dt, cfg.transport_coeff)):
        sc = (cfg.rho0, cfg.p0, cfg.c_f, cfg.inv_sigma0, tc, cfg.gravity_g,
              cfg.mu, cfg.wall_visc_factor)
        got = fc.fused_step_cores(spec, lay, *args, dtv, *sc)
        ref = fc.fused_step_cores_plain(spec, lay, *args, dtv, *sc)
        torch.cuda.synchronize()
        for k in sorted(ref):
            check.core("fused_step", f"{label}:{k}" + ("" if tc else "@0"),
                       got[k], ref[k], TOL_STEP,
                       _abs_bound(k, TOL_STEP, cfg.p0, 0.0))

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
            raise AssertionError(f"fused_chunk ({label}, n_sub={n_sub}): "
                                 f"steps {gs} / plain {rs}, expected "
                                 f"{want if want is not None else rs}")
        if want is None:
            # the interval ends inside the chunk: the clamp lands on it
            if not 1 < gs < n_sub or float(got[3]) != float(ref[3]):
                raise AssertionError(
                    f"fused_chunk ({label}): {gs} steps, t={float(got[3])!r}"
                    f" / plain {float(ref[3])!r} at interval {interval}")
        tol = TOL_STEP if n_sub == 1 else TOL_CHUNK
        cnt = 0.0 if n_sub == 1 else CNT_CHUNK
        tag = f"{label}{n_sub}"
        for part in (0, 1):
            for k in sorted(ref[part]):
                check.core("fused_chunk", f"{tag}:{k}", got[part][k],
                           ref[part][k], tol, _abs_bound(k, tol, cfg.p0, cnt))
        for i, k in ((3, "t"), (4, "t_comp")):
            check.core("fused_chunk", f"{tag}:{k}", got[i].reshape(1),
                       ref[i].reshape(1), tol * 1e-3)
        _say(f"  fused_chunk ({label}) n_sub={n_sub} interval={interval} "
             f"steps={gs} t={float(got[3]):.9e} plain t={float(ref[3]):.9e}")

    # the wall shear on the stepped cores, as the engine calls it
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


def _run_cli(name: str, ini_text, extra) -> dict:
    """One in-process CLI run; returns the result dict of the run."""
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
    try:
        t0 = time.perf_counter()
        rc = cli.main(["--config", ini, "--base-dir", base,
                       "--device", "cuda"] + list(extra))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        simulation.Simulation.run = orig_run
    res = captured["result"]
    res["rc"] = rc
    res["wall_total"] = wall
    return res


def phase_main() -> dict:
    import math
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc

    counts = {}
    # (a) config.ini as shipped (20 s), through the CLI with its defaults
    fcc.reset_launch_counts()
    ra = _run_cli("a_config_ini", None, [])
    counts["a"] = dict(fcc.LAUNCHES)
    _say(f"main (a) config.ini: rc={ra['rc']} L2={100 * ra['L2_error']:.4f}% "
         f"steps={ra['step']} t={ra['t']:.3f} "
         f"tau_bottom={ra['tau_bottom']:.5f} "
         f"psteps/s={ra['particle_steps_per_sec']:.4e} "
         f"host_syncs={ra['host_syncs']} launches={counts['a']}")
    if ra["rc"] != 0 or not ra["passed"]:
        raise AssertionError(f"(a) config.ini: L2 {ra['L2_error']:.4%} "
                             "did not pass the 5% gate")
    if not math.isfinite(ra["tau_bottom"]):
        raise AssertionError("(a) config.ini: non-finite tau")

    # (b) the dp=0.01 channel with the shipping knobs, a few tenths of s
    ini = ("[physical]\nDL = 3.0\nDH = 1.0\ndp = 0.01\nrho0 = 1.0\n"
           "mu = 0.1\nU_bulk = 0.666667\nc_f = 15.0\n"
           f"[simulation]\nend_time = {DP001['end_time']}\n"
           f"output_interval = {DP001['output_interval']}\n"
           "sort_interval = 100\nrestart_from_file = 0\n")
    fcc.reset_launch_counts()
    rb = _run_cli("b_dp001", ini,
                  ["--neighbor-skin", str(DP001["neighbor_skin"]),
                   "--rebuild-every", "128", "--cell-capacity", "14",
                   "--lane-pack-nx", "100"])
    counts["b"] = dict(fcc.LAUNCHES)
    taus = [tb for _, tb, _ in rb["tau_history"]]
    vmaxs = rb["v_max_history"]
    st = rb["final_state"]
    import torch
    finite = all(bool(torch.isfinite(getattr(st, f)).all())
                 for f in st._fields)
    _say(f"main (b) dp=0.01: steps={rb['step']} t={rb['t']:.3f} "
         f"tau_bottom={['%.5f' % v for v in taus]} "
         f"v_max={['%.4f' % v for v in vmaxs]} "
         f"psteps/s={rb['particle_steps_per_sec']:.4e} "
         f"host_syncs={rb['host_syncs']} launches={counts['b']}")
    from sph_poiseuille_flow_torch.config import derive_config
    tau_target = derive_config(**DP001).tau_target
    if not finite or not all(math.isfinite(v) for v in taus):
        raise AssertionError("(b) dp=0.01: non-finite state or tau")
    if not all(b > a for a, b in zip(taus, taus[1:])) or taus[0] <= 0:
        raise AssertionError(f"(b) dp=0.01: tau not rising: {taus}")
    if not all(b > a for a, b in zip(vmaxs, vmaxs[1:])) or vmaxs[0] <= 0:
        raise AssertionError(f"(b) dp=0.01: v_max not rising: {vmaxs}")
    if not taus[-1] < 1.2 * tau_target:
        raise AssertionError(f"(b) dp=0.01: tau {taus[-1]} overshoots "
                             f"tau_target {tau_target}")
    for run, c in counts.items():
        for k, v in c.items():
            if v <= 0:
                raise AssertionError(f"main ({run}): kernel {k} was never "
                                     "launched")
    return dict(a=ra, b=rb, counts=counts)


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


def phase_timing(k: dict) -> dict:
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    spec, lay, args, sc, dt, sh = (k[n] for n in ("spec", "lay", "args",
                                                  "sc", "dt", "sh"))
    out = {}
    # plain first, then kernel, kernel, plain (one card, in turns)
    pairs = {
        "fused_step": (
            lambda: fc.fused_step_cores(spec, lay, *args, dt, *sc),
            lambda: fc.fused_step_cores_plain(spec, lay, *args, dt, *sc), 20),
        "fused_chunk": (
            lambda: fc.fused_chunk_call(spec, lay, *args, 0.0, 0.0, 1.0, 16,
                                        *sc),
            lambda: fc.fused_chunk_call_plain(spec, lay, *args, 0.0, 0.0,
                                              1.0, 16, *sc), 5),
        "fused_wall_shear": (
            lambda: fc.fused_wall_shear_cores(spec, lay, *sh),
            lambda: fc.fused_wall_shear_cores_plain(spec, lay, *sh), 20),
    }
    for name, (kern, plain, reps) in pairs.items():
        p1 = _time(plain, reps)
        k1 = _time(kern, reps)
        k2 = _time(kern, reps)
        p2 = _time(plain, reps)
        out[name] = (min(k1, k2), min(p1, p2))
        _say(f"timing {name:17s} kernel {k1:.4f}/{k2:.4f} ms, plain "
             f"{p1:.4f}/{p2:.4f} ms per call")
    return out


# the TPU kernel each CUDA kernel replaces: _step_kernel/_kernel_body via
# _fused_call, _chunk_kernel via fused_chunk_call, _shear_kernel via
# fused_wall_shear_cores
REPLACES = {
    "fused_step": "sph_poiseuille_flow_tpu/ops/fused_cell.py:560",
    "fused_chunk": "sph_poiseuille_flow_tpu/ops/fused_cell.py:1550",
    "fused_wall_shear": "sph_poiseuille_flow_tpu/ops/fused_cell.py:1928",
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
    card = _card_line()
    _say(f"card: {card}; torch {torch.__version__} cuda "
         f"{torch.version.cuda}; python {sys.version.split()[0]}")

    check = Check()
    try:
        t0 = time.perf_counter()
        phase_build()
        kern = {label: phase_kernels(device, check, label, cfg)
                for label, cfg in _grids()}
        main_res = phase_main()
        timing = phase_timing(kern["b"])
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
        ms, plain_ms = timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "sph_poiseuille_flow_torch/csrc/fused_cell.cu",
            "replaces": where,
            "launches": sum(c[name] for c in main_res["counts"].values()),
            "max_abs_err": check.max_abs[name], "ms": ms,
            "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    for run in ("a", "b"):
        r = main_res[run]
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
