"""CLI driver of the PyTorch port (same flags as the JAX package's
``run.py``, plus ``--device``).

Usage:
    python -m sph_poiseuille_flow_torch.run [--config config.ini]
        [--device cuda|cpu] [options]

``--device cuda`` (the default) needs a CUDA card and raises without one;
the run never moves to the CPU on its own. ``--device cpu`` runs the
plain PyTorch twins of the kernels (slow, for tiny configs and tests).
Path overrides honor the reference's environment variables
(SPH_Poiseuille.m:19-26): SPH_CONFIG_OVERRIDE, SPH_RESTART_PATH_OVERRIDE,
SPH_RESULT_PNG_OVERRIDE, SPH_PROFILE_PNG_OVERRIDE,
SPH_POSTPROCESS_MAT_OVERRIDE.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import torch

from .config import ConfigError, env_override, load_config
from .simulation import Simulation, SimulationPaths


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="sph_poiseuille_flow_torch",
        description="2D weakly-compressible SPH Poiseuille solver "
                    "(PyTorch + hand-written CUDA kernels)")
    parser.add_argument("--config", default=None,
                        help="path to config.ini (default ./config.ini, "
                             "overridable via SPH_CONFIG_OVERRIDE)")
    parser.add_argument("--base-dir", default=".",
                        help="base directory for outputs")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda: the hand-written kernels (raises "
                             "without a CUDA card); cpu: their plain "
                             "PyTorch twins")
    parser.add_argument("--engine", default="auto",
                        choices=["auto", "cellgrid", "pallas", "gather"],
                        help="pallas: the fused cell-layout engine (its "
                             "CUDA kernels are float32); cellgrid: the "
                             "cell-layout engine of plain torch ops; "
                             "gather: the packed-gather engine of plain "
                             "torch ops (both float32 or float64 on either "
                             "device); auto: pallas for float32, cellgrid "
                             "for float64")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "float64"],
                        help="state dtype; float64 runs through the "
                             "cellgrid engine (which auto picks for it) "
                             "on either device")
    parser.add_argument("--cell-capacity", type=int, default=16,
                        help="neighbor-grid per-cell capacity")
    parser.add_argument("--neighbor-skin", type=float, default=0.0,
                        help="extra candidate radius enabling candidate "
                             "reuse across steps")
    parser.add_argument("--rebuild-every", type=int, default=1,
                        help="candidate-list rebuild cadence cap in steps")
    parser.add_argument("--lane-pack-nx", type=int, default=0,
                        help="grid column count (0 = the JAX package's "
                             "cost-model pick)")
    parser.add_argument("--geom-cache", default="auto",
                        choices=["auto", "full", "ring", "partial", "none"],
                        help="pair-geometry cache of the fused kernels: "
                             "none recomputes the geometry in every sweep; "
                             "full and ring cache it for every anchor rank "
                             "(one form on the GPU); partial caches ranks "
                             "below --geom-kcut and recomputes the rest; "
                             "auto picks as the JAX package does (env "
                             "SPH_GEOM_CACHE overrides)")
    parser.add_argument("--geom-kcut", type=int, default=0,
                        help="anchor ranks cached by --geom-cache partial "
                             "(0 = the JAX package's budget pick; env "
                             "SPH_GEOM_KCUT overrides)")
    parser.add_argument("--sub-steps", type=int, default=16,
                        help="steps per chunk call (capped by "
                             "--rebuild-every)")
    parser.add_argument("--fused-rows", default="auto",
                        choices=["auto", "0", "1"],
                        help="1: the candidate-row-outer fused kernels "
                             "(a shared-memory window on the GPU; no "
                             "geometry cache); 0/auto: the slot-outer form "
                             "(env SPH_FUSED_ROWS overrides)")
    parser.add_argument("--plan-r", type=int, default=0,
                        help="row-group width R of the anchor-rank bound "
                             "(0 = the JAX package's pick)")
    parser.add_argument("--celly-margin", type=float, default=0.06,
                        help="cell_y lattice-aliasing margin in dp units")
    parser.add_argument("--max-steps-per-dispatch", type=int, default=0,
                        help="split each output interval into engine calls "
                             "of at most N steps (0 = one call); "
                             "trajectory-preserving")
    parser.add_argument("--step-log-every", type=int, default=0,
                        help="print a per-step log row every N steps "
                             "(SPH_Poiseuille.m:285-291); N > 0 runs the "
                             "interval step by step with the wall shear "
                             "every step (one host sync per step)")
    parser.add_argument("--wall-visc-factor", type=float, default=4.0,
                        help="one-sided wall viscous factor (4.0 = the "
                             "reference's hard-coded calibration)")
    parser.add_argument("--calibrated", action="store_true",
                        help="shorthand for --wall-visc-factor 4.35 "
                             "(docs/VALIDATION.md)")
    parser.add_argument("--postprocess-only", metavar="NPZ", default=None,
                        help="run only the postprocess stage on an existing "
                             "handoff file")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="capture a torch.profiler trace of the run "
                             "into DIR (trace.json for chrome://tracing or "
                             "Perfetto, summary.json: device busy share "
                             "and device time by kernel per interval)")
    parser.add_argument("--set", metavar="SECTION.KEY=VALUE", default=[],
                        action="append", dest="overrides",
                        help="override a config.ini value, e.g. "
                             "--set physical.dp=0.025 (repeatable)")
    parser.add_argument("--sweep-mus", metavar="MU1,MU2,...", default=None,
                        help="run a (g, mu) sweep: one workload per mu, g "
                             "scaled to keep U_bulk (per-lane L2 lines; "
                             "exit 0 only if every lane passes)")
    parser.add_argument("--sweep-lane-chunk", type=int, default=None,
                        help="max sweep lanes resident at once on the "
                             "cellgrid and gather engines (default: all); "
                             "ignored on the fused engine, whose lanes run "
                             "one at a time")
    parser.add_argument("--mesh", type=int, default=None, metavar="N",
                        help="run the whole pipeline over an N-slab mesh "
                             "(y-slabs of the fused or cell-layout engine, "
                             "neighbor-row blocks of the gather engine) in "
                             "one process: slab i on cuda:i where N cards "
                             "exist, else every slab on cuda:0 (with "
                             "SPH_DRYRUN_REAL_DEVICES set: a raise); N "
                             "CPU slabs with --device cpu")
    args = parser.parse_args(argv)

    if args.postprocess_only:
        from .utils.postprocess import postprocess_file
        result = postprocess_file(args.postprocess_only)
        return 0 if result["passed"] else 1

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(torch.cuda.is_available() is False); pass "
                           "--device cpu to run the plain PyTorch path")

    config_path = args.config or env_override(
        "SPH_CONFIG_OVERRIDE", os.path.join(args.base_dir, "config.ini"))
    ini_overrides = {}
    for item in args.overrides:
        try:
            key, value = item.split("=", 1)
            section, name = key.split(".", 1)
        except ValueError:
            parser.error(f"--set expects SECTION.KEY=VALUE, got {item!r}")
        ini_overrides.setdefault(section, {})[name] = float(value)
    wall_visc_factor = 4.35 if args.calibrated else args.wall_visc_factor
    try:
        cfg = load_config(
            config_path, engine=args.engine, dtype=args.dtype,
            cell_capacity=args.cell_capacity, lane_pack_nx=args.lane_pack_nx,
            neighbor_skin=args.neighbor_skin, rebuild_every=args.rebuild_every,
            wall_visc_factor=wall_visc_factor,
            step_log_every=args.step_log_every,
            geom_cache=args.geom_cache, geom_kcut=args.geom_kcut,
            sub_steps=args.sub_steps, fused_rows=args.fused_rows,
            plan_r=args.plan_r,
            celly_margin=args.celly_margin,
            max_steps_per_dispatch=args.max_steps_per_dispatch,
            ini_overrides=ini_overrides)
    except ConfigError as e:
        parser.error(str(e))

    paths = SimulationPaths.from_env(args.base_dir)
    if args.profile:
        from .utils.profile import traced
        capture = traced(args.profile, torch.device(args.device))
    else:
        capture = contextlib.nullcontext()
    if args.sweep_mus:
        from .parallel import make_workloads, run_sweep
        mus = [float(v) for v in args.sweep_mus.split(",") if v.strip()]
        gs, mus = make_workloads(cfg, mus)
        with capture:
            out = run_sweep(cfg, gs, mus, lane_chunk=args.sweep_lane_chunk,
                            paths=paths, device=args.device)
        for k, (mu_k, l2_k) in enumerate(zip(mus, out["l2_errors"])):
            print(f"workload {k}: mu={mu_k:g} L2={100 * l2_k:.3f}%"
                  f" {'PASS' if l2_k < 0.05 else 'FAIL'}")
        print(f"throughput: {out['particle_steps_per_sec']:.3e} "
              f"particle-steps/sec (sum over lanes)")
        return 0 if bool((out["l2_errors"] < 0.05).all()) else 1

    with capture:
        result = Simulation(cfg, paths, device=args.device,
                            mesh_devices=args.mesh).run()
    print(f"throughput: {result['particle_steps_per_sec']:.3e} "
          f"particle-steps/sec over {result['step']} steps")
    print(f"host syncs: {result['host_syncs']} over "
          f"{len(result['tau_history'])} intervals")
    return 0 if result["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
