#!/usr/bin/env python3
"""Time the lane-batched sweep of a per-step engine against the number of
lanes resident at once.

    python3 tools/sweep_lanes.py [--lanes 1,4,8] [--engine cellgrid]
        [--dtype float64] [--end-time 0.2] [--device cuda]

On ``config.ini`` (dp=0.05) with the chosen per-step engine, each lane
count n runs ``parallel.run_sweep`` over the first n of the eight mu of
docs/VALIDATION.md's sweep, in one chunk, for ``--end-time`` seconds of
flow in one output interval, after an untimed warm-up sweep of the same
lanes over one step's worth of time. Before them, one lane runs alone
through the engine's own ``run_interval`` (the un-mapped loop) for the
same time. Each figure is the wall clock of the sweep's intervals with
``torch.cuda.synchronize()`` at both ends (``run_sweep``'s
``wall_time``), so the host's share counts. Prints the card's name and
power limit (on a card), one line per lane count, and last one JSON
line: ``{"sweep_lanes": {"card": ..., "single": {...}, "lanes": {n:
{"lane_steps", "batched_steps", "wall_s", "ms_per_lane_step",
"ms_per_batched_step"}}}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MUS = (0.05, 0.075, 0.1, 0.125, 0.15, 0.2, 0.25, 0.3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", default="1,4,8")
    ap.add_argument("--engine", default="cellgrid",
                    choices=["cellgrid", "gather"])
    ap.add_argument("--dtype", default="float64",
                    choices=["float32", "float64"])
    ap.add_argument("--end-time", type=float, default=0.2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from sph_poiseuille_flow_torch.config import load_config
    from sph_poiseuille_flow_torch.models.poiseuille import build_scene
    from sph_poiseuille_flow_torch.parallel import make_workloads, run_sweep
    from sph_poiseuille_flow_torch.stepper import initial_state, make_engine

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    device = torch.device(args.device)
    card = None
    if device.type == "cuda":
        from sph_poiseuille_flow_torch.probe import card_line
        card = card_line()
        print(f"card: {card}", flush=True)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def cfg_for(end_time):
        return load_config(
            os.path.join(ROOT, "config.ini"), engine=args.engine,
            dtype=args.dtype, ini_overrides={"simulation": dict(
                end_time=end_time, output_interval=end_time)})

    cfg = cfg_for(args.end_time)
    scene = build_scene(cfg)
    eng = make_engine(cfg, scene, device)
    s, lay, geom, _ = eng.init(initial_state(cfg, scene, device))
    eng.run_interval(s, lay, geom, np.dtype(cfg.dtype).type(1e-3))
    sync()
    t0 = time.perf_counter()
    r = eng.run_interval(s, lay, geom, np.dtype(cfg.dtype).type(
        args.end_time))
    sync()
    wall = time.perf_counter() - t0
    single = dict(steps=r.n_steps, wall_s=wall,
                  ms_per_step=1e3 * wall / r.n_steps)
    print(f"single lane, run_interval: {r.n_steps} steps in {wall:.3f} s, "
          f"{single['ms_per_step']:.4f} ms a step", flush=True)

    lanes = {}
    for n in (int(v) for v in args.lanes.split(",")):
        gs, mus = make_workloads(cfg, MUS[:n])
        run_sweep(cfg_for(1e-3), gs, mus, log=lambda _: None,
                  device=device)
        logged = []
        out = run_sweep(cfg, gs, mus, log=logged.append, device=device)
        steps = out["total_lane_steps"]
        # lanes run in lockstep: the batch takes its longest lane's steps
        per_lane = [json.loads(ln.split("steps/lane=")[1].split("]")[0]
                               + "]") for ln in logged
                    if "steps/lane=" in ln]
        batched = sum(max(v) for v in per_lane)
        lanes[n] = dict(lane_steps=steps, batched_steps=batched,
                        wall_s=out["wall_time"],
                        ms_per_lane_step=1e3 * out["wall_time"] / steps,
                        ms_per_batched_step=1e3 * out["wall_time"]
                        / batched)
        print(f"{n} lanes: {steps} lane-steps ({batched} batched steps) in "
              f"{out['wall_time']:.3f} s: "
              f"{lanes[n]['ms_per_lane_step']:.4f} ms per lane-step, "
              f"{lanes[n]['ms_per_batched_step']:.4f} ms per batched step "
              f"(L2 {np.round(out['l2_errors'], 4).tolist()})", flush=True)
    print(json.dumps({"sweep_lanes": dict(
        card=card, engine=args.engine, dtype=args.dtype,
        end_time=args.end_time, device=str(device), single=single,
        lanes=lanes)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
