"""Benchmark of the PyTorch port: particle-steps/sec at dp=0.025, plus
secondary metrics at dp=0.01 and dp=0.005 on a CUDA card.

    python3 bench_torch.py [--device cuda|cpu]

The protocol is ``bench.py``'s (bench.py:61-163), run through
``sph_poiseuille_flow_torch``: the DL=3, DH=1 channel (mu=0.1,
U_bulk=0.666667, c_f=15) at dp=0.025 (4,800 fluid particles), with
``engine="auto"``, which is the fused cell-layout engine in float32, and
its shipping knobs: the lane-packed grid with cell_x = 3dp exactly
(``lane_pack_nx = round(1/dp)``), skin 0.3dp, rebuild_every 128, cell
capacity 14, neighbor capacity 56. ``bench.py`` applies these knobs on a
TPU only (its off-TPU "auto" is another engine); the port's "auto" always
runs the fused engine, so they always apply. Five 0.5 s warm intervals
take the flow past the start-up transient (t >= 2.5 s), then five timed
0.5 s intervals at dp=0.025 and, on the card, three each at dp=0.01
(30,000 fluid) and dp=0.005 (120,000 fluid).

Each interval is timed on the host's wall clock with
``torch.cuda.synchronize()`` at both ends, so the host's share of the
loop (its sync per sub-chunk, its launches) counts, as users feel it.
``value`` is the best interval, ``mean_value`` the mean; every interval
is in ``intervals``. An overflow or skin-guard flag raises.

Prints ONE JSON line, ``bench.py``'s schema:
  {"metric": "particle_steps_per_sec_dp0.025", "value": N,
   "unit": "particle-steps/sec", "vs_baseline": N, "mean_value": N,
   "mean_vs_baseline": N, "intervals": [...],
   "secondary": [{... dp0.01 ...}, {... dp0.005 ...}], "card": "..."}
``card`` is ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` (null with ``--device cpu``, which measures only
dp=0.025, with the plain PyTorch twins of the kernels). ``vs_baseline``
divides by ``bench.py``'s ``REF_BASELINE_PSPS``: the repo's C++ oracle
of the reference semantics in float64 on one CPU core, at each scale
(BASELINE.md). ``bench.py``'s ``vs_r2_recorded`` is left out: it
continues a series of TPU rounds (BENCH_r0N.json) that this port's
numbers do not belong to. Per-interval lines go to stderr with the
engine, the kernel form (``fused_cell.chunk_form``) and the launch
counts.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# Matched-scale denominators (particle-steps/s): the C++ oracle of the
# reference semantics (native/sph_oracle.cpp, float64, one CPU core), best
# of 5 quiet-host runs (experiments/time_oracle.py; BASELINE.md); the
# values of bench.py:52
REF_BASELINE_PSPS = {0.025: 1.05e6, 0.01: 7.01e5, 0.005: 7.29e5}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(dp: float, n_timed_intervals: int = 5, interval: float = 0.5,
            n_warm: int = 5, device="cuda") -> dict:
    """Time ``n_timed_intervals`` output intervals of ``interval`` seconds
    at spacing ``dp`` after ``n_warm`` warm intervals, on ``device``
    ("cuda" raises without a card). Returns the metric's dict."""
    from sph_poiseuille_flow_torch import (build_scene, derive_config,
                                           initial_state, make_engine)
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: no CUDA device is available "
                           "(torch.cuda.is_available() is False); pass "
                           "--device cpu to run the plain PyTorch path")
    # cell_x = 3dp exactly where DL divides into such cells: a cell's
    # pristine window holds 3 lattice columns (occupancy 9, 12 at the
    # peak of the 20 s run), so K=14 fits (bench.py:76-86)
    nx3 = round(3.0 / (3.0 * dp))
    lane_nx = nx3 if abs(nx3 * 3.0 * dp - 3.0) < 1e-9 else 0
    cfg = derive_config(
        DL=3.0, DH=1.0, dp=dp, rho0=1.0, mu=0.1, U_bulk=0.666667, c_f=15.0,
        end_time=20.0, output_interval=interval, sort_interval=100,
        restart_from_file=False, engine="auto",
        neighbor_skin=0.3 * dp, rebuild_every=128,
        cell_capacity=14 if lane_nx else 18,
        lane_pack_nx=lane_nx, neighbor_capacity=56)
    scene = build_scene(cfg)
    engine = make_engine(cfg, scene, device)
    form = fc.chunk_form(engine.spec, engine.dtype)
    state = initial_state(cfg, scene, device)
    state, cands, geom, overflow = engine.init(state)
    if bool(overflow):
        raise RuntimeError(f"dp={dp:g}: neighbor cell overflow at init")

    # past the start-up transient into developed flow (t >= 2.5 s), the
    # regime of 17.5 of the 20 s run (bench.py:108-117)
    for _ in range(n_warm):
        res = engine.run_interval(state, cands, geom, np.float32(interval))
        state, cands, geom = res.state, res.cands, res.geom
        if bool(res.overflow) or res.skin_guard:
            raise RuntimeError(f"dp={dp:g}: neighbor cell overflow or skin "
                               "guard in the warm-up")
    _sync(device)

    per_interval = []
    for i in range(n_timed_intervals):
        fcc.reset_launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        res = engine.run_interval(state, cands, geom, np.float32(interval))
        _sync(device)
        elapsed = time.perf_counter() - t0
        state, cands, geom = res.state, res.cands, res.geom
        if bool(res.overflow):
            raise RuntimeError(f"dp={dp:g}: neighbor cell overflow")
        if res.skin_guard:
            raise RuntimeError(f"dp={dp:g}: skin displacement guard tripped")
        psps = res.n_steps * scene.n_fluid / elapsed
        per_interval.append((psps, res.n_steps, elapsed))
        launches = {k: v for k, v in fcc.LAUNCHES.items() if v}
        print(f"# dp={dp:g} interval {i}: {res.n_steps} steps in "
              f"{elapsed:.4f}s = {psps:.4e} psteps/s; engine "
              f"{type(engine).__name__} form {form} on {device.type}; "
              f"host syncs {res.n_syncs}, rollbacks {res.n_rollbacks}; "
              f"launches {launches}", file=sys.stderr)

    psps, steps, elapsed = max(per_interval)
    mean_psps = float(np.mean([p for p, _, _ in per_interval]))
    denom = REF_BASELINE_PSPS[dp]
    tot_steps = sum(s for _, s, _ in per_interval)
    tot_elapsed = sum(e for _, _, e in per_interval)
    print(f"# dp={dp:g} best interval: {steps} steps in {elapsed:.4f}s; "
          f"total timed: {tot_steps} steps x {scene.n_fluid} fluid "
          f"particles in {tot_elapsed:.4f}s on {device.type}",
          file=sys.stderr)
    return {
        "metric": f"particle_steps_per_sec_dp{dp:g}",
        "value": round(psps, 1),
        "unit": "particle-steps/sec",
        "vs_baseline": round(psps / denom, 3),
        "mean_value": round(mean_psps, 1),
        "mean_vs_baseline": round(mean_psps / denom, 3),
        "intervals": [round(p, 1) for p, _, _ in per_interval],
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda: the hand-written kernels, all three "
                             "scales (raises without a card); cpu: the "
                             "plain PyTorch twins, dp=0.025 only")
    args = parser.parse_args(argv)
    out = measure(0.025, device=args.device)
    card = None
    if args.device == "cuda":
        out["secondary"] = [measure(0.01, n_timed_intervals=3),
                            measure(0.005, n_timed_intervals=3)]
        from sph_poiseuille_flow_torch.probe import card_line
        card = card_line()
    out["card"] = card
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
