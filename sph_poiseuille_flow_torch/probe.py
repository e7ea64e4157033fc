"""Sweep decomposition of the fused step (the port of the JAX package's
experiments/profile_r3.py, with the prefix timings of
experiments/profile_fused.py).

    python -m sph_poiseuille_flow_torch.probe [dp] [warm_t] [K_cap]
        [skin_mul] [--device cuda|cpu] [--lane-pack-nx N]
        [--rebuild-every N] [--geom-cache none|auto|full|ring|partial]
        [--geom-kcut N] [--fused-rows auto|0|1] [--n N]

On profile_r3's channel (DL=3, DH=1, mu=0.1, c_f=15; defaults dp=0.025,
warm_t=2.0, K_cap=18, skin_mul=0.75, rebuild_every=32) it builds the fused
engine, runs ``init``, develops the flow with ``run_interval`` to warm_t,
prints the occupancy statistics that bound the sweeps' k-loops, and times
the step in the form ``step_form`` resolves (default ``--geom-cache
none``, the recompute body the TPU probe runs):

* the full step through its wrapper (``fused_step_cores``, fresh buffers
  per call) and on persistent buffers (``StepBuffers``): the difference is
  the wrapper's cost;
* each sweep alone, relaunched over a completed step's buffers, their sum,
  and each prefix 0 .. n-1 with its marginal sweep;
* the no-op through the wrapper (``fused_noop``) and on the buffers;
* the one-hot lane tiling (``expand_onehot``) at the window's (9K, nx).

With CUDA events around ``--n`` launches enqueued without a sync, after a
warm-up, best of three: the wrapper calls as a caller sees them, the
launches on persistent buffers queued behind a spin kernel, so that they
measure device time and not the host's enqueue rate (about 20 us per
wrapper call). Each sweep's time inside the step, the marginal of its
prefix (``sweep{s}_in_step``), stands beside its relaunched time. Each
kernel time is printed beside its bound
(``utils/roofline.py``), its plain version's time on the same card tensors
(``plain_*``, as called) and, for the no-op and the expand, the one
PyTorch call that computes the same (``library_*``). The last line is one
JSON object ``{"probe": {...}}`` with the card's name and power limit.
``--device cpu`` runs the plain versions and times one round
of them with the host clock, under keys that start with ``cpu_``: those
are no device times. ``--device cuda`` (the default) raises without a card.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from .config import derive_config
from .models.poiseuille import build_scene
from .ops import fused_cell as fc
from .ops import fused_cell_cuda as fcc
from .ops import probes
from .ops.cellgrid import assign_slots
from .stepper import PallasCellEngine, initial_state
from .utils import roofline

# spin cycles queued ahead per timed launch: about 100 us at the H100's
# 1.98 GHz, above the host's cost of one relaunch
SPIN_PER_LAUNCH = 2e5


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m sph_poiseuille_flow_torch.probe",
        description="per-sweep cost and occupancy of the fused step")
    p.add_argument("dp", nargs="?", type=float, default=0.025)
    p.add_argument("warm_t", nargs="?", type=float, default=2.0,
                   help="simulated seconds of flow before the timings")
    p.add_argument("K_cap", nargs="?", type=int, default=18,
                   help="cell capacity K")
    p.add_argument("skin_mul", nargs="?", type=float, default=0.75,
                   help="neighbor skin in units of dp")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the kernels (raises without a card); cpu: "
                        "their plain versions, host-clock times")
    p.add_argument("--lane-pack-nx", type=int, default=0)
    p.add_argument("--rebuild-every", type=int, default=32)
    p.add_argument("--geom-cache", default="none",
                   choices=["auto", "full", "ring", "partial", "none"])
    p.add_argument("--geom-kcut", type=int, default=0)
    p.add_argument("--fused-rows", default="auto", choices=["auto", "0", "1"])
    p.add_argument("--n", type=int, default=200,
                   help="launches per timing")
    return p


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def occupancy(spec, state) -> dict:
    """profile_r3.py:55-82: per-row and per-group max cell occupancy (the
    k-loop bound of a row group), the mean over occupied cells, and which
    rows hold fluid (F), wall (W) or nothing (-)."""
    R, L, n_groups, nyp = fc.plan(spec)
    slot, _ = assign_slots(spec, state.x, state.y)
    cell = (slot // spec.K).cpu().numpy()
    counts = np.bincount(np.minimum(cell, spec.n_cells - 1),
                         minlength=spec.n_cells).reshape(spec.ny, spec.nx)
    occ_rows = np.zeros((nyp, spec.nx), np.int64)
    occ_rows[:spec.ny] = counts
    y = state.y.cpu().numpy()
    cy = np.clip(((y - spec.y0) / spec.cell_y).astype(int), 0, spec.ny - 1)
    kinds = []
    for r in range(spec.ny):
        idx = np.nonzero(cy == r)[0]
        kinds.append(("F" if (idx < spec.n_fluid).any() else "")
                     + ("W" if (idx >= spec.n_fluid).any() else "")
                     or "-")
    return dict(row_max=occ_rows.max(axis=1).tolist(),
                group_max=occ_rows.reshape(n_groups, R * spec.nx)
                .max(axis=1).tolist(),
                mean=float(counts[counts > 0].mean()),
                max=int(counts.max()),
                cell_max=counts.max(axis=1).tolist(), kinds=kinds)


def event_ms(fn, n: int, queued: bool = False) -> float:
    """ms per launch: CUDA events around ``n`` launches enqueued without a
    sync, after a warm-up, best of three. ``queued``: the launches wait
    behind a spin kernel long enough for the host to enqueue them all, so
    the card never waits for the host and the events measure device time;
    without it a call is timed as its caller sees it, host cost
    included."""
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(3):
        if queued:
            torch.cuda._sleep(int(n * SPIN_PER_LAUNCH))
        e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        e[0].record()
        for _ in range(n):
            fn()
        e[1].record()
        torch.cuda.synchronize()
        best = min(best, e[0].elapsed_time(e[1]) / n)
    return best


def _host(fn, n: int) -> float:
    """ms per call of a CPU function by the host clock, one round of ``n``
    calls: a check that the path runs, not a device time."""
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n


def _time_cuda(spec, lay, cores, dt, sc, form, n: int) -> dict:
    """The probe's times on the card: the wrapper calls as a caller sees
    them, the launches on persistent buffers as device time; beside them
    the plain versions on the same card tensors, as called, and the one
    PyTorch call that computes the same function where there is one
    (``library_*``: the no-op's row copy, the expand's ``repeat``)."""
    R = fc.plan(spec)[0]
    bufs = fcc.StepBuffers(spec, R, lay, *cores, dt, sc, *form)
    ms = {"step_call": event_ms(
        lambda: fc.fused_step_cores(spec, lay, *cores, dt, *sc), n),
        "step_bufs": event_ms(lambda: bufs.sweeps(0, 4), n, queued=True)}
    full = probes.fused_step_sweeps_plain(spec, lay, *cores, dt, *sc)
    for s in range(4):
        ms[f"sweep{s}"] = event_ms(lambda s=s: bufs.sweeps(s, 1), n,
                                   queued=True)
        ms[f"plain_sweep{s}"] = event_ms(
            lambda s=s: probes.fused_step_sweeps_plain(
                spec, lay, *cores, dt, *sc, first=s, count=1, prior=full),
            n)
    for k in range(1, 5):
        ms[f"prefix{k}"] = event_ms(lambda k=k: bufs.sweeps(0, k), n,
                                   queued=True)
    # each sweep's time inside the step: the marginal of its prefix
    for s in range(4):
        ms[f"sweep{s}_in_step"] = (ms[f"prefix{s + 1}"]
                                   - ms.get(f"prefix{s}", 0.0))
    ms["noop_call"] = event_ms(
        lambda: probes.fused_noop(spec, lay, *cores, dt, *sc), n)
    ms["noop_bufs"] = event_ms(bufs.noop, n, queued=True)
    ms["plain_noop"] = event_ms(
        lambda: probes.fused_noop_plain(spec, lay, *cores, dt, *sc), n)
    row = torch.zeros_like(cores[0][0, 0, :])
    ms["library_noop"] = event_ms(lambda: row.copy_(cores[0][0, 0, :]), n,
                                  queued=True)
    v = _expand_input(spec, cores[0].device)
    ms["expand"] = event_ms(lambda: probes.expand_onehot(v, spec.K), n,
                           queued=True)
    ms["plain_expand"] = event_ms(
        lambda: probes.expand_onehot_plain(v, spec.K), n)
    ms["library_expand"] = event_ms(lambda: v.repeat(1, spec.K), n,
                                    queued=True)
    return ms


def _time_cpu(spec, lay, cores, dt, sc, n: int) -> dict:
    full = probes.fused_step_sweeps_plain(spec, lay, *cores, dt, *sc)
    ms = {"cpu_step": _host(
        lambda: fc.fused_step_cores(spec, lay, *cores, dt, *sc), n)}
    for s in range(4):
        ms[f"cpu_sweep{s}"] = _host(
            lambda s=s: probes.fused_step_sweeps_plain(
                spec, lay, *cores, dt, *sc, first=s, count=1, prior=full), n)
    for k in range(1, 5):
        ms[f"cpu_prefix{k}"] = _host(
            lambda k=k: probes.fused_step_sweeps_plain(
                spec, lay, *cores, dt, *sc, first=0, count=k), n)
    ms["cpu_noop"] = _host(
        lambda: probes.fused_noop(spec, lay, *cores, dt, *sc), n)
    v = _expand_input(spec, cores[0].device)
    ms["cpu_expand"] = _host(lambda: probes.expand_onehot(v, spec.K), n)
    return ms


def _expand_input(spec, device) -> torch.Tensor:
    """(9K, nx) values that need more than 10 mantissa bits, from a seed."""
    rng = np.random.default_rng(3)
    shape = (9 * spec.K, spec.nx)
    v = np.where(rng.random(shape) < 0.5,
                 rng.integers(1, 8192, shape) * 2 + 1,
                 rng.random(shape) * 3.0).astype(np.float32)
    return torch.as_tensor(v, device=device)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(torch.cuda.is_available() is False); pass "
                           "--device cpu to run the plain versions")
    device = torch.device(args.device)
    dp = args.dp
    cfg = derive_config(
        DL=3.0, DH=1.0, dp=dp, rho0=1.0, mu=0.1, U_bulk=0.666667, c_f=15.0,
        end_time=20.0, output_interval=0.5, sort_interval=100,
        restart_from_file=False, neighbor_skin=args.skin_mul * dp,
        rebuild_every=args.rebuild_every, cell_capacity=args.K_cap,
        neighbor_capacity=56, lane_pack_nx=args.lane_pack_nx,
        geom_cache=args.geom_cache, geom_kcut=args.geom_kcut,
        fused_rows=args.fused_rows)
    scene = build_scene(cfg)
    eng = PallasCellEngine(cfg, scene, device)
    spec = eng.spec
    R, L, n_groups, nyp = fc.plan(spec)
    form = fc.step_form(spec, torch.float32)
    card = card_line() if device.type == "cuda" else None
    print(f"spec: nx={spec.nx} ny={spec.ny} K={spec.K} n={spec.n_total} "
          f"n_fluid={spec.n_fluid}; plan R={R} L={L} n_groups={n_groups} "
          f"nyp={nyp} 9K={9 * spec.K}; form {form[0]} (k_cut {form[1]})"
          f"; {card or 'cpu: plain versions, host clock'}", flush=True)

    state = initial_state(cfg, scene, device)
    state, lay, geom, overflow = eng.init(state)
    if bool(overflow):
        raise RuntimeError(f"init overflows K={spec.K}")
    t = 0.0
    while t < args.warm_t:
        span = min(0.5, args.warm_t - t)
        res = eng.run_interval(state, lay, geom, span)
        state, lay, geom = res.state, res.cands, res.geom
        t += span
        if bool(res.overflow):
            occ = occupancy(spec, res.state)
            raise RuntimeError(
                f"overflow at t={t:.2f}s: a cell of this grid (nx={spec.nx},"
                f" cell {spec.cell_x / dp:.2f}dp x {spec.cell_y / dp:.2f}dp)"
                f" holds {occ['max']} particles, K={spec.K}; raise K_cap, "
                "shorten warm_t or narrow the cells with --lane-pack-nx")
    print(f"developed to t={t:.2f}s", flush=True)

    occ = occupancy(spec, state)
    print("per-row max occ:", occ["row_max"])
    print("per-group max occ (kmax):", occ["group_max"])
    print(f"mean cell occ (occupied cells): {occ['mean']:.2f}; max "
          f"{occ['max']}")
    for r, (m, kind) in enumerate(zip(occ["cell_max"], occ["kinds"])):
        print(f"  row {r:2d}: occ_max={m:2d} kind={kind}")

    sc = (cfg.rho0, cfg.p0, cfg.c_f, cfg.inv_sigma0, cfg.transport_coeff,
          cfg.gravity_g, cfg.mu, cfg.wall_visc_factor)
    cores = (fc.make_core(spec, lay.pidx, state.x, fill=fc._BIG_X,
                          xshift=spec.DL),
             fc.make_core(spec, lay.pidx, state.y),
             fc.make_core(spec, lay.pidx, state.vx),
             fc.make_core(spec, lay.pidx, state.vy),
             fc.make_plain(spec, lay.pidx, state.drho_dt))
    dt = 1e-4
    if device.type == "cuda":
        ms = _time_cuda(spec, lay, cores, dt, sc, form, args.n)
        pre = ""
    else:
        ms = _time_cpu(spec, lay, cores, dt, sc, args.n)
        pre = "cpu_"

    n = roofline.pair_counts(spec, lay, cores[0], cores[1])
    both = {f"sweep{s}": roofline.bound(f"sweep{s}", spec, n)
            for s in range(4)}
    both.update(step=roofline.bound("step", spec, n),
                noop=roofline.bound("noop", spec, n),
                expand=roofline.expand_bound(9 * spec.K, spec.nx, spec.K))
    bounds = {k: v[0] for k, v in both.items()}
    tag = "host ms (plain, cpu)" if pre else "ms"
    print(f"pairs: {n['anchors']:.0f} visited anchors, {n['pairs']:.0f} "
          f"valid pairs; times in {tag}, bound in device ms")
    step_ms = ms[pre + "step" if pre else "step_call"]
    print(f"full 4-sweep step call: {step_ms:.4f} (bound "
          f"{bounds['step']:.5f})"
          + ("" if pre else f"; on persistent buffers "
             f"{ms['step_bufs']:.4f}"), flush=True)
    total = sum(ms[f"{pre}sweep{s}"] for s in range(4))
    for s in range(4):
        v = ms[f"{pre}sweep{s}"]
        print(f"sweep {s} only:          {v:.4f} ({100 * v / total:.1f}% "
              f"of the sum; bound {bounds[f'sweep{s}']:.5f}"
              + ("" if pre else f"; plain {ms[f'plain_sweep{s}']:.4f}")
              + ")")
    ms[pre + "sweeps_sum"] = total
    print(f"sum of single sweeps: {total:.4f}")
    prev = 0.0
    for k in range(1, 5):
        v = ms[f"{pre}prefix{k}"]
        print(f"sweeps 0..{k - 1}: {v:.4f} (marginal sweep {k - 1}: "
              f"{v - prev:.4f})")
        prev = v
    if pre:
        print(f"no-op call (fixed cost): {ms['cpu_noop']:.4f}")
    else:
        print(f"no-op call (fixed cost): {ms['noop_call']:.4f} through the "
              f"wrapper, {ms['noop_bufs']:.4f} on persistent buffers "
              f"(bound {bounds['noop']:.1e}; plain {ms['plain_noop']:.4f}, "
              f"row copy_ {ms['library_noop']:.4f})")
    print(f"one-hot expand ({9 * spec.K}, {spec.nx}) x{spec.K}: "
          f"{ms[pre + 'expand']:.4f} (bound {bounds['expand']:.1e}"
          + ("" if pre else f"; plain {ms['plain_expand']:.4f}, repeat "
             f"{ms['library_expand']:.4f}") + ")")
    print(json.dumps({"probe": {
        "device": device.type, "card": card,
        "form": form[0], "k_cut": form[1],
        "spec": dict(dp=dp, nx=spec.nx, ny=spec.ny, K=spec.K,
                     n_total=spec.n_total, n_fluid=spec.n_fluid, R=R,
                     n_groups=n_groups, warm_t=t, n=args.n),
        "occupancy": {k: occ[k] for k in ("row_max", "group_max", "mean",
                                          "max")},
        "pairs": n, "bound_ms": bounds,
        "bound_by": {k: v[1] for k, v in both.items()},
        # no sweep writes what it reads, so no relaunch restores anything;
        # the key stays for comparisons with older probe outputs
        "restore_bytes": 0, "ms": ms}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
