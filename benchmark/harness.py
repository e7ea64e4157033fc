"""The harness: finds a cell's files by name, checks for the card, runs the
cell's driver, judges the outputs, reads the metrics and prints the
result.

Files, each found by the name that ``BENCHMARK.json`` or another file
gives it:

  workloads/<cell>.json   a traffic mix: its configuration, its driver,
                          the state, the intervals, the check's sampling
                          and the limits of each number compared;
  configs/<name>.json     a configuration: its source, physics, knobs,
                          ``reduced`` and ``assumed``;
  drivers/<name>.py       ``run(conf, workload, seed, seconds, traced,
                          device, t0, engine_wrap) -> Run``;
  metrics/<name>.py       a per-layer metric: LAYER, UNIT, SOURCE, MOVES
                          and ``read(readings) -> float | None``;
  peaks.json              the published peaks of each card.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import traceback

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "sph_poiseuille_flow_tpu")
CACHE_DIR = os.path.join(ROOT, ".bench_cache")


@dataclasses.dataclass
class Run:
    """What a driver hands back: the window's record and what the check
    and the metrics read."""

    seed: int
    device: object
    ch: object                  # reference.sph.Channel
    engine: object
    n_fluid: int
    n_total: int
    mass: object                # the benchmark's particle masses
    st0: object                 # the program's input state
    init: tuple                 # engine.init's (state, layout, pairs, ovf)
    interval: object            # the output interval, in the state's type
    intervals: list             # one dict per output point of the window
    kept: tuple                 # ((state, layout, pairs), result) of the
    #                             sampled interval
    sampled: int                # its number, from 1
    points: list                # host (x, y) at the input and each point
    wall_s: float
    setup_s: float
    launches: dict              # the port's LAUNCHES over the window
    events: list | None         # device operations of a traced window
    memory_peak_bytes: int


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def find(bench_dir: str, kind: str, name: str, ext: str = ".json") -> str:
    path = os.path.join(bench_dir, kind, name + ext)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    return path


def load_module(bench_dir: str, kind: str, name: str):
    """``<bench_dir>/<kind>/<name>.py`` as a module of the benchmark."""
    path = find(bench_dir, kind, name, ".py")
    mod_name = f"benchmark.{kind}.{name}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_entry(spec: dict, cell: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"{cell!r} is not a workload of BENCHMARK.json")


def metrics_of(spec: dict, kind: str, cell: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    names = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(names.intersection(FORBIDDEN))


def set_process_env() -> None:
    """Before torch is imported: every build and kernel cache at a fixed
    path inside the checkout (the port builds its CUDA library into its
    own ``build/`` there), and one host thread for torch's CPU work, so
    that the host loop the cells time does not share its cores with an
    idle thread pool."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def power_limit() -> str | None:
    """``nvidia-smi``'s name and power limit of the cards, or None."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip() or None


def _peaks(bench_dir: str, kind: str):
    for key, v in load_json(os.path.join(bench_dir, "peaks.json")).items():
        if kind.startswith(key):
            return v
    return None


def readings(run, bench_dir: str, kind: str) -> dict:
    """What the per-layer readers read: counters over the window, and in
    a traced window the trace's summary and the least time of its work."""
    from . import trace, work
    steps = sum(iv["steps"] for iv in run.intervals)
    r = dict(steps=steps, syncs=sum(iv["syncs"] for iv in run.intervals),
             rollbacks=sum(iv["rollbacks"] for iv in run.intervals),
             launches=sum(run.launches.values()), window_s=run.wall_s,
             trace=None, least_s=None, bound_by=None, peaks=None)
    if run.events:
        r["trace"] = trace.summarize(run.events)
        peaks = _peaks(bench_dir, kind)
        if peaks is not None:
            import torch
            ch = run.ch
            pts = [work.pairs_within(torch.as_tensor(x).to(run.device),
                                     torch.as_tensor(y).to(run.device),
                                     run.n_fluid, ch.DL, ch.h)
                   for x, y in run.points]
            r["least_s"], r["bound_by"] = work.window_least_seconds(
                pts, [iv["steps"] for iv in run.intervals], run.n_fluid,
                run.n_total, peaks["ops_per_s"], peaks["bytes_per_s"])
            r["peaks"] = peaks
    return r


def _num(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def run_cell(spec: dict, cell: str, seed: int, seconds: float, traced: bool,
             device, t0: float, bench_dir: str = BENCH_DIR,
             engine_wrap=None, log=None) -> dict:
    """One run of ``cell``: the result's dict, with ``checks`` last."""
    import torch
    from . import check
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    entry = cell_entry(spec, cell)
    wl = load_json(find(bench_dir, "workloads", cell))
    conf = load_json(find(bench_dir, "configs", wl["config"]))
    driver = load_module(bench_dir, "drivers", wl["driver"])
    run = driver.run(conf, wl, seed, seconds, traced, device, t0,
                     engine_wrap=engine_wrap)
    t_check = time.perf_counter()
    judged = check.judge(run, wl)
    t_check = time.perf_counter() - t_check
    rows, ok = check.verdict(judged["gaps"], wl["limits"])
    failed = len(judged["dirty_points"])
    if not ok and run.sampled not in judged["dirty_points"]:
        failed += 1
    dev = torch.device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    device_out = dict(platform="gpu" if dev.type == "cuda" else "cpu",
                      kind=kind, count=int(entry["chips"]),
                      memory_peak_bytes=run.memory_peak_bytes)
    metrics, breakdown = {}, None
    if not traced:
        steps = sum(iv["steps"] for iv in run.intervals)
        values = dict(particle_steps_per_s=run.n_fluid * steps / run.wall_s,
                      setup_s=run.setup_s)
        for m in metrics_of(spec, "end_to_end", cell):
            metrics[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
    else:
        r = readings(run, bench_dir, kind)
        for m in metrics_of(spec, "per_layer", cell):
            v = load_module(bench_dir, "metrics", m["name"]).read(r)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        if r["trace"] is not None:
            device_out.update(busy_s=r["trace"]["busy_s"],
                              window_s=run.wall_s)
            breakdown = dict(device_ops=r["trace"]["device_ops"],
                             idle_gaps=r["trace"]["idle_gaps"])
        if r["peaks"] is not None:
            log(f"peaks: {r['peaks']['ops_per_s']:.4g} op/s, "
                f"{r['peaks']['bytes_per_s']:.4g} B/s "
                f"({r['peaks']['source']}); least time {r['least_s']:.6g} "
                f"s, bound by {r['bound_by']}")
    iv = run.intervals
    log(f"{cell} seed {seed}: {len(iv)} intervals, "
        f"{sum(i['steps'] for i in iv)} steps in {run.wall_s:.4f} s, "
        f"set-up {run.setup_s:.4f} s, sampled interval {run.sampled} "
        f"({judged['groups']} groups, checked {judged['chosen']}, "
        f"{t_check:.2f} s); process {time.perf_counter() - t0:.2f} s")
    log("interval walls (s): " + " ".join(f"{i['wall']:.3f}" for i in iv)
        + f"; syncs {sum(i['syncs'] for i in iv)}, rollbacks "
        f"{sum(i['rollbacks'] for i in iv)}; card: {power_limit()}")
    for name, m in metrics.items():
        log(f"{name} = {m['value']!r} {m['unit']}")
    for name, v, lim in rows:
        log(f"check {name} {v!r} limit {lim!r}")
    out = dict(correct=bool(ok and failed == 0), attempted=len(iv),
               failed=failed, metrics=metrics, device=device_out)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: dict(value=_num(v), limit=lim) for n, v, lim in rows}
    return out


def main(args, t0: float) -> int:
    """The command line's run; the exit code."""
    set_process_env()
    spec = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = int(cell_entry(spec, args.workload)["chips"])
    try:
        import torch
    except ImportError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    try:
        out = run_cell(spec, args.workload, args.seed, float(args.seconds),
                       bool(args.trace), "cuda:0", t0)
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules loaded in the measuring process: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 4
    print(json.dumps(out), flush=True)
    return 0
