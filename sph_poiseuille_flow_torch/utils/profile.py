"""``--profile DIR``: a torch.profiler capture of a whole run (the port's
counterpart of the JAX package's ``jax.profiler.trace``) and the summary
the per-interval breakdown in PERF.md reads.

The driver marks each output interval (the engine call plus the
synchronisation that ends it) as a ``sph_interval`` range. For each
interval the summary gives its wall time, the card's busy time (the union
of the device activity inside the range) and share, and device time by
kernel. The first interval carries the warm-up (kernel load, allocator),
so ``steady`` sums the intervals after it. Written to ``DIR/trace.json``
(chrome://tracing or Perfetto) and ``DIR/summary.json``; the summary lines
are also printed.
"""

from __future__ import annotations

import contextlib
import json
import os

import torch

INTERVAL = "sph_interval"


def interval_range():
    """The range that marks one output interval in a capture (a no-op when
    no profiler is running)."""
    return torch.profiler.record_function(INTERVAL)


def _union(spans) -> float:
    """Total length covered by (start, end) spans."""
    total, reach = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


def summarize(events) -> dict:
    """Per-interval wall, device busy time and device time by kernel, in
    microseconds, from a capture's function events. Busy figures are None
    where the capture holds no device activity (a CPU run)."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == INTERVAL and e.device_type == DeviceType.CPU)
    # the device timeline also holds a copy of each user range: keep only
    # kernels, copies and memsets
    device = [(e.time_range.start, e.time_range.end, e.name) for e in events
              if e.device_type == DeviceType.CUDA and e.name != INTERVAL
              and not getattr(e, "is_user_annotation", False)]
    rows = []
    for s, e in spans:
        inside = [(max(a, s), min(b, e), n) for a, b, n in device
                  if b > s and a < e]
        by_name = {}
        for a, b, n in inside:
            by_name[n] = by_name.get(n, 0.0) + (b - a)
        busy = _union((a, b) for a, b, _ in inside) if device else None
        rows.append(dict(wall_us=e - s, busy_us=busy,
                         device_us_by_name=by_name))
    steady = rows[1:] or rows
    wall = sum(r["wall_us"] for r in steady)
    by_name = {}
    for r in steady:
        for n, v in r["device_us_by_name"].items():
            by_name[n] = by_name.get(n, 0.0) + v
    busy = sum(r["busy_us"] for r in steady) if device else None
    return dict(intervals=rows, steady=dict(
        n_intervals=len(steady), wall_us=wall, busy_us=busy,
        busy_share=busy / wall if busy is not None and wall > 0 else None,
        device_us_by_name=dict(sorted(by_name.items(),
                                      key=lambda kv: -kv[1]))))


def summary_lines(summary: dict, top: int = 12):
    def busy(r):
        if r["busy_us"] is None:
            return "device busy not measured (no device activity)"
        return (f"device busy {r['busy_us'] / 1e3:.3f} ms "
                f"({100 * r['busy_us'] / r['wall_us']:.1f}%)")

    for i, r in enumerate(summary["intervals"]):
        yield (f"profile: interval {i}: wall {r['wall_us'] / 1e3:.3f} ms, "
               f"{busy(r)}")
    st = summary["steady"]
    yield (f"profile: steady ({st['n_intervals']} intervals): wall "
           f"{st['wall_us'] / 1e3:.3f} ms, {busy(st)}")
    total = sum(st["device_us_by_name"].values())
    for n, v in list(st["device_us_by_name"].items())[:top]:
        yield (f"profile:   {100 * v / total:5.1f}% {v / 1e3:9.3f} ms  "
               f"{n[:90]}")


@contextlib.contextmanager
def traced(out_dir: str, device: torch.device, log=print):
    """Capture everything inside the block; write the trace and summary."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    summary = summarize(prof.events())
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for line in summary_lines(summary):
        log(line)
    log(f"profile written to {out_dir}")
