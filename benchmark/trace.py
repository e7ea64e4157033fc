"""The device trace of a window: a ``torch.profiler`` capture of device
activity only (kernels, copies, memsets through CUPTI; no host-side
events, which would stretch the window's wall), reduced to the busy
union, the kernel count, device time by operation and the idle gaps.

An idle gap is the stretch between two device operations in which
nothing ran; the host was preparing what came next, so each gap is named
after the operation that ended it and the gaps of one name are summed.
The union arithmetic is the port's ``utils/profile._union``, copied.
"""

from __future__ import annotations

import contextlib

import torch

NAME_CHARS = 96


def _union(spans) -> float:
    """Total length covered by (start, end) spans."""
    total, reach = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


def _short(name: str) -> str:
    return " ".join(name.split())[:NAME_CHARS]


def is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def device_events(prof):
    """(name, start_s, end_s) of every device operation of a capture."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        if hasattr(ev, "start_ns"):
            s, d = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
        else:
            s, d = ev.start_us() * 1e-6, ev.duration_us() * 1e-6
        out.append((ev.name(), s, s + d))
    return out


@contextlib.contextmanager
def capture(enabled: bool, device):
    """Yields a holder whose ``events`` are filled when the block ends:
    the device operations of the block, or None when not ``enabled``; a
    CPU device has none to capture (an empty list)."""
    class Holder:
        events = None

    holder = Holder()
    if not enabled or torch.device(device).type != "cuda":
        if enabled:
            holder.events = []
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield holder
    holder.events = device_events(prof)


def summarize(events, top: int = 10) -> dict:
    """Busy seconds (the union), kernel count, the ``top`` operations by
    device seconds and the ``top`` idle-gap names by summed seconds."""
    events = sorted(events, key=lambda e: e[1])
    busy = _union((s, e) for _, s, e in events)
    by_op, gaps = {}, {}
    reach = None
    for name, s, e in events:
        key = _short(name)
        by_op[key] = by_op.get(key, 0.0) + (e - s)
        if reach is not None and s > reach:
            gk = f"host, then {key}"
            gaps[gk] = gaps.get(gk, 0.0) + (s - reach)
        reach = e if reach is None else max(reach, e)

    def head(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return dict(busy_s=busy,
                kernels=sum(1 for n, _, _ in events if is_kernel(n)),
                device_ops=head(by_op), idle_gaps=head(gaps))
