"""The devices of an N-slab mesh (torch port of the JAX package's
``parallel/virtual.py``).

The JAX package runs one controller over N devices in one process and,
where fewer real chips exist, provisions an N-device virtual CPU platform.
The port runs its N y-slabs in one process too, each on an explicit
``torch.device``: on N CUDA cards one slab per card; on fewer cards every
slab on the one card (a virtual mesh, whose exchanges are copies on that
card); with ``--device cpu`` N CPU slabs. A run asked for on CUDA never
moves to the CPU.
"""

from __future__ import annotations

import os

import torch


def ensure_devices(n: int, device="cuda") -> list:
    """The ``n`` devices of the mesh, slab i on entry i. ``device`` is the
    run's device ("cuda" or "cpu"). With ``SPH_DRYRUN_REAL_DEVICES`` set,
    ``n`` real CUDA cards must exist (the JAX package's assertion of real
    chips; a one-device mesh asserts nothing); otherwise fewer cards than
    ``n`` put every slab on card 0."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    dev = torch.device(device)
    real = n > 1 and bool(os.environ.get("SPH_DRYRUN_REAL_DEVICES"))
    if dev.type == "cpu":
        if real:
            raise RuntimeError(
                f"SPH_DRYRUN_REAL_DEVICES is set: a {n}-device mesh needs "
                f"{n} CUDA cards, and the run was asked for on the CPU")
        return [torch.device("cpu")] * n
    if dev.type != "cuda":
        raise ValueError(f"mesh devices are cuda or cpu, got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh was asked for and no CUDA device is "
                           "available (torch.cuda.is_available() is False)")
    have = torch.cuda.device_count()
    if have >= n:
        return [torch.device("cuda", i) for i in range(n)]
    if real:
        raise RuntimeError(
            f"SPH_DRYRUN_REAL_DEVICES is set: a {n}-device mesh needs {n} "
            f"CUDA cards, {have} present")
    return [torch.device("cuda", 0)] * n


def is_virtual(devices) -> bool:
    """True when several slabs share one device."""
    return len(set(devices)) < len(devices)
