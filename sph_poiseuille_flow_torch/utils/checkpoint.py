"""Signature-guarded checkpoint/restart (torch port).

Same ``.npz`` format and signature guard as the JAX package's
``utils/checkpoint.py`` (the reference's restart subsystem,
SPH_Poiseuille.m:127-163, 434-445, 607-610), so a restart file written by
either package resumes in the other. State components may be torch
tensors on any device; they are copied to the host at their own dtype.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Tuple

import numpy as np

_FIELDS_1D = ("x", "y", "vx", "vy", "rho", "p", "drho_dt",
              "fx", "fy", "fpx", "fpy")


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_restart(path: str, signature: str, state, t: float, step: int):
    """Atomically write the restart file (reference: save_restart,
    SPH_Poiseuille.m:607-610)."""
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    payload = {name: _host(getattr(state, name)) for name in _FIELDS_1D}
    payload["t"] = np.float64(t)
    payload["step"] = np.int64(step)
    payload["config_signature"] = np.array(signature)
    fd, tmp = tempfile.mkstemp(dir=parent, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_restart(path: str, signature: str, n_total: int
                 ) -> Tuple[Optional[dict], str]:
    """Validate + load a restart file.

    Returns (payload, reason): payload is None when the file is unusable,
    with ``reason`` explaining why (mirrors the reference's fallback prints,
    SPH_Poiseuille.m:156-162).
    """
    if not os.path.exists(path):
        return None, "restart file does not exist"
    try:
        with np.load(path, allow_pickle=False) as data:
            if "config_signature" not in data or "t" not in data \
                    or "step" not in data:
                return None, "restart file missing required fields"
            if str(data["config_signature"]) != signature:
                return None, "restart signature mismatch"
            out = {}
            for name in _FIELDS_1D:
                if name not in data:
                    return None, f"restart file missing array {name!r}"
                arr = data[name]
                if arr.shape != (n_total,):
                    return None, (f"restart array {name!r} has shape "
                                  f"{arr.shape}, expected ({n_total},)")
                out[name] = arr
            out["t"] = float(data["t"])
            out["step"] = int(data["step"])
            return out, "ok"
    except (OSError, ValueError) as e:
        return None, f"restart file unreadable: {e}"
