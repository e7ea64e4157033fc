"""Carry arrays of the JAX package (as numpy) across into the port.

The JAX package's ``State``, ``FusedLayout`` and ``Candidates`` are
NamedTuples of arrays; ``np.asarray`` of each field (or ``_asdict()`` of
the tuple, mapped through ``np.asarray``) gives the dicts these functions
take. Index arrays (``pidx``, ``hidx``, ``jsafe``) become int64 (torch's
native index type), ``occ`` stays int32 (the CUDA kernels read it as
such), everything else takes ``dtype``. The restart
path uses ``state_from_numpy`` too, so a restart written by either package
resumes here.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .ops.fused_cell import FusedLayout, shear_row_list
from .ops.neighbors import Candidates
from .stepper import State


def state_from_numpy(arrays: Mapping[str, np.ndarray], dtype=torch.float32,
                     device="cpu", base: Optional[State] = None) -> State:
    """Build a ``State`` from per-field arrays. Fields missing from
    ``arrays`` are taken from ``base`` (a restart file carries 11 of the
    16 fields; ``init`` recomputes the rest)."""
    fields = {}
    for name in State._fields:
        if name in arrays:
            fields[name] = torch.tensor(np.asarray(arrays[name]),
                                        dtype=dtype, device=device)
        elif base is not None:
            fields[name] = getattr(base, name)
        else:
            raise KeyError(f"state field {name!r} missing and no base state")
    return State(**fields)


def layout_from_numpy(arrays: Mapping[str, np.ndarray], dtype=torch.float32,
                      device="cpu") -> FusedLayout:
    """Build a ``FusedLayout`` from the JAX layout's fields; the wall-row
    list the JAX layout does not carry is built from its wall masks."""
    def conv(name, a):
        a = np.asarray(a)
        if name in ("pidx", "hidx"):
            return torch.tensor(a, dtype=torch.int64, device=device)
        if name == "occ":
            return torch.tensor(a, dtype=torch.int32, device=device)
        if name == "overflow":
            return torch.tensor(bool(a), device=device)
        return torch.tensor(a, dtype=dtype, device=device)
    lay = FusedLayout(**{n: conv(n, arrays[n]) for n in FusedLayout._fields
                         if n in arrays})
    rows, tbt = shear_row_list(lay.wbot_c, lay.wtop_c)
    return lay._replace(shear_rows=rows, shear_tbt=tbt)



def candidates_from_numpy(arrays: Mapping[str, np.ndarray],
                          dtype=torch.float32, device="cpu") -> Candidates:
    """Build the gather engine's ``Candidates`` from the JAX candidate
    set's fields, so both packages' operators can run on one candidate
    set."""
    def conv(name, a):
        a = np.asarray(a)
        if name == "jsafe":
            return torch.tensor(a, dtype=torch.int64, device=device)
        if name == "overflow":
            return torch.tensor(bool(a), device=device)
        return torch.tensor(a, dtype=dtype, device=device)
    return Candidates(**{n: conv(n, arrays[n]) for n in Candidates._fields})
