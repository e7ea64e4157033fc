"""Slot assignment of the cell layout (torch port of the JAX package's
``ops/cellgrid.assign_slots``).

The slot order fixes the order of every in-cell reduction, so the slot
array must be identical to the JAX package's: a STABLE sort by cell id,
then the rank inside the cell.
"""

from __future__ import annotations

import torch

from .neighbors import GridSpec, _cell_coords


def assign_slots(spec: GridSpec, x: torch.Tensor, y: torch.Tensor):
    """Stable sort by cell id + rank-in-cell -> (slot, overflow): slot is
    ``cell * K + rank`` (int64), or the sentinel ``n_cells * K`` for a
    particle past the cell capacity; overflow is a 0-dim bool tensor (the
    reference's linked-cell insert, sph_neighbor_search_mex.c:69-113, as a
    static-shape scatter). The per-cell counts use ``scatter_add`` with a
    known length, which unlike ``bincount`` needs no device sync."""
    n = spec.n_total
    dev = x.device
    cx, cy = _cell_coords(spec, x, y)
    cid = cy.to(torch.int64) * spec.nx + cx.to(torch.int64)
    order = torch.argsort(cid, stable=True)
    cid_sorted = cid[order]
    counts = torch.zeros(spec.n_cells, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, cid, torch.ones_like(cid))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, dtype=torch.int64, device=dev) - starts[cid_sorted]
    overflow = torch.max(counts) > spec.K
    slot_sorted = torch.where(rank < spec.K, cid_sorted * spec.K + rank,
                              torch.full_like(rank, spec.n_cells * spec.K))
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    return slot, overflow
