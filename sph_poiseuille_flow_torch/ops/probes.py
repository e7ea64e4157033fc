"""The kernels of the sweep-decomposition probes and the lane-tiling check
(the PyTorch counterparts of the Pallas calls in the JAX package's
experiments/profile_r3.py, experiments/profile_fused.py and
tests/test_pallas.py::test_expand_exact_beyond_bf16).

* ``fused_step_sweeps``: the fused step cut to the sweep range
  ``first .. first+count-1``, as the TPU probes launch ``_step_kernel`` on
  the grid ``(count, n_groups)`` from ``sweep_offset=first``. The cores
  the range does not write stay zero (the kernel's zeroed buffers);
  ``SWEEP_WRITES`` says which cores each sweep writes.
* ``fused_noop``: the fixed cost of one step call: the step's whole
  set-up, and a kernel that only copies ``x[0, 0, :]`` into
  ``vol[0, 0, :]``.
* ``expand_onehot``: ``v @ E`` with the one-hot lane-tiling matrix
  ``E[c, k*bx + c] = 1``, which is ``v`` tiled K times along columns.

As in ``fused_cell``, CUDA tensors launch the hand-written kernels
(``fused_cell_cuda``), CPU tensors run the plain versions (``*_plain``),
and nothing falls back from one to the other. ``fused_cell_cuda.
StepBuffers`` relaunches sweep ranges over one completed step's buffers;
``fused_step_sweeps_plain(prior=...)`` is its plain counterpart.
"""

from __future__ import annotations

import torch

from . import fused_cell as fc
from . import fused_cell_cuda
from .fused_cell import SCRATCH, SWEEP_WRITES
from .neighbors import GridSpec

STEP_CORES = ("volH", "b11H", "b12H", "b21H", "b22H", "vxH", "vyH", "rhoP",
              "pP", "drP", "fxP", "fyP", "fpxP", "fpyP", "xP", "yP", "cnt")


def _inputs(lay, xH, yH, vxH, vyH, drP):
    return [xH, yH, vxH, vyH, drP, lay.isf_c, lay.mass_c, lay.wvx_c,
            lay.wvy_c]


def _scalars(like, rho0, p0, c_f, inv_sigma0, transport_coeff, g, mu, wf):
    return (rho0, p0, c_f, inv_sigma0, transport_coeff, fc._scalar(g, like),
            fc._scalar(mu, like), fc._scalar(wf, like))


def fused_step_sweeps_plain(spec: GridSpec, lay: fc.FusedLayout, xH, yH,
                            vxH, vyH, drP, dt, rho0: float, p0: float,
                            c_f: float, inv_sigma0: float,
                            transport_coeff: float, g, mu,
                            wall_visc_factor: float = 4.0, first: int = 0,
                            count: int = 4, prior: dict = None) -> dict:
    """Plain version of ``fused_step_sweeps`` (any device), in the form
    ``step_form`` resolves. ``prior``: the cores of an earlier call on the
    same inputs (a completed step's buffers), which the range reads and
    leaves where it does not write them; the plain counterpart of
    relaunching sweeps on ``StepBuffers``. Without it the cores the range
    does not write are zero."""
    fused_cell_cuda.check_sweep_range(first, count)
    n_cached = fc._cached_ranks(*fc.step_form(spec, xH.dtype))
    if n_cached and first > 0 and prior is None:
        raise ValueError("the cache form's sweeps 1-3 read the list that "
                         "sweep 0 writes: pass the cores of a completed "
                         "step as prior")
    o = fc._sweeps_plain(
        spec, _inputs(lay, xH, yH, vxH, vyH, drP), lay.occ,
        fc._scalar(dt, xH),
        _scalars(xH, rho0, p0, c_f, inv_sigma0, transport_coeff, g, mu,
                 wall_visc_factor), n_cached, first, count, prior)
    if first == 0:
        o["cnt"] = fc._cnt_rows(spec, o["cnt"])
    return o


def fused_step_sweeps(spec: GridSpec, lay: fc.FusedLayout, xH, yH, vxH,
                      vyH, drP, dt, rho0: float, p0: float, c_f: float,
                      inv_sigma0: float, transport_coeff: float, g, mu,
                      wall_visc_factor: float = 4.0, first: int = 0,
                      count: int = 4) -> dict:
    """Sweeps ``first .. first+count-1`` of one fused step, in the form
    ``step_form`` resolves, on fresh buffers: the output cores of
    ``fused_step_cores`` plus the scratch cores (``SCRATCH``), those the
    range does not write zero; ``cnt`` is (n_groups, L). The whole range
    is ``fused_step_cores``. The cache form's sweeps 1-3 read the list that
    sweep 0 writes, so there a range starts at sweep 0."""
    fc._check_device(xH)
    if not xH.is_cuda:
        return fused_step_sweeps_plain(
            spec, lay, xH, yH, vxH, vyH, drP, dt, rho0, p0, c_f, inv_sigma0,
            transport_coeff, g, mu, wall_visc_factor, first, count)
    b = fused_cell_cuda.StepBuffers(
        spec, fc.plan(spec)[0], lay, xH, yH, vxH, vyH, drP, dt,
        (rho0, p0, c_f, inv_sigma0, transport_coeff, g, mu,
         wall_visc_factor), *fc.step_form(spec, xH.dtype))
    b.sweeps(first, count)
    o = b.outputs()
    o["cnt"] = fc._cnt_rows(spec, o["cnt"])
    return o


def fused_noop_plain(spec: GridSpec, lay: fc.FusedLayout, xH, yH, vxH, vyH,
                     drP, dt, rho0: float, p0: float, c_f: float,
                     inv_sigma0: float, transport_coeff: float, g, mu,
                     wall_visc_factor: float = 4.0) -> dict:
    """Plain version of ``fused_noop`` (any device): every core zero but
    ``volH[0, 0, :]``, which is ``xH[0, 0, :]``."""
    out = {k: fc.zero_core(spec, k, xH, drP) for k in STEP_CORES + SCRATCH}
    out["volH"][0, 0, :] = xH[0, 0, :]
    return out


def fused_noop(spec: GridSpec, lay: fc.FusedLayout, xH, yH, vxH, vyH, drP,
               dt, rho0: float, p0: float, c_f: float, inv_sigma0: float,
               transport_coeff: float, g, mu,
               wall_visc_factor: float = 4.0) -> dict:
    """The fixed cost of one step call (the TPU probe's no-op,
    experiments/profile_r3.py:170-185): the step's whole set-up in the
    form ``step_form`` resolves, then a kernel that copies ``xH[0, 0, :]``
    into ``volH[0, 0, :]`` and nothing else. Returns the cores of
    ``fused_step_sweeps``."""
    fc._check_device(xH)
    if not xH.is_cuda:
        return fused_noop_plain(spec, lay, xH, yH, vxH, vyH, drP, dt, rho0,
                                p0, c_f, inv_sigma0, transport_coeff, g, mu,
                                wall_visc_factor)
    b = fused_cell_cuda.StepBuffers(
        spec, fc.plan(spec)[0], lay, xH, yH, vxH, vyH, drP, dt,
        (rho0, p0, c_f, inv_sigma0, transport_coeff, g, mu,
         wall_visc_factor), *fc.step_form(spec, xH.dtype))
    b.noop()
    o = b.outputs()
    o["cnt"] = fc._cnt_rows(spec, o["cnt"])
    return o


def onehot_tiling(bx: int, K: int, like: torch.Tensor) -> torch.Tensor:
    """E (bx, K*bx) with E[c, k*bx + c] = 1 (tests/test_pallas.py:159-161),
    in the dtype and on the device of ``like``."""
    lane = torch.arange(K * bx, device=like.device)
    col = torch.arange(bx, device=like.device)
    return (lane[None, :] % bx == col[:, None]).to(like.dtype)


def expand_onehot_plain(v: torch.Tensor, K: int) -> torch.Tensor:
    """Plain version of ``expand_onehot`` (any device): the product with
    the explicit one-hot matrix, in v's dtype (float32 products where the
    caller leaves TF32 off)."""
    return torch.matmul(v, onehot_tiling(v.shape[1], K, v))


def expand_onehot(v: torch.Tensor, K: int) -> torch.Tensor:
    """(rows, bx) -> (rows, K*bx): ``v @ E``, E the one-hot lane-tiling
    matrix, which is exactly ``v`` tiled K times along columns. CUDA
    tensors launch ``sph_expand`` (float32 only), CPU tensors run the
    plain product."""
    fc._check_device(v)
    if not v.is_cuda:
        return expand_onehot_plain(v, K)
    return fused_cell_cuda.expand(v, K)
