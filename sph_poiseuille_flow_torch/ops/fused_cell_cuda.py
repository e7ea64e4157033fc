"""Build, binding and launch wrappers of the hand-written CUDA kernels in
``csrc/fused_cell.cu`` (the Hopper port of the JAX package's Pallas
kernels: the fused step and the multi-step chunk, each in its recompute,
geometry-cache and row-outer forms, and the wall-shear monitor; and the
probes' kernels: the step cut to a sweep range, the no-op over the step's
buffers and the one-hot lane tiling; and the interval loop's rebuild
between sub-chunk groups, which has no Pallas counterpart).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (into ``build/`` beside the package,
keyed by a hash of the source) and loaded with ``ctypes``. Nothing here
runs when the module is imported, so CPU-only installs import it freely.

Each wrapper checks device, dtype (float32), shape and contiguity, launches
on PyTorch's current stream without synchronising, raises when the C entry
point reports a CUDA error, and adds one to its entry of ``LAUNCHES`` (one
entry per kernel and form). A form it does not know raises; no form gives
way to another. ``ChunkBuffers`` is the chunk's persistent form: its
``launch`` (``sph_chunk_run``) is the one wrapper that synchronises, since
it returns the sub-chunk's control record to the host.
``RebuildBuffers`` holds the rebuild's persistent layout sets: its
``launch`` (``sph_rebuild``) enqueues the rebuild and returns.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from .kernels import sigma_2d

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "fused_cell.cu")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

# launch counts of the kernel entry points, per form (one per wrapper
# call): "fused_step"/"fused_chunk" are the recompute form ("none"),
# "*_cache" the geometry cache ("full", "ring", "partial"), "*_rows" the
# candidate-row-outer loop ("rows"); "fused_step_sweeps*" a sweep range of
# the step (``StepBuffers.sweeps``); "fused_rebuild" the interval loop's
# rebuild (``RebuildBuffers.launch``)
LAUNCHES = {"fused_step": 0, "fused_step_cache": 0, "fused_step_rows": 0,
            "fused_chunk": 0, "fused_chunk_cache": 0, "fused_chunk_rows": 0,
            "fused_wall_shear": 0, "fused_step_sweeps": 0,
            "fused_step_sweeps_cache": 0, "fused_step_sweeps_rows": 0,
            "fused_noop": 0, "expand_onehot": 0, "fused_rebuild": 0}

# form name -> (kernel form of csrc/fused_cell.cu, LAUNCHES suffix)
_FORMS = {"none": (0, ""), "full": (1, "_cache"), "ring": (1, "_cache"),
          "partial": (1, "_cache"), "rows": (2, "_rows")}

# lanes per anchor slot in the geometry-cache form (``cache_groups``):
# csrc/fused_cell.cu instantiates each of CACHE_GROUPS0 for sweep 0 and
# each of CACHE_GROUPS for sweeps 1-3
CACHE_GROUPS0 = (4, 8, 16, 32)
CACHE_GROUPS = (1, 2, 4, 8, 16, 32)
CACHE_THREADS = 160_000   # threads a cache sweep should put on the card
CACHE_G_MAX = 8           # lanes per anchor in sweeps 1-3 at most

# lanes per anchor slot in the recompute form ("none", ``win_groups``):
# csrc/fused_cell.cu instantiates each for every sweep
WIN_GROUPS = CACHE_GROUPS0

# the rows form's tiles (``rows_tile``): lanes per anchor slot (each
# instantiated for every sweep), the threads a block should hold and can
# hold at most (rows_sweep's launch bounds), the fields its widest sweep
# stages (sweep 2) and the shared memory a block can opt in to (bytes)
ROWS_GROUPS = WIN_GROUPS
ROWS_BLOCK = 256
ROWS_BLOCK_MAX = 1024
ROWS_FIELDS = 14
SMEM_MAX = 232_448

# the chunk runner's persistent buffers (``ChunkBuffers``): key sets built
# and chunk runs through them; apart from LAUNCHES, whose sum counts the
# wrapper calls (a run on the card also counts one "fused_chunk*" launch)
CHUNK_BUFFERS = {"sets_built": 0, "runs": 0}

# the rebuild's persistent layout sets (``RebuildBuffers``): key sets built
# and rebuilds through them, one a sub-chunk group (a rebuild on the card
# also counts one "fused_rebuild" launch)
REBUILD_BUFFERS = {"sets_built": 0, "runs": 0}

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in CHUNK_BUFFERS:
        CHUNK_BUFFERS[k] = 0
    for k in REBUILD_BUFFERS:
        REBUILD_BUFFERS[k] = 0


class _Const(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("nyp", "K", "nx", "R", "kcut",
                                              "ncs", "tx", "cg0", "cg", "wg",
                                              "rg")]
                + [(n, ctypes.c_float) for n in (
                    "DL", "h", "cut2", "sigma", "sig025", "c225soh",
                    "c3soh", "cm075soh", "rho0", "p0", "c_f", "inv_sigma0",
                    "inv_rho0", "tchh", "h001", "hh", "c025h")])


_STEP_PTRS = ("x", "y", "vx", "vy", "dr", "isf", "mass", "wvx", "wvy", "occ",
              "dyn", "vol", "b11", "b12", "b21", "b22", "vx2", "vy2", "rho",
              "p", "drho", "fx", "fy", "fpx", "fpy", "x2", "y2", "cnt",
              "rhoH", "pH", "dxs", "dys")


class _StepBufs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _STEP_PTRS]


_SHEAR_PTRS = ("x", "y", "isf", "vol", "vx", "b11", "b12", "b21", "b22",
               "wvx", "wbot", "wtop", "occ", "rows", "tb", "tt")


_CACHE_PTRS = ("idx", "ex", "ey", "r", "c1", "cw", "n", "rec")


class _CacheBufs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _CACHE_PTRS]


class _ChunkIO(ctypes.Structure):
    _fields_ = [("ncopy", ctypes.c_int), ("src", ctypes.c_void_p * 5),
                ("dst", ctypes.c_void_p * 5), ("bytes", ctypes.c_size_t * 5),
                ("zero", ctypes.c_void_p), ("zero_bytes", ctypes.c_size_t),
                ("rec_in", ctypes.c_void_p), ("rec_out", ctypes.c_void_p),
                ("rec", ctypes.c_void_p)]


class _DriftBufs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in ("refx", "refy", "isf",
                                                "cells")]
                + [(n, ctypes.c_int) for n in ("rows", "row0", "isf_halo")])


class _ShearBufs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in _SHEAR_PTRS]
                + [("mu", ctypes.c_float), ("wf", ctypes.c_float),
                   ("nrows", ctypes.c_int)])


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "sph_poiseuille_flow_torch are built from "
                       "csrc/fused_cell.cu at first use and need the CUDA "
                       "toolkit")


def build(verbose: bool = False) -> str:
    """Compile ``csrc/fused_cell.cu`` (if not built yet) and return the
    shared library's path. ``verbose`` adds ``-Xptxas -v`` and prints the
    compiler's report (registers, spills per kernel)."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"libsph_fused_{digest.hexdigest()[:16]}.so")
    if os.path.exists(out) and not verbose:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [_nvcc()] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else []) \
        + ["-o", tmp, _SRC]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stdout}"
                           f"\n{r.stderr}")
    if verbose:
        print(r.stdout + r.stderr)
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ip = ctypes.c_void_p, ctypes.c_int
        lib.sph_step.argtypes = [vp, vp, vp, ip, vp]
        lib.sph_step_sweeps.argtypes = [vp, vp, vp, ip, ip, ip, vp]
        lib.sph_chunk.argtypes = [vp, vp, vp, ip, vp, vp, vp, ip, vp]
        lib.sph_chunk_run.argtypes = [vp, vp, vp, ip, vp, vp, ip, vp]
        lib.sph_shear.argtypes = [vp, vp, vp]
        lib.sph_noop.argtypes = [vp, vp, vp]
        lib.sph_expand.argtypes = [vp, vp, ip, ip, ip, vp]
        lib.sph_rebuild.argtypes = [vp, vp]
        for fn in (lib.sph_step, lib.sph_step_sweeps, lib.sph_chunk,
                   lib.sph_chunk_run, lib.sph_shear, lib.sph_noop,
                   lib.sph_expand, lib.sph_rebuild):
            fn.restype = ip
        _lib = lib
    return _lib


def cache_groups(n_slots: int) -> tuple:
    """(G0, G): lanes per anchor slot in the geometry-cache form's sweep 0
    (the window walk) and sweeps 1-3 (the list walk), from the number of
    anchor slots. G0 is the fewest of CACHE_GROUPS0 that put
    CACHE_THREADS threads on the card; G is G0 but at most CACHE_G_MAX:
    the lanes of one anchor gather from about as many cache lines, so
    sweeps 1-3 want fewer lanes than the walk (chip_smoke.py phase 4 times
    every size at dp=0.01 and dp=0.025; PERF.md)."""
    g0 = next((g for g in CACHE_GROUPS0 if n_slots * g >= CACHE_THREADS),
              CACHE_GROUPS0[-1])
    return g0, min(g0, CACHE_G_MAX)


def win_groups(n_slots: int) -> int:
    """G: lanes per anchor slot in the recompute form's sweeps, from the
    number of anchor slots: the cache form's pick for its sweep 0, which
    walks the same window (chip_smoke.py phase 4 times every size at
    dp=0.01 and dp=0.025; PERF.md)."""
    return cache_groups(n_slots)[0]


def rows_smem(K: int, tx: int) -> int:
    """Bytes of the rows form's widest tile (sweep 2's ROWS_FIELDS fields,
    3 cell rows x K ranks x tx+2 columns each; csrc/fused_cell.cu
    ``FieldSet::stage``)."""
    return 4 * ROWS_FIELDS * 3 * K * (tx + 2)


def rows_tile(K: int, n_slots: int, nx: int) -> tuple:
    """(TX, G): the rows form's tile, TX cell columns of one cell row x K
    ranks x G lanes per anchor slot. G is half the recompute form's pick
    (``win_groups``; both walk the same window in lane groups, but a rows
    block also holds the ranks past each row's occupancy bound), at least
    the fewest of ROWS_GROUPS, cut to the largest that lets one column of
    K ranks fit a block; TX fills ROWS_BLOCK threads (at least one column,
    at most nx). Raises where no tile fits a block's threads or shared
    memory. On the H100 this pick was within 1% of the fastest of it and
    its neighbours at dp=0.01 and dp=0.025 (chip_smoke.py phase 4 times
    them; PERF.md)."""
    g = max(ROWS_GROUPS[0], win_groups(n_slots) // 2)
    fits = [G for G in ROWS_GROUPS if G <= g and K * G <= ROWS_BLOCK_MAX]
    if not fits:
        raise ValueError(
            f"no rows-form tile fits K={K}: one cell column of K ranks x "
            f"{ROWS_GROUPS[0]} lanes is {K * ROWS_GROUPS[0]} threads, more "
            f"than a block's {ROWS_BLOCK_MAX}")
    G = fits[-1]
    tx = max(1, min(nx, ROWS_BLOCK // (K * G)))
    if rows_smem(K, tx) > SMEM_MAX:
        raise ValueError(f"no rows-form tile fits K={K}: {rows_smem(K, tx)} "
                         f"bytes of shared memory, more than {SMEM_MAX}")
    return tx, G


def _const(spec, R: int, rho0, p0, c_f, inv_sigma0, transport_coeff,
           kcut: int = 0, rows: bool = False, cache_slots: int = 0):
    """Kernel constants, each rounded once from float64 as the JAX
    package's weakly-typed Python scalars are. ``kcut``: cached anchor
    ranks of the geometry-cache form; ``rows``: the rows form's tile
    (``rows_tile``) is set, else left 0. The cache form's lanes per anchor
    are picked for ``cache_slots`` anchor slots (0: the spec's own), since
    its per-anchor sums add in an order that depends on them: a y-slab
    passes the whole domain's count, so its sums add as one device's do.
    The recompute and rows forms add in window order for any lane
    count."""
    h = spec.h
    sigma = sigma_2d(h)
    soh = sigma / h
    nyp = _shapes(spec, R)[2]
    cg0, cg = cache_groups(cache_slots or nyp * spec.K * spec.nx)
    if cg0 not in CACHE_GROUPS0 or cg not in CACHE_GROUPS:
        raise ValueError(f"lanes per anchor ({cg0}, {cg}) not in "
                         f"{CACHE_GROUPS0} x {CACHE_GROUPS}")
    wg = win_groups(nyp * spec.K * spec.nx)
    if wg not in WIN_GROUPS:
        raise ValueError(f"lanes per anchor {wg} not in {WIN_GROUPS}")
    tx, rg = rows_tile(spec.K, nyp * spec.K * spec.nx, spec.nx) if rows \
        else (0, 0)
    if rows and (rg not in ROWS_GROUPS
                 or not 1 <= tx * spec.K * rg <= ROWS_BLOCK_MAX):
        raise ValueError(f"rows tile ({tx}, {rg}) does not fit a block")
    return _Const(
        nyp=nyp, K=spec.K, nx=spec.nx, R=R, kcut=kcut,
        ncs=nyp * kcut * spec.nx, tx=tx, cg0=cg0, cg=cg, wg=wg, rg=rg,
        DL=spec.DL, h=h,
        cut2=spec.cutoff * spec.cutoff, sigma=sigma, sig025=sigma * 0.25,
        c225soh=2.25 * soh, c3soh=3.0 * soh, cm075soh=-0.75 * soh,
        rho0=rho0, p0=p0, c_f=c_f, inv_sigma0=inv_sigma0,
        inv_rho0=1.0 / rho0, tchh=transport_coeff * h * h, h001=0.01 * h,
        hh=h * h, c025h=0.25 * h)


def _check(t: torch.Tensor, shape, name: str, device,
           dtype=torch.float32):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    _check_on(t, shape, name, device, dtype)


def _check_on(t: torch.Tensor, shape, name: str, device,
              dtype=torch.float32):
    """``_check`` on any device: ``t`` on ``device``, of ``dtype`` and
    ``shape``, contiguous."""
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype} (the "
                         "CUDA kernels run in float32 only)")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _shapes(spec, R: int):
    nyp = R * (-(-spec.ny // R))
    return (nyp + 2, spec.K, spec.nx + 2), (nyp, spec.K, spec.nx), nyp


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def _step_bufs(spec, R, lay, xH, yH, vxH, vyH, drP, dyn):
    """Check the step inputs and allocate outputs + scratch (zeroed, so
    y-halo rows and never-visited slots read 0)."""
    halo, plain, nyp = _shapes(spec, R)
    dev = xH.device
    for t, n in ((xH, "xH"), (yH, "yH"), (vxH, "vxH"), (vyH, "vyH"),
                 (lay.isf_c, "isf_c"), (lay.mass_c, "mass_c"),
                 (lay.wvx_c, "wvx_c"), (lay.wvy_c, "wvy_c")):
        _check(t, halo, n, dev)
    _check(drP, plain, "drP", dev)
    _check(lay.occ, (nyp // R, 1), "occ", dev, torch.int32)
    out = {n: torch.zeros(halo, dtype=torch.float32, device=dev)
           for n in ("vol", "b11", "b12", "b21", "b22", "vx2", "vy2",
                     "rhoH", "pH")}
    out.update({n: torch.zeros(plain, dtype=torch.float32, device=dev)
                for n in ("rho", "p", "drho", "fx", "fy", "fpx", "fpy",
                          "x2", "y2", "cnt", "dxs", "dys")})
    ptrs = dict(x=xH, y=yH, vx=vxH, vy=vyH, dr=drP, isf=lay.isf_c,
                mass=lay.mass_c, wvx=lay.wvx_c, wvy=lay.wvy_c, occ=lay.occ,
                dyn=dyn, **out)
    bufs = _StepBufs(**{n: ptrs[n].data_ptr() for n in _STEP_PTRS})
    return bufs, out


def _outputs(out, scratch: bool = False):
    o = dict(volH=out["vol"], b11H=out["b11"], b12H=out["b12"],
             b21H=out["b21"], b22H=out["b22"], vxH=out["vx2"],
             vyH=out["vy2"], rhoP=out["rho"], pP=out["p"],
             drP=out["drho"], fxP=out["fx"], fyP=out["fy"],
             fpxP=out["fpx"], fpyP=out["fpy"], xP=out["x2"],
             yP=out["y2"], cnt=out["cnt"])
    if scratch:
        o.update(rhohH=out["rhoH"], phH=out["pH"], dxsP=out["dxs"],
                 dysP=out["dys"])
    return o


def _dyn(dt, g, mu, wf, dev):
    """[dt, g, mu, wf, active] on the device (one copy when all are host
    numbers)."""
    vals = (dt, g, mu, wf, 1.0)
    if any(torch.is_tensor(v) and v.is_cuda for v in vals):
        return torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                            device=dev).reshape(())
                            for v in vals])
    return torch.tensor([float(v) for v in vals], dtype=torch.float32,
                        device=dev)


def launch_key(kernel: str, form: str) -> str:
    """The ``LAUNCHES`` entry of ``kernel`` ("fused_step"/"fused_chunk")
    in a resolved form."""
    if form not in _FORMS:
        raise ValueError(f"unknown fused-kernel form {form!r}")
    return kernel + _FORMS[form][1]


def _form(form: str, k_cut: int, K: int):
    """(kernel form of csrc/fused_cell.cu, cached ranks) of a resolved
    form."""
    launch_key("fused_step", form)   # raises on an unknown form
    kform = _FORMS[form][0]
    kcut = int(k_cut) if kform == 1 else 0
    if kform == 1 and not 1 <= kcut <= K:
        raise ValueError(f"geometry-cache form {form!r} needs 1 <= k_cut "
                         f"<= K={K}, got {k_cut}")
    return kform, kcut


def _cache_bufs(spec, R: int, kcut: int, dev):
    """The geometry cache: 9K entries for each of the nyp*kcut*nx cached
    anchor slots (rounded up to whole tiles of 32 slots), structure of
    arrays in tiles of T = 32/G slots (G: ``cache_groups``), entry-major
    in a tile (entry e of cached slot s at (s // T)*T*9K + e*T + s % T),
    the count per slot and the four halo'd float4 record cores that
    sweeps 1-3 read their candidates from. Returns the pointer struct and the tensors that back
    it (kept alive by the caller until the launches are enqueued)."""
    if kcut == 0:
        return _CacheBufs(), ()
    ncs = _shapes(spec, R)[2] * kcut * spec.nx
    n_e = 9 * spec.K * -(-ncs // 32) * 32
    keep = (torch.empty(n_e, dtype=torch.int32, device=dev),
            *(torch.empty(n_e, dtype=torch.float32, device=dev)
              for _ in range(5)),
            torch.empty(ncs, dtype=torch.int32, device=dev),
            torch.empty(4 * 4 * math.prod(_shapes(spec, R)[0]),
                        dtype=torch.float32, device=dev))
    return _CacheBufs(*(t.data_ptr() for t in keep)), keep


def _step_setup(spec, R: int, lay, xH, yH, vxH, vyH, drP, dt, scalars,
                form: str, k_cut: int, cache_slots: int = 0):
    """What a step call sets up before its launches: the form, the
    library, the [dt, g, mu, wf, active] copy, the checked inputs with
    zeroed outputs and scratch, the cache and the constants. Returns
    (lib, kernel form, constants, buffer struct, output tensors, the
    [dt, g, mu, wf, active] tensor, cache struct, tensors backing the
    cache): the launches read the tensors through the structs, so the
    caller keeps them alive until they are enqueued."""
    (rho0, p0, c_f, inv_sigma0, transport_coeff, g, mu, wf) = scalars
    kform, kcut = _form(form, k_cut, spec.K)
    lib = _load()
    dev = xH.device
    dyn = _dyn(dt, g, mu, wf, dev)
    bufs, out = _step_bufs(spec, R, lay, xH, yH, vxH, vyH, drP, dyn)
    cache, keep = _cache_bufs(spec, R, kcut, dev)
    c = _const(spec, R, rho0, p0, c_f, inv_sigma0, transport_coeff, kcut,
               rows=kform == 2, cache_slots=cache_slots)
    return lib, kform, c, bufs, out, dyn, cache, keep


def step(spec, R: int, lay, xH, yH, vxH, vyH, drP, dt, scalars,
         form: str = "none", k_cut: int = 0, cache_slots: int = 0):
    """One fused step (the JAX _step_kernel) in ``form``: four sweep
    launches. Returns the output cores with ``cnt`` per slot
    (nyp, K, nx). ``cache_slots``: see ``_const``."""
    lib, kform, c, bufs, out, dyn, cache, keep = _step_setup(
        spec, R, lay, xH, yH, vxH, vyH, drP, dt, scalars, form, k_cut,
        cache_slots)
    dev = xH.device
    with torch.cuda.device(dev):
        _raise_on(lib.sph_step(ctypes.addressof(c), ctypes.addressof(bufs),
                               ctypes.addressof(cache), kform, _stream(dev)),
                  "sph_step")
    del dyn, keep  # a later allocation on this stream runs after them
    LAUNCHES[launch_key("fused_step", form)] += 1
    return _outputs(out)


class StepBuffers:
    """The buffers of one fused step in ``form``, set up once as ``step``
    sets them up (checked inputs, zeroed outputs and scratch, the cache),
    on which sweep ranges and the no-op launch again and again: the probes
    time each sweep and each prefix over a completed step's buffers.

    Sweeps 1-3 read what the earlier sweeps left in the buffers and no
    sweep writes what it reads, so a sweep relaunched over a completed
    step writes what the step wrote, bit for bit. In the cache form sweeps
    1-3 read the list that sweep 0 writes: a range that starts later on
    buffers where sweep 0 has not run raises."""

    def __init__(self, spec, R: int, lay, xH, yH, vxH, vyH, drP, dt,
                 scalars, form: str = "none", k_cut: int = 0):
        (self._lib, self._kform, self._c, self._bufs, self._out,
         self._dyn, self._cache, self._keep) = _step_setup(
            spec, R, lay, xH, yH, vxH, vyH, drP, dt, scalars, form, k_cut)
        # every tensor the structs point to lives as long as the buffers
        self._inputs = (xH, yH, vxH, vyH, drP, lay)
        self.dev = xH.device
        self.key = launch_key("fused_step_sweeps", form)
        self._listed = self._kform != 1   # the list is there to read

    def _call(self, what: str, fn, *args):
        with torch.cuda.device(self.dev):
            _raise_on(fn(ctypes.addressof(self._c),
                         ctypes.addressof(self._bufs), *args,
                         _stream(self.dev)), what)

    def sweeps(self, first: int = 0, count: int = 4) -> None:
        """Launch sweeps ``first .. first+count-1`` (sph_step_sweeps)."""
        check_sweep_range(first, count)
        if first > 0 and not self._listed:
            raise ValueError("the cache form's sweeps 1-3 read the list "
                             "that sweep 0 writes: launch sweep 0 on these "
                             "buffers first")
        self._call("sph_step_sweeps", self._lib.sph_step_sweeps,
                   ctypes.addressof(self._cache), self._kform, first, count)
        LAUNCHES[self.key] += 1
        self._listed = True

    def cache_list(self) -> dict:
        """The cache form's list as sweep 0 left it, untiled (copies):
        ``idx``, ``ex``, ``ey``, ``r``, ``c1`` (dw*m1), ``cw`` (dw*mw) as
        (ncs, 9K), entry e of cached slot s valid for e < ``n[s]``, and
        ``n`` (ncs,); cached slot s = (iy*k_cut + k)*nx + ix."""
        if self._kform != 1:
            raise ValueError("only the geometry-cache form has a list")
        c = self._c
        T = 32 // c.cg

        def untile(v):
            return v.view(-1, 9 * c.K, T).transpose(1, 2).reshape(
                -1, 9 * c.K)[:c.ncs]

        t = [untile(v) for v in self._keep[:6]]
        return dict(zip(("idx", "ex", "ey", "r", "c1", "cw"), t),
                    n=self._keep[6])

    def noop(self) -> None:
        """Launch the no-op on these buffers (sph_noop): it overwrites
        vol's first halo row with x's."""
        self._call("sph_noop", self._lib.sph_noop)
        LAUNCHES["fused_noop"] += 1

    def outputs(self) -> dict:
        """The output and scratch cores (the buffers themselves, not
        copies), ``cnt`` per slot (nyp, K, nx)."""
        return _outputs(self._out, scratch=True)


def check_sweep_range(first: int, count: int) -> None:
    if not (0 <= first and count >= 1 and first + count <= 4):
        raise ValueError(f"sweep range {first} .. {first + count - 1} is "
                         "not inside 0 .. 3")


def expand(v: torch.Tensor, K: int) -> torch.Tensor:
    """(rows, bx) -> (rows, K*bx): ``v`` times the one-hot lane-tiling
    matrix (sph_expand), which is ``v`` tiled K times along columns."""
    if v.dim() != 2:
        raise ValueError(f"v: expected a 2-D tensor, got {v.dim()}-D")
    _check(v, v.shape, "v", v.device)
    rows, bx = v.shape
    out = torch.empty((rows, K * bx), dtype=torch.float32, device=v.device)
    lib = _load()
    with torch.cuda.device(v.device):
        _raise_on(lib.sph_expand(v.data_ptr(), out.data_ptr(), rows, bx,
                                 int(K), _stream(v.device)), "sph_expand")
    LAUNCHES["expand_onehot"] += 1
    return out


def chunk(spec, R: int, lay, xH, yH, vxH, vyH, drP, t_local, t_comp,
          interval_len, n_sub, dt_visc, dt_body, scalars, form: str = "none",
          k_cut: int = 0, cache_slots: int = 0):
    """Up to ``n_sub`` steps (the JAX _chunk_kernel) in ``form`` with no
    host sync: a v_max reduction over the input velocity cores, then per
    step a control launch (dt, active flag, Kahan clock on device), four
    sweeps and a halo refresh that also takes v_max for the next step. The
    inputs are copied into the working state first, so they stay intact.
    Returns ((xH, yH, vxH, vyH, drP) working state, output cores, steps,
    t, t_comp, v_max^2 over the final working velocity cores), the last
    four as 0-dim device tensors. ``cache_slots``: see ``_const``."""
    (rho0, p0, c_f, inv_sigma0, transport_coeff, g, mu, wf) = scalars
    kform, kcut = _form(form, k_cut, spec.K)
    lib = _load()
    dev = xH.device
    work = [a.clone() for a in (xH, yH, vxH, vyH, drP)]
    dyn = _dyn(0.0, g, mu, wf, dev)
    bufs, out = _step_bufs(spec, R, lay, *work, dyn)
    clock = torch.tensor([float(t_local), float(t_comp), float(interval_len),
                          float(dt_visc), float(dt_body)],
                         dtype=torch.float32).to(dev)
    steps = torch.tensor([0, int(n_sub)], dtype=torch.int32).to(dev)
    vmax2 = torch.zeros(1, dtype=torch.int32, device=dev)
    cache, keep = _cache_bufs(spec, R, kcut, dev)
    c = _const(spec, R, rho0, p0, c_f, inv_sigma0, transport_coeff, kcut,
               rows=kform == 2, cache_slots=cache_slots)
    with torch.cuda.device(dev):
        _raise_on(lib.sph_chunk(ctypes.addressof(c), ctypes.addressof(bufs),
                                ctypes.addressof(cache), kform,
                                clock.data_ptr(), steps.data_ptr(),
                                vmax2.data_ptr(), int(n_sub), _stream(dev)),
                  "sph_chunk")
    del keep  # a later allocation on this stream runs after the launches
    LAUNCHES[launch_key("fused_chunk", form)] += 1
    return (work, _outputs(out), steps[0], clock[0], clock[1],
            vmax2.view(torch.float32)[0])


# the words of csrc/fused_cell.cu's ``ChunkRec``, sph_chunk_run's control
# record: the clock [t, t_comp, interval, dt_visc, dt_body], the steps
# [done, n_sub], v_max^2's bits, the step's [dt, g, mu, wf, active] and
# the drift bounds (bx, by)
REC_WORDS = 15
REC_T, REC_TC, REC_DONE, REC_DYN, REC_BX, REC_BY = 0, 1, 5, 8, 13, 14

# a chunk set's cores in the order of its one allocation: the outputs
# (zeroed before every run), then the working state; each core starts on
# a 512-byte boundary, as a tensor of its own would
_SET_OUT = (("vol", "b11", "b12", "b21", "b22", "vx2", "vy2", "rhoH", "pH"),
            ("rho", "p", "drho", "fx", "fy", "fpx", "fpy", "x2", "y2",
             "cnt", "dxs", "dys"))
_SET_WORK = ("x", "y", "vx", "vy", "dr")
_SET_ALIGN = 128
_CHUNK_IN = ("xH", "yH", "vxH", "vyH", "drP")


class ChunkBuffers:
    """The multi-step chunk's outputs and working state for one key
    (halo'd and plain core shapes, form and cached ranks, device, dtype),
    allocated once as two sets, "kept" and "scratch": one contiguous
    allocation each, the cores views into it. A run writes the scratch
    set only and ``keep`` swaps the two roles, so the kept set holds the
    last kept sub-chunk's state, however many runs are rolled back,
    until the next keep.

    On the card it also holds the geometry cache (sweep 0 rewrites it
    every step, so one serves both sets), the control record (on the
    device and in two pinned host copies), the drift bounds' cell table
    and the kernel constants per (spec, scalars), and ``launch`` runs a
    sub-chunk as one ``sph_chunk_run``. On the CPU the runner
    (``fused_cell.BufferedChunkRun``) fills the scratch set from the
    plain twins. Either way the kept set is the engine's chunk state
    between sub-chunks, its ``cnt`` per slot what the rebuild sums."""

    def __init__(self, spec, R: int, form: str, k_cut: int, halo, plain,
                 dtype, dev):
        self.form = form
        self.kform, self.kcut = _form(form, k_cut, spec.K)
        self.R, self.halo, self.plain = R, tuple(halo), tuple(plain)
        shapes = ([(n, self.halo) for n in _SET_OUT[0]]
                  + [(n, self.plain) for n in _SET_OUT[1]]
                  + [(n, self.halo) for n in _SET_WORK[:4]]
                  + [(_SET_WORK[4], self.plain)])
        offs, o = {}, 0
        for n, shp in shapes:
            offs[n] = o
            o += -(-math.prod(shp) // _SET_ALIGN) * _SET_ALIGN
        self._n_out = offs["x"]
        self._mem = torch.empty((2, o), dtype=dtype, device=dev)
        self.cores = [{n: self._mem[i, offs[n]:offs[n] + math.prod(shp)]
                       .view(shp) for n, shp in shapes} for i in (0, 1)]
        self.kept = 0
        self._consts = {}
        self._bound, self._drifts = None, {}
        CHUNK_BUFFERS["sets_built"] += 1
        if self._mem.is_cuda:
            self._card_setup(spec, offs)

    @property
    def scratch(self) -> int:
        return 1 - self.kept

    def keep(self) -> None:
        """The scratch set becomes the kept one."""
        self.kept = 1 - self.kept

    def zero_outputs(self, i: int) -> None:
        self._mem[i, :self._n_out].zero_()

    def state(self, i: int) -> dict:
        """Set ``i``'s cores under the chunk state's names: the working
        state xH, yH, vxH, vyH and the outputs (``fused_chunk_call``'s
        state and aux dicts merged), ``cnt`` per slot (nyp, K, nx)."""
        c = self.cores[i]
        return dict(
            xH=c["x"], yH=c["y"], vxH=c["vx"], vyH=c["vy"], drP=c["drho"],
            xP=c["x2"], yP=c["y2"], volH=c["vol"], b11H=c["b11"],
            b12H=c["b12"], b21H=c["b21"], b22H=c["b22"], rhoP=c["rho"],
            pP=c["p"], fxP=c["fx"], fyP=c["fy"], fpxP=c["fpx"],
            fpyP=c["fpy"], cnt=c["cnt"])

    def _card_setup(self, spec, offs):
        dev = self._mem.device
        self._cache, self._cache_keep = _cache_bufs(spec, self.R, self.kcut,
                                                    dev)
        self._rec = torch.zeros(16, dtype=torch.int32, device=dev)
        self._rec_in = torch.zeros(16, dtype=torch.int32, pin_memory=True)
        self._rec_out = torch.zeros(16, dtype=torch.int32, pin_memory=True)
        self._in_i = self._rec_in.numpy()
        self._in = self._in_i.view(np.float32)
        self._out_i = self._rec_out.numpy()
        self._out = self._out_i.view(np.float32)
        self._cells = torch.empty(4 * self.plain[0] * self.plain[2],
                                  dtype=torch.float32, device=dev)
        rec = self._rec.data_ptr()
        self._bufs, self._io, self._work = [], [], []
        for c in self.cores:
            ptrs = {n: t.data_ptr() for n, t in c.items()}
            self._bufs.append(_StepBufs(dyn=rec + 4 * REC_DYN, **ptrs))
            self._io.append(_ChunkIO(
                zero=ptrs["vol"], zero_bytes=4 * self._n_out,
                rec_in=self._rec_in.data_ptr(),
                rec_out=self._rec_out.data_ptr(), rec=rec))
            self._work.append([ptrs[n] for n in _SET_WORK])
        self._nbytes = [4 * math.prod(self.halo)] * 4 \
            + [4 * math.prod(self.plain)]
        self._span4 = 4 * (offs["vy"] - offs["x"]) + self._nbytes[3]

    def bind(self, lay, key=None) -> None:
        """Point both sets' step buffers at a layout's static cores and
        occupancy bound (checked here; the caller keeps ``lay`` alive
        while runs read it). ``key``: names a layout whose tensors never
        change (a persistent layout set), bound once while it stays
        bound."""
        if key is not None and key == self._bound:
            return
        self._bound = key
        dev = self._mem.device
        for t, n in ((lay.isf_c, "isf_c"), (lay.mass_c, "mass_c"),
                     (lay.wvx_c, "wvx_c"), (lay.wvy_c, "wvy_c")):
            _check(t, self.halo, n, dev)
        _check(lay.occ, (self.plain[0] // self.R, 1), "occ", dev,
               torch.int32)
        for b in self._bufs:
            b.isf, b.mass = lay.isf_c.data_ptr(), lay.mass_c.data_ptr()
            b.wvx, b.wvy = lay.wvx_c.data_ptr(), lay.wvy_c.data_ptr()
            b.occ = lay.occ.data_ptr()

    def const(self, spec, scalars, cache_slots: int = 0):
        """The kernel constants of ``spec`` and (rho0, p0, c_f,
        inv_sigma0, transport_coeff), built once (``_const``)."""
        key = (spec, tuple(scalars), cache_slots)
        c = self._consts.get(key)
        if c is None:
            if _shapes(spec, self.R)[:2] != (self.halo, self.plain):
                raise ValueError(f"spec's cores {_shapes(spec, self.R)[:2]}"
                                 f" are not these buffers' "
                                 f"{(self.halo, self.plain)}")
            c = self._consts[key] = _const(
                spec, self.R, *scalars, self.kcut, rows=self.kform == 2,
                cache_slots=cache_slots)
        return c

    def drift(self, refx, refy, isf, isf_halo: bool, row0: int, key=None):
        """The drift bounds' buffer struct over ``refx``'s rows, which are
        rows row0 .. of the chunk's plain cores (``fused_cell.DriftRef``;
        the caller keeps the tensors alive while runs read them).
        ``key``: as ``bind``'s, the struct kept for it."""
        if key is not None and key in self._drifts:
            return self._drifts[key]
        d = self._drift_struct(refx, refy, isf, isf_halo, row0)
        if key is not None:
            self._drifts[key] = d
        return d

    def _drift_struct(self, refx, refy, isf, isf_halo: bool, row0: int):
        dev = self._mem.device
        rows, K, nx = refx.shape[0], self.plain[1], self.plain[2]
        _check(refx, (rows, K, nx), "refx", dev)
        _check(refy, (rows, K, nx), "refy", dev)
        _check(isf, (rows + 2, K, nx + 2) if isf_halo else (rows, K, nx),
               "isf", dev)
        if not (0 <= row0 and row0 + rows <= self.plain[0]):
            raise ValueError(f"drift rows {row0} .. {row0 + rows - 1} are "
                             f"not inside the chunk's {self.plain[0]}")
        return _DriftBufs(refx.data_ptr(), refy.data_ptr(), isf.data_ptr(),
                          self._cells.data_ptr(), rows, row0, int(isf_halo))

    def launch(self, c, inputs, clock, dyn, n_sub: int, drift=None):
        """Up to ``n_sub`` steps of the chunk from ``inputs`` (xH, yH,
        vxH, vyH, drP, left intact) into the scratch set, as ``chunk``
        runs them, and the drift bounds of the final positions, in one
        ``sph_chunk_run``; then one synchronize. ``c``: ``const``;
        ``clock``: (t, t_comp, interval, dt_visc, dt_body); ``dyn``: (g,
        mu, wf); ``drift``: ``drift``'s struct, or None (bounds 0).
        Returns (bx, by, t, t_comp) as float32 numbers and the steps
        done."""
        dev = self._mem.device
        s = 1 - self.kept
        for t, n in zip(inputs, _CHUNK_IN):
            shp = self.plain if n == "drP" else self.halo
            if not (t.device == dev and t.dtype == torch.float32
                    and t.shape == shp and t.is_contiguous()):
                _check(t, shp, n, dev)
        src = [t.data_ptr() for t in inputs]
        dst = self._work[s]
        if src[:4] == self._work[self.kept][:4]:
            # the kept set's own working state: its halo'd cores are one
            # span
            spans = ((src[0], dst[0], self._span4),
                     (src[4], dst[4], self._nbytes[4]))
        else:
            spans = tuple(zip(src, dst, self._nbytes))
        io = self._io[s]
        for i, (a, b, nb) in enumerate(spans):
            io.src[i], io.dst[i], io.bytes[i] = a, b, nb
        io.ncopy = len(spans)
        r, ri = self._in, self._in_i
        r[REC_T:REC_DONE] = clock
        ri[REC_DONE:REC_DYN] = (0, n_sub, 0)
        r[REC_DYN:REC_BX] = (0.0, *dyn, 1.0)
        ri[REC_BX:REC_WORDS] = 0
        lib = _load()
        with torch.cuda.device(dev):
            _raise_on(lib.sph_chunk_run(
                ctypes.addressof(c), ctypes.addressof(self._bufs[s]),
                ctypes.addressof(self._cache), self.kform,
                ctypes.addressof(io),
                None if drift is None else ctypes.addressof(drift),
                int(n_sub), _stream(dev)), "sph_chunk_run")
            torch.cuda.current_stream(dev).synchronize()
        LAUNCHES[launch_key("fused_chunk", self.form)] += 1
        o = self._out
        return (o[REC_BX], o[REC_BY], o[REC_T], o[REC_TC],
                int(self._out_i[REC_DONE]))


# sph_rebuild's parameter block (csrc/fused_cell.cu ``RebuildBufs``): the
# grid, the constants, what it reads, the set it writes, its scratch
_REBUILD_INTS = ("n", "n_fluid", "nx", "ny", "nyp", "K", "R", "cap",
                 "src_halo", "first")
_REBUILD_FLOATS = ("DL", "inv_DL", "inv_cx", "inv_cy", "y0", "big_x",
                   "zero")
_REBUILD_IN = ("pidx0", "hidx0", "xs", "ys", "drs", "vxs", "vys", "cnt",
               "stat")
# a layout set's arrays in the order of its one allocation
_REBUILD_SET = ("pidx", "hidx", "isf", "mass", "wvx", "wvy", "wbot", "wtop",
                "refx", "refy", "xH", "yH", "vxH", "vyH", "drP", "occ", "ovf")
_REBUILD_SCRATCH = ("ints", "acc", "bucket", "cell", "owner", "part")

# ids a cell's bucket holds, per slot rank: a cell with more particles (an
# overflowing one) counts its ranks over every particle instead
REBUILD_CAP_PER_K = 2

# the x fill of empty slots (``fused_cell._BIG_X``)
_BIG_X = 1.0e9


class _RebuildBufs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in _REBUILD_INTS]
                + [(n, ctypes.c_float) for n in _REBUILD_FLOATS]
                + [(n, ctypes.c_void_p)
                   for n in _REBUILD_IN + _REBUILD_SET + _REBUILD_SCRATCH])


class RebuildBuffers:
    """The interval loop's rebuild for one key (halo'd and plain core
    shapes, particles, device, dtype): two layout sets, one contiguous
    allocation each, used in turn (``next_set``). A set holds a layout's
    take indices ``pidx``/``hidx`` (int64), its static halo'd cores
    ``isf``, ``mass``, ``wvx``, ``wvy``, ``wbot``, ``wtop``, the plain
    position references ``refx``/``refy``, the occupancy bound ``occ``
    (n_groups, 1) int32 and the overflow flag ``ovf`` (a 0-dim bool), and
    the next group's carry ``xH``, ``yH``, ``vxH``, ``vyH`` (halo'd) and
    ``drP`` (plain). ``pairs2`` and ``overflow_any`` are 0-dim int32
    words: twice the last rebuild's kept pair count (the per-slot counts
    are multiples of 1/2, so an integer sum of their doubles is exact; the
    float sum the count stands for is exact below 2^23 pairs) and the
    overflow of every rebuild since the last ``first`` one.

    On the card it also holds the scratch (the per-cell counts and id
    buckets, the particle per slot, the staged particle values) and one
    parameter block per set, and ``launch`` enqueues one ``sph_rebuild``.
    On the CPU the caller fills the sets (``fused_cell.BufferedRebuild``)."""

    def __init__(self, spec, R: int, halo, plain, dtype, dev):
        self.R, self.halo, self.plain = R, tuple(halo), tuple(plain)
        self.n, self.dtype, self.dev = spec.n_total, dtype, torch.device(dev)
        n, ng = self.n, self.plain[0] // R
        shapes = ([("pidx", (n,), torch.int64), ("hidx", (n,), torch.int64)]
                  + [(k, self.halo, dtype) for k in _REBUILD_SET[2:8]]
                  + [(k, self.plain, dtype) for k in ("refx", "refy")]
                  + [(k, self.halo, dtype) for k in ("xH", "yH", "vxH",
                                                     "vyH")]
                  + [("drP", self.plain, dtype), ("occ", (ng, 1), torch.int32),
                     ("ovf", (), torch.bool)])
        self._fields, o = [], 0
        for k, shp, dt in shapes:
            nb = math.prod(shp) * torch.empty((), dtype=dt).element_size()
            self._fields.append((k, shp, dt, o, nb))
            o += -(-nb // (4 * _SET_ALIGN)) * (4 * _SET_ALIGN)
        self.mem = torch.empty((2, o), dtype=torch.uint8, device=self.dev)
        self.cores = [self.views(self.mem[i]) for i in (0, 1)]
        self.last = 1
        self.card = self.mem.is_cuda
        REBUILD_BUFFERS["sets_built"] += 1
        if self.card:
            self._card_setup(spec, ng)
        else:
            self._words = torch.zeros(2, dtype=torch.int32, device=self.dev)
            self.pairs2, self.overflow_any = self._words[0], self._words[1]

    def views(self, row) -> dict:
        """A set's arrays as views into ``row``, one set's allocation (a
        row of ``mem`` or a copy of one)."""
        return {k: row[o:o + nb].view(dt).view(shp)
                for k, shp, dt, o, nb in self._fields}

    def next_set(self) -> int:
        """The set the next rebuild writes: the one the last did not."""
        self.last = 1 - self.last
        return self.last

    def _card_setup(self, spec, ng: int):
        if self.dtype != torch.float32:
            raise ValueError(f"sph_rebuild runs in float32 only, not "
                             f"{self.dtype}")
        nyp, K, nx = self.plain
        n, n_cells = self.n, spec.nx * spec.ny
        cap = REBUILD_CAP_PER_K * K
        i32 = dict(dtype=torch.int32, device=self.dev)
        self._scratch = dict(
            ints=torch.zeros(n_cells + ng + 2, **i32),
            acc=torch.zeros(1, **i32),
            bucket=torch.empty(n_cells * cap, **i32),
            cell=torch.empty(n, **i32), owner=torch.empty(nyp * K * nx, **i32),
            part=torch.empty(5 * n, dtype=torch.float32, device=self.dev))
        self.pairs2 = self._scratch["ints"][n_cells + ng + 1]
        self.overflow_any = self._scratch["acc"][0]
        # torch on the card takes a float32 tensor over a Python float as
        # the product with the reciprocal, taken in double and rounded to
        # float32 (chip_smoke.py phase 10 holds the rebuild to it)
        f32 = np.float32
        consts = dict(
            n=n, n_fluid=spec.n_fluid, nx=nx, ny=spec.ny, nyp=nyp, K=K,
            R=self.R, cap=cap, DL=float(f32(spec.DL)),
            inv_DL=float(f32(1.0 / spec.DL)),
            inv_cx=float(f32(1.0 / spec.cell_x)),
            inv_cy=float(f32(1.0 / spec.cell_y)), y0=float(f32(spec.y0)),
            big_x=float(f32(_BIG_X)), zero=0.0)
        scratch = {k: t.data_ptr() for k, t in self._scratch.items()}
        self._structs = [
            _RebuildBufs(**consts, **scratch,
                         **{k: t.data_ptr() for k, t in c.items()})
            for c in self.cores]

    def launch(self, i: int, pidx0, hidx0, xs, ys, drs, vxs, vys, cnt, stat,
               src_halo: bool, first: bool) -> None:
        """Enqueue the rebuild of set ``i`` (``sph_rebuild``) from the old
        layout's ``pidx0``/``hidx0`` and the kept state: ``xs``/``ys``
        plain (halo'd with ``src_halo``), ``drs`` plain, ``vxs``/``vys``
        halo'd, ``cnt`` the plain per-slot pair counts (None: nothing kept,
        0 pairs), ``stat`` (6, n) the per-particle static fields
        (``fused_cell.layout_statics``); ``first`` resets
        ``overflow_any``. Checks every input, raises off the card; no
        sync."""
        dev, n = self.dev, self.n
        pos = self.halo if src_halo else self.plain
        ins = ((pidx0, (n,), "pidx0", torch.int64),
               (hidx0, (n,), "hidx0", torch.int64),
               (xs, pos, "xs", self.dtype), (ys, pos, "ys", self.dtype),
               (drs, self.plain, "drs", self.dtype),
               (vxs, self.halo, "vxs", self.dtype),
               (vys, self.halo, "vys", self.dtype),
               (stat, (6, n), "stat", self.dtype))
        if cnt is not None:
            ins += ((cnt, self.plain, "cnt", self.dtype),)
        for t, shp, name, dt in ins:
            if not (t.device == dev and t.dtype == dt and t.shape == shp
                    and t.is_contiguous()):
                _check_on(t, shp, name, dev, dt)
        if not self.card:
            raise ValueError("sph_rebuild runs on a CUDA card: on the CPU "
                             "the plain twin fills the layout sets")
        b = self._structs[i]
        (b.pidx0, b.hidx0, b.xs, b.ys, b.drs, b.vxs, b.vys, b.stat) = (
            t.data_ptr() for t in (pidx0, hidx0, xs, ys, drs, vxs, vys,
                                   stat))
        b.cnt = None if cnt is None else cnt.data_ptr()
        b.src_halo, b.first = int(src_halo), int(first)
        lib = _load()
        with torch.cuda.device(dev):
            _raise_on(lib.sph_rebuild(ctypes.addressof(b), _stream(dev)),
                      "sph_rebuild")
        LAUNCHES["fused_rebuild"] += 1


@functools.lru_cache(maxsize=8)
def _shear_const(spec, R: int):
    return _const(spec, R, 1.0, 0.0, 0.0, 0.0, 0.0)


def wall_shear(spec, R: int, lay, xH, yH, vxH, volH, b11H, b12H, b21H,
               b22H, mu, wf):
    """Per-slot wall-shear partials (the JAX _shear_kernel) as one
    (2, nyp, K, nx) tensor, bottom then top; the caller sums them. The
    kernel runs over the layout's wall rows (``lay.shear_rows``) only and
    writes them into ``lay.shear_tbt``, whose other slots hold +0: the
    tensor returned is that buffer, rewritten by the next call."""
    halo, plain, nyp = _shapes(spec, R)
    dev = xH.device
    rows, tbt = lay.shear_rows, lay.shear_tbt
    cores = (xH, yH, lay.isf_c, volH, vxH, b11H, b12H, b21H, b22H,
             lay.wvx_c, lay.wbot_c, lay.wtop_c)
    for n, t in zip(_SHEAR_PTRS, cores):
        if not (t.device == dev and t.dtype == torch.float32
                and t.shape == halo and t.is_contiguous()):
            _check(t, halo, n, dev)
    _check(lay.occ, (nyp // R, 1), "occ", dev, torch.int32)
    _check(rows, rows.shape[:1], "shear_rows", dev, torch.int32)
    _check(tbt, (2,) + plain, "shear_tbt", dev)
    tb = tbt.data_ptr()
    bufs = _ShearBufs(*(t.data_ptr() for t in cores), lay.occ.data_ptr(),
                      rows.data_ptr(), tb, tb + 4 * math.prod(plain),
                      float(mu), float(wf), rows.shape[0])
    c = _shear_const(spec, R)
    lib = _load()
    with torch.cuda.device(dev):
        _raise_on(lib.sph_shear(ctypes.addressof(c), ctypes.addressof(bufs),
                                _stream(dev)), "sph_shear")
    LAUNCHES["fused_wall_shear"] += 1
    return tbt
