"""Build, binding and launch wrappers of the hand-written CUDA kernels in
``csrc/fused_cell.cu`` (the Hopper port of the JAX package's Pallas
kernels: the fused step and the multi-step chunk, each in its recompute,
geometry-cache and row-outer forms, and the wall-shear monitor; and the
probes' kernels: the step cut to a sweep range, the no-op over the step's
buffers and the one-hot lane tiling).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (into ``build/`` beside the package,
keyed by a hash of the source) and loaded with ``ctypes``. Nothing here
runs when the module is imported, so CPU-only installs import it freely.

Each wrapper checks device, dtype (float32), shape and contiguity, launches
on PyTorch's current stream without synchronising, raises when the C entry
point reports a CUDA error, and adds one to its entry of ``LAUNCHES`` (one
entry per kernel and form). A form it does not know raises; no form gives
way to another.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

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
# the step (``StepBuffers.sweeps``)
LAUNCHES = {"fused_step": 0, "fused_step_cache": 0, "fused_step_rows": 0,
            "fused_chunk": 0, "fused_chunk_cache": 0, "fused_chunk_rows": 0,
            "fused_wall_shear": 0, "fused_step_sweeps": 0,
            "fused_step_sweeps_cache": 0, "fused_step_sweeps_rows": 0,
            "fused_noop": 0, "expand_onehot": 0}

# form name -> (kernel form of csrc/fused_cell.cu, LAUNCHES suffix)
_FORMS = {"none": (0, ""), "full": (1, "_cache"), "ring": (1, "_cache"),
          "partial": (1, "_cache"), "rows": (2, "_rows")}

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class _Const(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("nyp", "K", "nx", "R", "kcut",
                                              "ncs", "tx")]
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
               "wvx", "wbot", "wtop", "occ", "tb", "tt")


_CACHE_PTRS = ("idx", "ex", "ey", "r", "c1", "cw", "n")


class _CacheBufs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _CACHE_PTRS]


class _ShearBufs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in _SHEAR_PTRS]
                + [("mu", ctypes.c_float), ("wf", ctypes.c_float)])


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
        lib.sph_chunk.argtypes = [vp, vp, vp, ip, vp, vp, ip, vp]
        lib.sph_shear.argtypes = [vp, vp, vp]
        lib.sph_noop.argtypes = [vp, vp, vp]
        lib.sph_expand.argtypes = [vp, vp, ip, ip, ip, vp]
        for fn in (lib.sph_step, lib.sph_step_sweeps, lib.sph_chunk,
                   lib.sph_shear, lib.sph_noop, lib.sph_expand):
            fn.restype = ip
        _lib = lib
    return _lib


def _const(spec, R: int, rho0, p0, c_f, inv_sigma0, transport_coeff,
           kcut: int = 0):
    """Kernel constants, each rounded once from float64 as the JAX
    package's weakly-typed Python scalars are. ``kcut``: cached anchor
    ranks of the geometry-cache form."""
    h = spec.h
    sigma = sigma_2d(h)
    soh = sigma / h
    nyp = _shapes(spec, R)[2]
    return _Const(
        nyp=nyp, K=spec.K, nx=spec.nx, R=R, kcut=kcut,
        ncs=nyp * kcut * spec.nx, tx=max(1, 128 // spec.K), DL=spec.DL, h=h,
        cut2=spec.cutoff * spec.cutoff, sigma=sigma, sig025=sigma * 0.25,
        c225soh=2.25 * soh, c3soh=3.0 * soh, cm075soh=-0.75 * soh,
        rho0=rho0, p0=p0, c_f=c_f, inv_sigma0=inv_sigma0,
        inv_rho0=1.0 / rho0, tchh=transport_coeff * h * h, h001=0.01 * h,
        hh=h * h, c025h=0.25 * h)


def _check(t: torch.Tensor, shape, name: str, device,
           dtype=torch.float32):
    if not t.is_cuda or t.device != device:
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
    anchor slots, structure of arrays with the slot fastest. Returns the
    pointer struct and the tensors that back it (kept alive by the
    caller until the launches are enqueued)."""
    if kcut == 0:
        return _CacheBufs(), ()
    ncs = _shapes(spec, R)[2] * kcut * spec.nx
    n_e = 9 * spec.K * ncs
    keep = (torch.empty(n_e, dtype=torch.int32, device=dev),
            *(torch.empty(n_e, dtype=torch.float32, device=dev)
              for _ in range(5)),
            torch.empty(ncs, dtype=torch.int32, device=dev))
    return _CacheBufs(*(t.data_ptr() for t in keep)), keep


def _step_setup(spec, R: int, lay, xH, yH, vxH, vyH, drP, dt, scalars,
                form: str, k_cut: int):
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
    c = _const(spec, R, rho0, p0, c_f, inv_sigma0, transport_coeff, kcut)
    return lib, kform, c, bufs, out, dyn, cache, keep


def step(spec, R: int, lay, xH, yH, vxH, vyH, drP, dt, scalars,
         form: str = "none", k_cut: int = 0):
    """One fused step (the JAX _step_kernel) in ``form``: four sweep
    launches. Returns the output cores with ``cnt`` per slot
    (nyp, K, nx)."""
    lib, kform, c, bufs, out, dyn, cache, keep = _step_setup(
        spec, R, lay, xH, yH, vxH, vyH, drP, dt, scalars, form, k_cut)
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

    Sweeps 1-3 read what the earlier sweeps left in the buffers, so a
    sweep relaunched over a completed step writes what the step wrote, bit
    for bit, with one exception: in the cache form sweep 1 folds Vol_j into
    the list in place (csrc/fused_cell.cu ``kgc_each``), so it writes what
    it reads. ``rewrites`` names such sweeps; take a ``snapshot`` of the
    list after sweep 0 and ``restore`` it before each relaunch of sweep 1.
    A cache-form range that would read the list in the wrong state raises:
    sweep 1 needs the list as sweep 0 wrote it, sweeps 2-3 as sweep 1
    folded it."""

    def __init__(self, spec, R: int, lay, xH, yH, vxH, vyH, drP, dt,
                 scalars, form: str = "none", k_cut: int = 0):
        (self._lib, self._kform, self._c, self._bufs, self._out,
         self._dyn, self._cache, self._keep) = _step_setup(
            spec, R, lay, xH, yH, vxH, vyH, drP, dt, scalars, form, k_cut)
        # every tensor the structs point to lives as long as the buffers
        self._inputs = (xH, yH, vxH, vyH, drP, lay)
        self.dev = xH.device
        self.key = launch_key("fused_step_sweeps", form)
        self.rewrites = (1,) if self._kform == 1 else ()
        self._listed = self._folded = False   # sweep 0 / 1 left the list
        self._saved = None

    def _call(self, what: str, fn, *args):
        with torch.cuda.device(self.dev):
            _raise_on(fn(ctypes.addressof(self._c),
                         ctypes.addressof(self._bufs), *args,
                         _stream(self.dev)), what)

    def sweeps(self, first: int = 0, count: int = 4) -> None:
        """Launch sweeps ``first .. first+count-1`` (sph_step_sweeps)."""
        check_sweep_range(first, count)
        if self.rewrites and first > 0:
            if not self._listed:
                raise ValueError("the cache form's sweeps 1-3 read the "
                                 "list that sweep 0 writes: launch sweep 0 "
                                 "on these buffers first")
            if first == 1 and self._folded:
                raise RuntimeError("cache-form sweep 1 folds Vol_j into the "
                                   "list in place: restore() the list "
                                   "before launching it again")
            if first > 1 and not self._folded:
                raise RuntimeError("cache-form sweeps 2-3 read the list "
                                   "that sweep 1 folds: launch sweep 1 "
                                   "first")
        self._call("sph_step_sweeps", self._lib.sph_step_sweeps,
                   ctypes.addressof(self._cache), self._kform, first, count)
        LAUNCHES[self.key] += 1
        if self.rewrites:
            if first == 0:
                self._listed, self._folded = True, False
            if first <= 1 < first + count:
                self._folded = True

    def snapshot(self) -> int:
        """Keep the list as sweep 0 wrote it (cache form): the entries in
        use of c1 and cw. Entry e of cached slot s sits at e*ncs + s, so
        the first max(n)*ncs entries hold every slot's n[s]; the rest of
        the 9K capacity stays out of the copy (and out of L2). Sweep 0
        writes n only for visited slots (rank k < occ of the row's group),
        so the max is taken over those. Returns the bytes that each
        ``restore`` copies."""
        if not self._listed or self._folded:
            raise RuntimeError("snapshot() takes the list between sweep 0 "
                               "and sweep 1")
        c = self._c
        n = self._keep[6].view(c.nyp, c.kcut, c.nx)
        occ = self._inputs[5].occ.reshape(-1).repeat_interleave(c.R)
        vis = torch.arange(c.kcut, device=self.dev)[None, :] < occ[:, None]
        used = int(torch.where(vis[:, :, None], n, 0).max()) * n.numel()
        self._saved = [t[:used].clone() for t in self._keep[4:6]]  # c1, cw
        return 2 * used * 4

    def restore(self) -> None:
        """Put back the list of the last ``snapshot`` (cache form)."""
        if self._saved is None:
            raise RuntimeError("restore() needs a snapshot()")
        for t, v in zip(self._keep[4:6], self._saved):
            t[:v.numel()].copy_(v)
        self._folded = False

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
          k_cut: int = 0):
    """Up to ``n_sub`` steps (the JAX _chunk_kernel) in ``form`` with no
    host sync: per step a control launch (v_max, dt, active flag, Kahan
    clock on device), four sweeps and a halo refresh. The inputs are
    copied into the working state first, so they stay intact. Returns
    ((xH, yH, vxH, vyH, drP) working state, output cores, steps, t,
    t_comp), the last three as 0-dim device tensors."""
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
    cache, keep = _cache_bufs(spec, R, kcut, dev)
    c = _const(spec, R, rho0, p0, c_f, inv_sigma0, transport_coeff, kcut)
    with torch.cuda.device(dev):
        _raise_on(lib.sph_chunk(ctypes.addressof(c), ctypes.addressof(bufs),
                                ctypes.addressof(cache), kform,
                                clock.data_ptr(), steps.data_ptr(),
                                int(n_sub), _stream(dev)), "sph_chunk")
    del keep  # a later allocation on this stream runs after the launches
    LAUNCHES[launch_key("fused_chunk", form)] += 1
    return work, _outputs(out), steps[0], clock[0], clock[1]


def wall_shear(spec, R: int, lay, xH, yH, vxH, volH, b11H, b12H, b21H,
               b22H, mu, wf):
    """Per-slot (bottom, top) wall-shear partials (the JAX
    _shear_kernel); the caller sums them."""
    lib = _load()
    halo, plain, nyp = _shapes(spec, R)
    fields = dict(x=xH, y=yH, isf=lay.isf_c, vol=volH, vx=vxH, b11=b11H,
                  b12=b12H, b21=b21H, b22=b22H, wvx=lay.wvx_c,
                  wbot=lay.wbot_c, wtop=lay.wtop_c)
    dev = xH.device
    for n, t in fields.items():
        _check(t, halo, n, dev)
    _check(lay.occ, (nyp // R, 1), "occ", dev, torch.int32)
    tb = torch.zeros(plain, dtype=torch.float32, device=dev)
    tt = torch.zeros(plain, dtype=torch.float32, device=dev)
    ptrs = dict(fields, occ=lay.occ, tb=tb, tt=tt)
    bufs = _ShearBufs(**{n: ptrs[n].data_ptr() for n in _SHEAR_PTRS},
                      mu=float(mu), wf=float(wf))
    c = _const(spec, R, 1.0, 0.0, 0.0, 0.0, 0.0)
    with torch.cuda.device(dev):
        _raise_on(lib.sph_shear(ctypes.addressof(c), ctypes.addressof(bufs),
                                _stream(dev)), "sph_shear")
    LAUNCHES["fused_wall_shear"] += 1
    return tb, tt
