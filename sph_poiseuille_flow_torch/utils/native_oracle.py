"""ctypes bindings for the native host-side oracle (native/sph_oracle.cpp;
the port's own copy of the JAX package's ``utils/native_oracle.py``, numpy
only).

Auto-builds ``libsph_oracle.so`` via CMake and g++ on first use, cached
OUTSIDE the repo tree (``$SPH_ORACLE_BUILD_DIR`` or
``~/.cache/sph_oracle_build_torch``) so generated artifacts never pollute
the source tree. An independent float64 reference of the gather engine's
operators (the reference's MEX modes over a store-once pair list) for the
tests and for ``chip_smoke.py`` on a machine without JAX.
"""

from __future__ import annotations

import ctypes as ct
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "native"))
_LIB: Optional[ct.CDLL] = None

_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def build_library(native_dir: str = _NATIVE_DIR) -> str:
    """Build (if needed) and return the path of libsph_oracle.so."""
    build_dir = os.environ.get(
        "SPH_ORACLE_BUILD_DIR",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "sph_oracle_build_torch"))
    lib_path = os.path.join(build_dir, "libsph_oracle.so")
    src_path = os.path.join(native_dir, "sph_oracle.cpp")
    if (os.path.exists(lib_path)
            and os.path.getmtime(lib_path) >= os.path.getmtime(src_path)):
        return lib_path
    os.makedirs(build_dir, exist_ok=True)
    subprocess.run(["cmake", "-S", native_dir, "-B", build_dir,
                    "-DCMAKE_BUILD_TYPE=Release"],
                   check=True, capture_output=True)
    subprocess.run(["cmake", "--build", build_dir, "--parallel"],
                   check=True, capture_output=True)
    if not os.path.exists(lib_path):
        raise RuntimeError(f"native build produced no library at {lib_path}")
    return lib_path


def _lib() -> ct.CDLL:
    global _LIB
    if _LIB is None:
        lib = ct.CDLL(build_library())
        lib.sph_build_pairs.restype = ct.c_int64
        lib.sph_build_pairs.argtypes = [
            _f64p, _f64p, ct.c_int64, ct.c_int64, ct.c_double, ct.c_double,
            ct.c_int64, _i32p, _i32p, _f64p, _f64p, _f64p, _f64p, _f64p]
        lib.sph_density_correction.restype = None
        lib.sph_density_correction.argtypes = [
            _i32p, _i32p, _f64p, _f64p, _f64p, _f64p, _f64p, ct.c_int64,
            _f64p, ct.c_int64, ct.c_int64, ct.c_double, ct.c_double,
            ct.c_double, _f64p, _f64p, _f64p]
        lib.sph_viscous_force.restype = None
        lib.sph_viscous_force.argtypes = [
            _i32p, _i32p, _f64p, _f64p, _f64p, _f64p, ct.c_int64, _f64p,
            _f64p, _f64p, ct.c_double, ct.c_double, ct.c_int64, ct.c_int64,
            _f64p, _f64p]
        lib.sph_transport_correction.restype = None
        lib.sph_transport_correction.argtypes = [
            _i32p, _i32p, _f64p, _f64p, _f64p, _f64p, ct.c_int64, _f64p,
            _f64p, ct.c_double, ct.c_int64, ct.c_int64, ct.c_double, _f64p]
        lib.sph_integration_verlet.restype = None
        lib.sph_integration_verlet.argtypes = [
            _i32p, _i32p, _f64p, _f64p, _f64p, _f64p, ct.c_int64, _f64p,
            _f64p, _f64p, ct.c_double, ct.c_int64, ct.c_int64, ct.c_double,
            ct.c_double, ct.c_double, _f64p, _f64p, _f64p, _f64p, _f64p,
            _f64p, _f64p, _f64p]
        lib.sph_wall_shear.restype = None
        lib.sph_wall_shear.argtypes = [
            _i32p, _i32p, _f64p, _f64p, _f64p, _f64p, ct.c_int64, _f64p,
            _f64p, _f64p, _f64p, _f64p, ct.c_int64, ct.c_double,
            ct.c_double, ct.c_double, ct.c_double,
            ct.POINTER(ct.c_double), ct.POINTER(ct.c_double)]
        _LIB = lib
    return _LIB


def build_pairs(x, y, n_fluid: int, DL: float, h: float):
    """Store-once pair list from the native cell-list search."""
    lib = _lib()
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    n_total = x.size
    cap = max(n_fluid * 64, 1024)
    while True:
        pi = np.empty(cap, np.int32)
        pj = np.empty(cap, np.int32)
        dx = np.empty(cap, np.float64)
        dy = np.empty(cap, np.float64)
        r = np.empty(cap, np.float64)
        w = np.empty(cap, np.float64)
        dw = np.empty(cap, np.float64)
        n = int(lib.sph_build_pairs(x, y, n_fluid, n_total, h, DL, cap,
                                    pi, pj, dx, dy, r, w, dw))
        if n >= 0:
            return (pi[:n].copy(), pj[:n].copy(), dx[:n].copy(),
                    dy[:n].copy(), r[:n].copy(), w[:n].copy(),
                    dw[:n].copy())
        cap *= 2


def density_correction(pairs, mass, n_fluid, n_total, rho0, h, inv_sigma0):
    lib = _lib()
    pi, pj, dx, dy, r, w, dw = [np.ascontiguousarray(a) for a in pairs]
    mass = np.ascontiguousarray(mass, np.float64)
    rho = np.empty(n_total, np.float64)
    vol = np.empty(n_total, np.float64)
    b = np.empty((n_total, 4), np.float64)
    lib.sph_density_correction(pi, pj, dx, dy, r, w, dw, pi.size, mass,
                               n_fluid, n_total, rho0, h, inv_sigma0,
                               rho, vol, b.reshape(-1))
    return rho, vol, b


def viscous_force(pairs, vel, vol, b, mu, h, n_fluid, n_total, wall_vel):
    lib = _lib()
    pi, pj, dx, dy, r, w, dw = [np.ascontiguousarray(a) for a in pairs]
    force = np.zeros((n_total, 2), np.float64)
    lib.sph_viscous_force(
        pi, pj, dx, dy, r, dw, pi.size,
        np.ascontiguousarray(vel, np.float64).reshape(-1),
        np.ascontiguousarray(vol, np.float64),
        np.ascontiguousarray(b, np.float64).reshape(-1),
        mu, h, n_fluid, n_total,
        np.ascontiguousarray(wall_vel, np.float64).reshape(-1),
        force.reshape(-1))
    return force


def transport_correction(pairs, vol, b, pos, h, n_fluid, n_total, coeff):
    lib = _lib()
    pi, pj, dx, dy, r, w, dw = [np.ascontiguousarray(a) for a in pairs]
    pos_out = np.ascontiguousarray(pos, np.float64).copy()
    lib.sph_transport_correction(
        pi, pj, dx, dy, r, dw, pi.size,
        np.ascontiguousarray(vol, np.float64),
        np.ascontiguousarray(b, np.float64).reshape(-1),
        h, n_fluid, n_total, coeff, pos_out.reshape(-1))
    return pos_out


def integration_verlet(pairs, vol, b, rho, mass, pos, vel, drho,
                       force_prior, dt, n_fluid, n_total, rho0, p0, c_f,
                       wall_vel):
    lib = _lib()
    pi, pj, dx, dy, r, w, dw = [np.ascontiguousarray(a) for a in pairs]
    rho = np.ascontiguousarray(rho, np.float64).copy()
    p = np.zeros(n_total, np.float64)
    pos = np.ascontiguousarray(pos, np.float64).copy()
    vel = np.ascontiguousarray(vel, np.float64).copy()
    drho = np.ascontiguousarray(drho, np.float64).copy()
    force = np.zeros((n_total, 2), np.float64)
    lib.sph_integration_verlet(
        pi, pj, dx, dy, r, dw, pi.size,
        np.ascontiguousarray(vol, np.float64),
        np.ascontiguousarray(b, np.float64).reshape(-1),
        np.ascontiguousarray(mass, np.float64),
        dt, n_fluid, n_total, rho0, p0, c_f,
        np.ascontiguousarray(wall_vel, np.float64).reshape(-1),
        np.ascontiguousarray(force_prior, np.float64).reshape(-1),
        rho, p, pos.reshape(-1), vel.reshape(-1), drho,
        force.reshape(-1))
    return rho, p, pos, vel, drho, force


def wall_shear_monitor(pairs, pos, vel, wall_vel, vol, b, n_fluid, DL, DH,
                       mu, h):
    lib = _lib()
    pi, pj, dx, dy, r, w, dw = [np.ascontiguousarray(a) for a in pairs]
    tb = ct.c_double()
    tt = ct.c_double()
    lib.sph_wall_shear(
        pi, pj, dx, dy, r, dw, pi.size,
        np.ascontiguousarray(pos, np.float64).reshape(-1),
        np.ascontiguousarray(vel, np.float64).reshape(-1),
        np.ascontiguousarray(wall_vel, np.float64).reshape(-1),
        np.ascontiguousarray(vol, np.float64),
        np.ascontiguousarray(b, np.float64).reshape(-1),
        n_fluid, DL, DH, mu, h, ct.byref(tb), ct.byref(tt))
    return tb.value, tt.value
