"""The port's bindings of the native C++ oracle
(``sph_poiseuille_flow_torch/utils/native_oracle.py``, native/sph_oracle.cpp
built with CMake on first use) against the pure-NumPy oracle, and the
port's gather-engine operators (``ops/``, float64) against the native
oracle: tests/test_native_oracle.py's cross-check with the port in the
JAX package's place.

The oracle stores each fluid-fluid pair once and scatters both ways; the
port's operators sum dense rows that hold each pair once per direction.
The same float64 terms add in another order, so they agree to round-off:
1e-9 relative (1e-12 absolute), tests/test_native_oracle.py's bound
between the native and the NumPy oracle."""

import dataclasses

import numpy as np
import pytest
import torch

import oracle_numpy
from sph_poiseuille_flow_torch.config import SPHConfig
from sph_poiseuille_flow_torch.models.poiseuille import build_scene
from sph_poiseuille_flow_torch.ops import density as tden
from sph_poiseuille_flow_torch.ops import integration as tint
from sph_poiseuille_flow_torch.ops import monitors as tmon
from sph_poiseuille_flow_torch.ops import neighbors as tnb
from sph_poiseuille_flow_torch.ops.transport import transport_correction
from sph_poiseuille_flow_torch.ops.viscosity import viscous_force
from sph_poiseuille_flow_torch.utils import native_oracle

from test_config import default_cfg

torch.set_num_threads(1)

TOL = dict(rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def setup():
    """tests/test_native_oracle.py's jittered state (seed 11)."""
    cfg = SPHConfig(**dataclasses.asdict(default_cfg(
        DL=1.0, DH=0.5, dp=0.05, end_time=1.0, dtype="float64")))
    scene = build_scene(cfg)
    rng = np.random.default_rng(11)
    nf, n = scene.n_fluid, scene.n_total
    x = np.asarray(scene.x, np.float64).copy()
    y = np.asarray(scene.y, np.float64).copy()
    x[:nf] = np.mod(x[:nf] + rng.uniform(-0.3, 0.3, nf) * cfg.dp, cfg.DL)
    y[:nf] += rng.uniform(-0.3, 0.3, nf) * cfg.dp
    vel = np.zeros((n, 2))
    vel[:nf] = rng.normal(0, 0.3, (nf, 2))
    drho = np.zeros(n)
    drho[:nf] = rng.normal(0, 0.05, nf)
    fprior = np.zeros((n, 2))
    fprior[:nf] = rng.normal(0, 0.01, (nf, 2))
    wall_vel = np.zeros((n, 2))
    pairs = native_oracle.build_pairs(x, y, nf, cfg.DL, cfg.h)
    return dict(cfg=cfg, scene=scene, x=x, y=y, vel=vel, drho=drho,
                fprior=fprior, wall_vel=wall_vel, pairs=pairs)


def _sorted_pairs(pairs):
    order = np.lexsort((pairs[1], pairs[0]))
    return tuple(np.asarray(a)[order] for a in pairs)


def test_pairs_match_numpy(setup):
    s = setup
    cfg, scene = s["cfg"], s["scene"]
    pairs_c = _sorted_pairs(s["pairs"])
    pairs_np = _sorted_pairs(oracle_numpy.build_pairs(
        s["x"], s["y"], scene.n_fluid, cfg.DL, cfg.h))
    assert pairs_c[0].size == pairs_np[0].size > 0
    np.testing.assert_array_equal(pairs_c[0], pairs_np[0])
    np.testing.assert_array_equal(pairs_c[1], pairs_np[1])
    for a, b in zip(pairs_c[2:], pairs_np[2:]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)


def test_full_step_matches_numpy(setup):
    s = setup
    cfg, scene, pairs = s["cfg"], s["scene"], s["pairs"]
    nf, n = scene.n_fluid, scene.n_total
    rho_c, vol_c, b_c = native_oracle.density_correction(
        pairs, scene.mass, nf, n, cfg.rho0, cfg.h, cfg.inv_sigma0)
    rho_n, vol_n, b_n = oracle_numpy.density_correction(
        pairs, scene.mass, nf, n, cfg.rho0, cfg.h, cfg.inv_sigma0)
    np.testing.assert_allclose(rho_c, rho_n, rtol=1e-12)
    np.testing.assert_allclose(b_c, b_n, **TOL)
    pos = np.stack([s["x"], s["y"]], axis=1)
    out_c = native_oracle.integration_verlet(
        pairs, vol_c, b_c, rho_c, scene.mass, pos, s["vel"], s["drho"],
        s["fprior"], 1e-3, nf, n, cfg.rho0, cfg.p0, cfg.c_f, s["wall_vel"])
    out_n = oracle_numpy.integration_verlet(
        pairs, vol_n, b_n, rho_n, scene.mass, pos, s["vel"], s["drho"],
        s["fprior"], 1e-3, nf, n, cfg.rho0, cfg.p0, cfg.c_f, s["wall_vel"])
    for a, b in zip(out_c, out_n):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.fixture(scope="module")
def port_ops(setup):
    """The port's operators in float64 on the same state: candidates and
    geometry, density and KGC, then each operator on the oracle's own
    volumes and B (so each compares on the same inputs)."""
    s = setup
    cfg, scene = s["cfg"], s["scene"]
    nf, n = scene.n_fluid, scene.n_total
    f64 = torch.float64

    def t(a):
        return torch.tensor(np.asarray(a), dtype=f64)

    spec = tnb.make_grid_spec(cfg, scene)
    x, y, mass = t(s["x"]), t(s["y"]), t(scene.mass)
    z = torch.zeros(n, dtype=f64)
    cands = tnb.build_candidates(spec, x, y, mass, z, z)
    assert not bool(cands.overflow)
    geom = tnb.compute_geometry(spec, cands, x, y, z)
    rho, vol = tden.density_sums(spec, geom, cands, mass, cfg.rho0,
                                 cfg.inv_sigma0)
    (vol_j,) = tnb.gather_pack(cands.jsafe, (vol,))
    b = tden.kernel_gradient_correction(spec, geom, vol_j)

    rho_c, vol_c, b_c = native_oracle.density_correction(
        s["pairs"], scene.mass, nf, n, cfg.rho0, cfg.h, cfg.inv_sigma0)
    vol_o, rho_o = t(vol_c), t(rho_c)
    b_o = [t(b_c[:, k]) for k in range(4)]
    geom = tnb.compute_geometry(spec, cands, x, y, vol_o)
    vx, vy = t(s["vel"][:, 0]), t(s["vel"][:, 1])
    js = cands.jsafe
    vol_j, vx_j, vy_j = tnb.gather_pack(js, (vol_o, vx, vy))
    bj = tnb.gather_pack(js, b_o)
    visc = viscous_force(spec, geom, cands, vx, vy, vol_o, *b_o, vol_j, *bj,
                         vx_j, vy_j, cfg.mu, cfg.h, 4.0)
    shifted = transport_correction(spec, geom, x, y, *b_o, vol_j, *bj, cfg.h,
                                   cfg.transport_coeff)
    verlet = tint.verlet_step(
        spec, geom, cands, vol_o, *b_o, rho_o, mass, x, y, vx, vy,
        t(s["drho"]), t(s["fprior"][:, 0]), t(s["fprior"][:, 1]),
        torch.tensor(1e-3, dtype=f64), cfg.rho0, cfg.p0, cfg.c_f)
    shear = tmon.wall_shear(spec, geom, cands, vx, vol_o, *b_o, cfg.DL,
                            cfg.mu, cfg.h, 4.0)
    return dict(rho=rho, vol=vol, b=b, visc=visc, shifted=shifted,
                verlet=verlet, shear=shear)


def test_port_density_and_kgc_match_native(setup, port_ops):
    s = setup
    scene, cfg = s["scene"], s["cfg"]
    rho_c, vol_c, b_c = native_oracle.density_correction(
        s["pairs"], scene.mass, scene.n_fluid, scene.n_total, cfg.rho0,
        cfg.h, cfg.inv_sigma0)
    np.testing.assert_allclose(port_ops["rho"].numpy(), rho_c, **TOL)
    np.testing.assert_allclose(port_ops["vol"].numpy(), vol_c, **TOL)
    for k in range(4):
        np.testing.assert_allclose(port_ops["b"][k].numpy(), b_c[:, k],
                                   **TOL)


def test_port_forces_and_shift_match_native(setup, port_ops):
    s = setup
    scene, cfg, pairs = s["scene"], s["cfg"], s["pairs"]
    nf, n = scene.n_fluid, scene.n_total
    _, vol_c, b_c = native_oracle.density_correction(
        pairs, scene.mass, nf, n, cfg.rho0, cfg.h, cfg.inv_sigma0)
    f_c = native_oracle.viscous_force(pairs, s["vel"], vol_c, b_c, cfg.mu,
                                      cfg.h, nf, n, s["wall_vel"])
    for k in range(2):
        np.testing.assert_allclose(port_ops["visc"][k].numpy(), f_c[:, k],
                                   **TOL)
    pos = np.stack([s["x"], s["y"]], axis=1)
    p_c = native_oracle.transport_correction(pairs, vol_c, b_c, pos, cfg.h,
                                             nf, n, cfg.transport_coeff)
    for k in range(2):
        np.testing.assert_allclose(port_ops["shifted"][k].numpy(),
                                   p_c[:, k], **TOL)


def test_port_verlet_and_shear_match_native(setup, port_ops):
    s = setup
    scene, cfg, pairs = s["scene"], s["cfg"], s["pairs"]
    nf, n = scene.n_fluid, scene.n_total
    rho_c, vol_c, b_c = native_oracle.density_correction(
        pairs, scene.mass, nf, n, cfg.rho0, cfg.h, cfg.inv_sigma0)
    pos = np.stack([s["x"], s["y"]], axis=1)
    rho, p, pos2, vel2, drho, force = native_oracle.integration_verlet(
        pairs, vol_c, b_c, rho_c, scene.mass, pos, s["vel"], s["drho"],
        s["fprior"], 1e-3, nf, n, cfg.rho0, cfg.p0, cfg.c_f, s["wall_vel"])
    got = [a.numpy() for a in port_ops["verlet"]]
    want = (rho, p, pos2[:, 0], pos2[:, 1], vel2[:, 0], vel2[:, 1], drho,
            force[:, 0], force[:, 1])
    for name, g, w in zip(("rho", "p", "x", "y", "vx", "vy", "drho", "fx",
                           "fy"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    tb, tt = native_oracle.wall_shear_monitor(
        pairs, pos, s["vel"], s["wall_vel"], vol_c, b_c, nf, cfg.DL, cfg.DH,
        cfg.mu, cfg.h)
    assert float(port_ops["shear"][0]) == pytest.approx(tb, rel=1e-10)
    assert float(port_ops["shear"][1]) == pytest.approx(tt, rel=1e-10)
