"""The plain reference against ``tests/oracle_numpy.py`` on a tiny jittered
box, and its pair search against a brute-force one."""

import math
import os
import sys

import numpy as np
import pytest
import torch

from benchmark import traffic
from benchmark.reference import sph

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "..", "tests"))
import oracle_numpy as oc  # noqa: E402

CH = sph.Channel(DL=0.3, DH=0.2, dp=0.025, rho0=1.0, mu=0.1,
                 U_bulk=0.666667, c_f=15.0)


def _state(seed):
    inp = traffic.developed_state(CH, {"jitter_dp": 0.15}, seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    nf = inp["n_fluid"]
    n = inp["x"].numel()
    noise = torch.randn((3, nf), generator=gen, dtype=torch.float64)
    vx = inp["vx"].clone()
    vx[:nf] += 0.01 * noise[0]
    vy = torch.zeros(n, dtype=torch.float64)
    vy[:nf] = 0.01 * noise[1]
    drho = torch.zeros(n, dtype=torch.float64)
    drho[:nf] = 0.1 * noise[2]
    z = torch.zeros(n, dtype=torch.float64)
    st = sph.Fields(x=inp["x"], y=inp["y"], vx=vx, vy=vy, rho=z + 1.0, p=z,
                    drho_dt=drho, fx=z, fy=z, fpx=z, fpy=z, vol=z, b11=z,
                    b12=z, b21=z, b22=z)
    return st, inp["mass"], nf


def _oracle(st, mass, nf, n_steps):
    """``n_steps`` steps of the oracle's operators in the upstream order
    (tests/run_oracle_sim.py's loop), then the wall shear."""
    x, y = st.x.numpy().copy(), st.y.numpy().copy()
    n = x.size
    vel = np.stack([st.vx.numpy(), st.vy.numpy()], 1)
    drho = st.drho_dt.numpy().copy()
    m = mass.numpy()
    wall_vel = np.zeros((n, 2))
    for _ in range(n_steps):
        pairs = oc.build_pairs(x, y, nf, CH.DL, CH.h)
        rho, vol, B = oc.density_correction(pairs, m, nf, n, CH.rho0, CH.h,
                                            CH.inv_sigma0)
        fprior = oc.viscous_force(pairs, vel, vol, B, CH.mu, CH.h, nf, n,
                                  wall_vel)
        fprior[:nf, 0] += m[:nf] * CH.g
        fprior[nf:] = 0.0
        pos = oc.transport_correction(pairs, vol, B, np.stack([x, y], 1),
                                      CH.h, nf, n, sph.TRANSPORT_COEFF)
        vmax = np.sqrt((vel[:nf] ** 2).sum(1)).max()
        dt = min(0.25 * CH.h / (CH.c_f + vmax), 0.125 * CH.h ** 2 / CH.nu,
                 0.25 * math.sqrt(CH.h / abs(CH.g)))
        rho, p, pos, vel, drho, force = oc.integration_verlet(
            pairs, vol, B, rho, m, pos, vel, drho, fprior, dt, nf, n,
            CH.rho0, CH.p0, CH.c_f, wall_vel)
        x, y = pos[:, 0].copy(), pos[:, 1].copy()
        x[:nf] = np.mod(x[:nf], CH.DL)
        vel[nf:] = 0.0
    pairs = oc.build_pairs(x, y, nf, CH.DL, CH.h)
    tau = oc.wall_shear_monitor(pairs, np.stack([x, y], 1), vel, wall_vel,
                                vol, B, nf, CH.DL, CH.DH, CH.mu, CH.h)
    return dict(x=x, y=y, vx=vel[:, 0], vy=vel[:, 1], rho=rho, p=p,
                drho_dt=drho, fx=force[:, 0], fy=force[:, 1],
                fpx=fprior[:, 0], fpy=fprior[:, 1], vol=vol, b11=B[:, 0],
                b12=B[:, 1], b21=B[:, 2], b22=B[:, 3]), tau


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_reference_agrees_with_the_oracle(seed):
    st, mass, nf = _state(seed)
    out = sph.Reference(CH, mass, nf).run(st, n_steps=3)
    want, tau = _oracle(st, mass, nf, 3)
    assert out.n_steps == 3
    for k, v in want.items():
        got = getattr(out.state, k).numpy()
        scale = max(1.0, float(np.abs(v).max()))
        assert np.abs(got - v).max() <= 1e-12 * scale, k
    assert abs(out.tau_bottom - tau[0]) <= 1e-12
    assert abs(out.tau_top - tau[1]) <= 1e-12


def test_interval_lands_on_the_output_point():
    st, mass, nf = _state(5)
    out = sph.Reference(CH, mass, nf).run(st, interval=2e-3)
    assert out.t == pytest.approx(2e-3, abs=1e-15)
    dt_max = min(0.25 * CH.h / CH.c_f, 0.125 * CH.h ** 2 / CH.nu)
    assert out.n_steps >= math.ceil(2e-3 / dt_max)


def test_pair_search_matches_brute_force():
    st, mass, nf = _state(7)
    i, j = sph.candidate_pairs(st.x, st.y, nf, CH.DL, 2.0 * CH.h)
    got = set(zip(i.tolist(), j.tolist()))
    x, y = st.x.numpy(), st.y.numpy()
    want = set()
    for a in range(nf):
        for b in range(x.size):
            if b == a or (b < nf and b < a):
                continue
            dx = x[a] - x[b]
            dx -= CH.DL * np.round(dx / CH.DL)
            if dx * dx + (y[a] - y[b]) ** 2 < (2.0 * CH.h) ** 2:
                want.add((a, b))
    assert got == want


def test_lower_precision_runs():
    st, mass, nf = _state(9)
    low = sph.Reference(CH, mass, nf, dtype=torch.bfloat16,
                        pos_dtype=torch.float32).run(st, n_steps=2)
    assert low.state.vx.dtype == torch.bfloat16
    assert low.state.x.dtype == torch.float32
    assert math.isfinite(low.tau_bottom)
