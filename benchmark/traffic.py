"""The one generator of the benchmark's inputs: a developed channel state
made on the device from ``--seed`` by the parameters of a traffic file's
``state`` group.

  lattice     the cell-centred fluid lattice and the two wall blocks of
              the channel (fluid first, walls last);
  jitter_dp   each fluid particle moved by a uniform offset in
              [-jitter_dp, jitter_dp) dp along x and along y;
  profile     "analytic": vx = g/(2 nu) y (DH - y) at the jittered y,
              vy = 0; rho = rho0; drho_dt = 0.

Every seed gives the same particle count, the same lattice and the same
flow; only the jitter differs. The same seed gives the same state on the
same device (a ``torch.Generator`` on that device).
"""

from __future__ import annotations

import torch

from .reference.sph import Channel


def seed_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed) % (2 ** 63))
    return gen


def developed_state(ch: Channel, params: dict, seed: int, device) -> dict:
    """The inputs, float64 on ``device``: ``x``, ``y``, ``vx``, ``vy``,
    ``rho``, ``drho_dt`` over all particles, ``mass`` and ``n_fluid``."""
    if params.get("profile", "analytic") != "analytic":
        raise ValueError(f"unknown profile {params.get('profile')!r}")
    x, y, mass, nf = ch.lattice(device)
    gen = seed_generator(seed, device)
    amp = float(params["jitter_dp"]) * ch.dp
    u = torch.rand((2, nf), generator=gen, device=x.device,
                   dtype=torch.float64)
    x = torch.cat([x[:nf] + (2.0 * u[0] - 1.0) * amp, x[nf:]])
    y = torch.cat([y[:nf] + (2.0 * u[1] - 1.0) * amp, y[nf:]])
    vx = torch.zeros_like(x)
    vx[:nf] = ch.analytic_u(y[:nf])
    return dict(x=x, y=y, vx=vx, vy=torch.zeros_like(x),
                rho=torch.full_like(x, ch.rho0), drho_dt=torch.zeros_like(x),
                mass=mass, n_fluid=nf)
