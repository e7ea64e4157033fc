"""Driver of a closed loop over output intervals from a developed state.

One simulation advances as fast as it can: ``engine.run_interval`` of the
engine that ``make_engine`` returns, one output interval after another,
as ``Simulation.run`` drives it (simulation.py:247-301), until the window
has lasted ``--seconds``. At each output point the host reads tau, v_max
and the flags, and copies the positions back for the work count; no
restart file is written.

Set-up: the port's config from the configuration file, its scene and
engine, the developed state of the traffic file made on the device from
the seed, ``engine.init``, and one warm interval of ``warm_interval``
simulated seconds from the initialised state (at least one rebuild and
one wall-shear call at the cell's shapes). The window starts again from
the initialised state, so the trajectory it times is the seed's.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from benchmark import trace, traffic
from benchmark.harness import Run
from benchmark.reference.sph import Channel


def port_config(conf: dict, wl: dict):
    """The port's ``SPHConfig`` for a configuration file and a traffic
    file (the knobs of ``bench_torch.py``'s derivation)."""
    from sph_poiseuille_flow_torch import derive_config
    phys, knobs = conf["physical"], conf["knobs"]
    dp = float(phys["dp"])
    return derive_config(
        **{k: float(phys[k]) for k in ("DL", "DH", "dp", "rho0", "mu",
                                       "U_bulk", "c_f")},
        end_time=float(conf["simulation"]["end_time"] or 1e9),
        output_interval=float(wl["output_interval"]),
        sort_interval=int(conf["simulation"]["sort_interval"]),
        restart_from_file=False, engine=knobs["engine"],
        dtype=knobs["dtype"], neighbor_skin=knobs["skin_dp"] * dp,
        rebuild_every=int(knobs["rebuild_every"]),
        cell_capacity=int(knobs["cell_capacity"]),
        lane_pack_nx=int(knobs["lane_pack_nx"]),
        neighbor_capacity=int(knobs["neighbor_capacity"]))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _read_point(res):
    """The output point's reads in one copy: (tau_bottom, tau_top, v_max,
    overflow) and the positions (x, y) on the host."""
    st = res.state
    head = torch.stack([res.tau_bottom.to(st.x.dtype),
                        res.tau_top.to(st.x.dtype),
                        res.v_max.to(st.x.dtype),
                        torch.as_tensor(res.overflow).to(st.x.device,
                                                         st.x.dtype)])
    out = torch.cat([head, st.x, st.y]).cpu()
    n = st.x.numel()
    return out[:4].tolist(), out[4:4 + n], out[4 + n:]


def run(conf: dict, wl: dict, seed: int, seconds: float, traced: bool,
        device, t0: float, engine_wrap=None) -> Run:
    from sph_poiseuille_flow_torch import (build_scene, initial_state,
                                           make_engine)
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc

    device = torch.device(device)
    cfg = port_config(conf, wl)
    ch = Channel.from_physics(conf["physical"])
    scene = build_scene(cfg)
    engine = make_engine(cfg, scene, device)
    if engine_wrap is not None:
        engine = engine_wrap(engine)

    inp = traffic.developed_state(ch, wl["state"], seed, device)
    nf = inp["n_fluid"]
    if (nf != scene.n_fluid or inp["x"].numel() != scene.n_total
            or not np.allclose(inp["x"][nf:].cpu().numpy(), scene.x[nf:],
                               rtol=0, atol=1e-12)
            or not np.allclose(inp["y"][nf:].cpu().numpy(), scene.y[nf:],
                               rtol=0, atol=1e-12)
            or not np.allclose(inp["mass"].cpu().numpy(), scene.mass,
                               rtol=1e-12, atol=0)):
        raise RuntimeError("the benchmark's channel and the port's scene "
                           "differ in particles, walls or masses")
    dt = getattr(torch, cfg.dtype)
    st0 = initial_state(cfg, scene, device)._replace(
        **{k: inp[k].to(dt) for k in ("x", "y", "vx", "vy", "rho",
                                       "drho_dt")})
    init = engine.init(st0)
    interval = np.dtype(cfg.dtype).type(wl["output_interval"])

    # warm interval from the initialised state: a rebuild, the shear, the
    # output-point reads, at this cell's shapes
    w = engine.run_interval(init[0], init[1], init[2],
                            np.dtype(cfg.dtype).type(wl["warm_interval"]))
    _read_point(w)
    del w
    _sync(device)

    rng = random.Random(f"{seed}:sampled-interval")
    sampled = rng.randint(1, int(wl["check"]["sampled_from"]))
    intervals, kept, points = [], None, [(st0.x.cpu(), st0.y.cpu())]
    st, lay, npairs = init[0], init[1], init[2]
    fcc.reset_launch_counts()
    with trace.capture(traced, device) as cap:
        _sync(device)
        t_start = time.perf_counter()
        setup_s = t_start - t0
        t_prev = t_start
        while True:
            prev = (st, lay, npairs)
            res = engine.run_interval(st, lay, npairs, interval)
            (tau_b, tau_t, vmax, ovf), x, y = _read_point(res)
            _sync(device)
            t_now = time.perf_counter()
            intervals.append(dict(
                wall=t_now - t_prev,
                steps=int(res.n_steps), syncs=int(res.n_syncs),
                rollbacks=int(res.n_rollbacks), tau_bottom=tau_b,
                tau_top=tau_t, v_max=vmax, overflow=bool(ovf),
                skin_guard=bool(res.skin_guard), t_local=float(res.t_local)))
            points.append((x, y))
            st, lay, npairs = res.state, res.cands, res.geom
            if len(intervals) == sampled:
                kept = (prev, res)
            t_prev = t_now
            if t_now - t_start >= seconds:
                break
        wall_s = t_now - t_start
    if kept is None:        # a window shorter than the draw: its last
        sampled, kept = len(intervals), (prev, res)
    launches = dict(fcc.LAUNCHES)
    del prev, res, st, lay, npairs
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    return Run(seed=seed, device=device, ch=ch, engine=engine,
               n_fluid=nf, n_total=scene.n_total, mass=inp["mass"], st0=st0,
               init=init, interval=interval, intervals=intervals,
               kept=kept, sampled=sampled, points=points, wall_s=wall_s,
               setup_s=setup_s, launches=launches,
               events=cap.events, memory_peak_bytes=int(peak))
