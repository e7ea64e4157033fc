"""Driver of the (g, mu) sweep: lanes of one configuration, one after
another, through the port's own lane loop.

Each lane is ``parallel/sweep._run_lane_seq``, the function ``run_sweep``
calls for every lane on the fused engine: the lane's config from
``_lane_cfg``, its (g, mu) from ``make_workloads`` over the configuration's
``lanes`` mus, passed to the kernels at run time. A lane runs
``lane_intervals`` output intervals of ``output_interval`` from the
developed input's ``engine.init``; U_bulk is the same in every lane, so
one developed state made from the seed serves all of them. After the last
lane the sweep starts again from the developed input. The window ends at
the first lane end past ``--seconds``, so it holds whole lanes. At each
output point the driver's hook (``on_interval``) reads tau, v_max and the
flags and copies the positions back for the work count, as the developed
driver does. The lane loop's own counts (``SWEEP_COUNTS``: lanes, points,
steps, its host seconds at a lane's opening and at the output points)
are reset at the window's start and printed to standard error at its end.

Set-up: as the developed driver's, and one warm interval of
``warm_interval`` simulated seconds of the first lane through
``_run_lane_seq`` (the chunk buffers, a rebuild and the shear at the
cell's shapes).

The check sees the sampled interval's lane: ``ch`` is the reference
channel at that lane's mu (whose g is ``make_workloads``' to rounding)
and ``engine`` binds that lane's (g, mu) to every ``run_interval``.
``intervals`` lists every lane interval in window order, so the rate is
fluid particles x lane steps over the window's wall: the lane-particle-
steps/s summed over lanes that ``run_sweep`` prints.

The work count's points: one before each interval. A lane's first
interval starts from the developed input, not from the previous lane's
end, so the point before it is the developed input's; the previous lane's
last interval is then counted to the developed input's pairs in place of
its own end's.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import random
import sys
import time

import torch

from benchmark import trace, traffic
from benchmark.drivers import developed
from benchmark.harness import Run
from benchmark.reference.sph import Channel


class _Lane:
    """The engine with one lane's (g, mu) bound to every ``run_interval``,
    as ``_run_lane_seq`` passes them."""

    def __init__(self, engine, g: float, mu: float):
        self._engine, self._g, self._mu = engine, g, mu

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def run_interval(self, state, lay, geom, interval, **kw):
        return self._engine.run_interval(state, lay, geom, interval,
                                         g=self._g, mu=self._mu, **kw)


def _quiet(_):
    pass


def run(conf: dict, wl: dict, seed: int, seconds: float, traced: bool,
        device, t0: float, engine_wrap=None):
    import numpy as np
    from sph_poiseuille_flow_torch import (build_scene, initial_state,
                                           make_engine)
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc
    from sph_poiseuille_flow_torch.parallel import sweep

    device = torch.device(device)
    lane_end = int(wl["lane_intervals"]) * float(wl["output_interval"])
    if abs(lane_end - float(conf["simulation"]["end_time"])) > 1e-12:
        raise ValueError(f"lane_intervals x output_interval = {lane_end} s "
                         f"is not the configuration's end_time")
    cfg = dataclasses.replace(developed.port_config(conf, wl),
                              end_time=lane_end)
    gs, mus = sweep.make_workloads(cfg, conf["lanes"]["mu"])
    lanes = [(float(g), float(mu)) for g, mu in zip(gs, mus)]
    scene = build_scene(cfg)
    engine = make_engine(cfg, scene, device)
    if engine_wrap is not None:
        engine = engine_wrap(engine)

    ch0 = Channel.from_physics(conf["physical"])
    inp = traffic.developed_state(ch0, wl["state"], seed, device)
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

    # warm interval of the first lane through the lane loop: the chunk
    # buffers, a rebuild, the shear and the output-point reads
    warm = float(wl["warm_interval"])
    sweep._run_lane_seq(
        dataclasses.replace(cfg, end_time=warm, output_interval=warm),
        engine, scene, init[0], init[1], init[2], *lanes[0], _quiet,
        on_interval=lambda k, prev, res: developed._read_point(res))
    developed._sync(device)

    rng = random.Random(f"{seed}:sampled-interval")
    sampled = rng.randint(1, int(wl["check"]["sampled_from"]))
    start_xy = (st0.x.cpu(), st0.y.cpu())
    intervals, points = [], [start_xy]
    seen = {"kept": None, "last": None, "t_prev": 0.0}

    def on_interval(k, prev, res):
        (tau_b, tau_t, vmax, ovf), x, y = developed._read_point(res)
        t_now = time.perf_counter()
        intervals.append(dict(
            wall=t_now - seen["t_prev"], lane=k,
            steps=int(res.n_steps), syncs=int(res.n_syncs),
            rollbacks=int(res.n_rollbacks), tau_bottom=tau_b,
            tau_top=tau_t, v_max=vmax, overflow=bool(ovf),
            skin_guard=bool(res.skin_guard), t_local=float(res.t_local)))
        points.append((x, y))
        seen["last"] = (k, prev, res)
        if len(intervals) == sampled:
            seen["kept"] = seen["last"]
        seen["t_prev"] = t_now

    fcc.reset_launch_counts()
    sweep.reset_sweep_counts()
    with trace.capture(traced, device) as cap:
        developed._sync(device)
        t_start = time.perf_counter()
        setup_s = t_start - t0
        seen["t_prev"] = t_start
        for k, (g, mu) in itertools.cycle(enumerate(lanes)):
            points[-1] = start_xy
            sweep._run_lane_seq(cfg, engine, scene, init[0], init[1],
                                init[2], g, mu, _quiet, lane_k=k,
                                on_interval=on_interval)
            t_end = time.perf_counter()
            if t_end - t_start >= seconds:
                break
        wall_s = t_end - t_start
    print(f"sweep counts: {json.dumps(sweep.SWEEP_COUNTS)}", file=sys.stderr,
          flush=True)
    if seen["kept"] is None:    # a window shorter than the draw: its last
        sampled, seen["kept"] = len(intervals), seen["last"]
    k, prev, res = seen["kept"]
    g, mu = lanes[k]
    launches = dict(fcc.LAUNCHES)
    seen.clear()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    return Run(
        seed=seed, device=device,
        ch=Channel.from_physics(dict(conf["physical"], mu=mu)),
        engine=_Lane(engine, g, mu), n_fluid=nf, n_total=scene.n_total,
        mass=inp["mass"], st0=st0, init=init, interval=interval,
        intervals=intervals, kept=(prev, res), sampled=sampled,
        points=points, wall_s=wall_s, setup_s=setup_s, launches=launches,
        events=cap.events, memory_peak_bytes=int(peak))
