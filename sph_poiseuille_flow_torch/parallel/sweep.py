"""(g, mu) workload sweeps (torch port of the JAX package's
``parallel/sweep.py``; BASELINE.json config 5).

Two paths, as in the JAX package's ``run_sweep``:

* The fused engine (``PallasCellEngine``, what "auto" picks in float32)
  runs the lanes one after another on ONE engine (``_run_lane_seq``).
  (g, mu) reach its kernels at run time, in the ``[dt, g, mu, wf,
  active]`` row the wrappers hand every launch, so one build serves every
  lane and the device holds one lane's state at a time. The zero-dt init
  pass does not depend on (g, mu), so every lane starts from the one
  ``init`` result; no kernel or wrapper writes into its inputs (the
  chunk clones them), which the tests hold by bit-equality of each lane
  with a fresh single run.
* The per-step engines (``CellEngine``, ``Engine``) run a chunk of lanes
  in lockstep (``_run_lanes``, the engine's ``run_lanes``): one mapped
  step of every lane and one host sync a step, for the chunk, where the
  JAX package vmaps the whole interval loop. ``lane_chunk`` bounds the
  lanes resident at once; chunks run one after another.

With ``paths`` every lane gets the single run's driver surface: a
signature-guarded restart at every output point (``_lane{k}``; resumed
under ``restart_from_file``), the monitor series, and a postprocess
handoff npz (+ both figures where matplotlib is installed).

The fused path is traced as a single run is: each lane is a
``sph_sweep_lane`` range and each of its output intervals a
``utils/profile.interval_range``, so ``--profile`` summarises a sweep
interval by interval; ``SWEEP_COUNTS`` counts its lanes, output points,
steps and the host seconds the lane loop spends outside the engine.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import interop
from ..config import SPHConfig
from ..models.poiseuille import Scene, build_scene
from ..stepper import State, initial_state, make_engine, resolve_engine_name
from ..utils import checkpoint
from ..utils import postprocess as pp
from ..utils.profile import interval_range

_RESTART_FIELDS = ("x", "y", "vx", "vy", "rho", "p", "drho_dt", "fx", "fy",
                   "fpx", "fpy")

# the range that marks one lane of the fused sweep in a capture
LANE = "sph_sweep_lane"

# the fused sweep's lane loop (``_run_lane_seq``): lanes opened, output
# points, steps, and host seconds on ``time.perf_counter`` (no sync of its
# own) spent outside ``engine.run_interval`` and its closing sync: from
# entering a lane to its first interval (``open_s``: the lane config, the
# monitor and its first sample, the resume check) and at the output points
# (``point_s``: the next interval's opening sync, the flag and v_max reads,
# the monitor sample, a restart write), an ``on_interval`` hook's time
# left out
SWEEP_COUNTS = {"lanes": 0, "points": 0, "lane_steps": 0, "open_s": 0.0,
                "point_s": 0.0}


def reset_sweep_counts() -> None:
    for k in SWEEP_COUNTS:
        SWEEP_COUNTS[k] = type(SWEEP_COUNTS[k])(0)


def make_workloads(cfg: SPHConfig, mus: Sequence[float]):
    """The (g, mu) pairs that keep U_bulk fixed across viscosities:
    g = 12*mu*U_bulk/(rho0*DH^2) (reference: SPH_Poiseuille.m:71)."""
    mus = np.asarray(mus, np.float64)
    gs = 12.0 * mus * cfg.U_bulk / (cfg.rho0 * cfg.DH ** 2)
    return gs, mus


def _lane_path(path: str, k: int) -> str:
    root, ext = os.path.splitext(path)
    return f"{root}_lane{k}{ext}"


def _lane_cfg(cfg: SPHConfig, g_k: float, mu_k: float) -> SPHConfig:
    """The lane's config: its (g, mu) with a consistent nu. Its
    ``signature`` then differs per lane (mu rides the signature), so a
    lane restart is never resumed into another workload."""
    return dataclasses.replace(cfg, mu=float(mu_k), gravity_g=float(g_k),
                               nu=float(mu_k) / cfg.rho0)


class _LaneMonitor:
    """A lane's twin of the driver's monitor sampling
    (``simulation.Simulation._sample_mid_profile``)."""

    def __init__(self, cfg: SPHConfig, n_fluid: int):
        self.cfg, self.nf = cfg, n_fluid
        self.times, self.mid_u, self.full_u = [], [], []

    def sample(self, t: float, state: State):
        cfg, nf = self.cfg, self.nf
        x, y, u = (pp._host(a[:nf]) for a in (state.x, state.y, state.vx))
        _, u_mid = pp.mid_channel_profile(x, y, u, cfg.DL, cfg.DH,
                                          cfg.mid_x, cfg.mid_half_width,
                                          cfg.n_bins)
        _, u_full = pp.binned_profile_mean(y, u, 0.0, cfg.DH, cfg.n_bins)
        self.times.append(t)
        self.mid_u.append(u_mid)
        self.full_u.append(u_full)


def _lane_artifacts(cfg_k: SPHConfig, scene: Scene, state: State,
                    mon: _LaneMonitor, paths, k: int, log) -> dict:
    """Write lane k's postprocess handoff npz and both figures (the single
    run's handoff, simulation.py)."""
    npz = _lane_path(paths.postprocess_npz, k)
    data = pp.make_postprocess_data(
        cfg_k, scene, state, np.asarray(mon.times),
        np.stack(mon.mid_u, axis=1), _lane_path(paths.result_png, k),
        _lane_path(paths.profile_evolution_png, k),
        full_profile_u=np.stack(mon.full_u, axis=1))
    pp.save_postprocess_npz(npz, data)
    out = pp.run_postprocess(data, quiet=True)
    log(f"  lane {k} artifacts: {npz}")
    out["postprocess_npz"] = npz
    return out


def _lane_slice(states: State, k: int) -> State:
    return State(*(a[k] for a in states))


def _stack(items):
    """NamedTuples of tensors -> one NamedTuple with a leading lane axis
    (a copy: the lanes never share a tensor)."""
    return type(items[0])(*(torch.stack(f) for f in zip(*items)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _resume_state(cfg_k, scene, engine, state0, path, log, what):
    """Lane restart -> (state, layout, geometry, t, step), or None. The
    restart stores particle state, not layout: ``init`` re-bins it."""
    payload, reason = checkpoint.load_restart(path, cfg_k.signature,
                                              scene.n_total)
    if payload is None:
        log(f"  {what}: restart unavailable ({reason})")
        return None
    st = interop.state_from_numpy(
        {f: payload[f] for f in _RESTART_FIELDS}, dtype=state0.x.dtype,
        device=state0.x.device, base=state0)
    s, lay, geom, ovf = engine.init(st)
    if bool(ovf):
        raise RuntimeError("cell capacity exceeded on lane resume")
    return s, lay, geom, float(payload["t"]), int(payload["step"])


def _run_lanes(cfg: SPHConfig, engine, scene: Scene, state0, lay0, geom0,
               gs, mus, log, paths=None, lane_base=0, monitors=None):
    """Advance ``len(gs)`` lanes in lockstep to cfg.end_time through
    ``engine.run_lanes``. Returns (final states, lane-steps, wall seconds).

    With ``paths``: per-lane signature-guarded restarts at every output
    point and per-lane monitor series appended to ``monitors``. The lanes
    advance in lockstep, so they resume only when every lane of the chunk
    holds a restart at the SAME t; otherwise the chunk starts clean."""
    n = len(gs)
    states, lays, geoms = (_stack([a] * n) for a in (state0, lay0, geom0))
    cfg_ks = [_lane_cfg(cfg, gs[k], mus[k]) for k in range(n)]
    lane_paths = ([_lane_path(paths.restart, lane_base + k)
                   for k in range(n)] if paths else None)
    span = f"sweep lanes {lane_base}..{lane_base + n - 1}"
    t = 0.0
    steps_abs = np.zeros(n, np.int64)
    if lane_paths and cfg.restart_from_file:
        loaded = [_resume_state(cfg_ks[k], scene, engine, state0,
                                lane_paths[k], log, f"lane {lane_base + k}")
                  for k in range(n)]
        ts = {None if p is None else round(p[3], 12) for p in loaded}
        if None not in ts and len(ts) == 1:
            states, lays, geoms = (_stack([p[i] for p in loaded])
                                   for i in range(3))
            t = loaded[0][3]
            steps_abs = np.asarray([p[4] for p in loaded], np.int64)
            log(f"{span}: resuming lockstep from t={t:.6f}")
        else:
            log(f"{span}: restarts absent or not at one t; starting clean")

    if monitors is not None:
        for k in range(n):
            mon = _LaneMonitor(cfg_ks[k], scene.n_fluid)
            mon.sample(t, _lane_slice(states, k))
            monitors.append(mon)

    total = 0
    wall = 0.0
    eps = 1e-9
    while t < cfg.end_time - eps:
        target = min(t + cfg.output_interval, cfg.end_time)
        _sync(engine.device)
        t0 = time.perf_counter()
        res = engine.run_lanes(states, lays, geoms, target - t, gs, mus)
        _sync(engine.device)
        wall += time.perf_counter() - t0
        if bool(res.overflow.any()):
            raise RuntimeError("neighbor cell capacity exceeded in sweep")
        if bool(res.skin_guard.any()):
            raise RuntimeError("neighbor skin guard tripped in sweep; "
                               "reduce rebuild_every")
        v_max = res.v_max.tolist()
        if not all(np.isfinite(v_max)):
            raise RuntimeError(f"{span}: non-finite velocities in the "
                               f"interval ending t={target:.6f}")
        states, lays, geoms = res.state, res.cands, res.geom
        total += int(res.n_steps.sum())
        steps_abs += res.n_steps
        t = target
        if lane_paths:
            for k in range(n):
                checkpoint.save_restart(lane_paths[k], cfg_ks[k].signature,
                                        _lane_slice(states, k), t,
                                        int(steps_abs[k]))
        if monitors is not None:
            for k in range(n):
                monitors[lane_base + k].sample(t, _lane_slice(states, k))
        log(f"sweep output point t={t:.3f}: steps/lane="
            f"{res.n_steps.tolist()}, "
            f"vmax={[round(v, 4) for v in v_max]}")
    return states, total, wall


def _run_lane_seq(cfg: SPHConfig, engine, scene: Scene, state0, lay0, geom0,
                  g_k: float, mu_k: float, log, paths=None, lane_k: int = 0,
                  on_interval=None):
    """Advance ONE workload to cfg.end_time on the shared fused engine,
    with the lane's (g, mu) as run-time kernel arguments. Returns (final
    state, steps run here, wall seconds, monitor).

    With ``paths`` the lane gets the single run's driver surface: a
    signature-guarded restart every output point (resumed under
    ``cfg.restart_from_file``, so a failed sweep re-runs only unfinished
    work) and the monitor series for its postprocess handoff.
    ``on_interval(lane_k, prev, res)`` is called as each output interval's
    ``engine.run_interval`` returns (synchronised), before the lane's flag
    checks: ``prev`` is the (state, layout, geometry) the interval started
    from, ``res`` its ``IntervalResult``."""
    t_mark = time.perf_counter()
    with torch.profiler.record_function(LANE):
        f = np.dtype(cfg.dtype).type
        cfg_k = _lane_cfg(cfg, g_k, mu_k)
        state, lay, geom = state0, lay0, geom0
        t = 0.0
        steps = 0
        restart_path = _lane_path(paths.restart, lane_k) if paths else None
        if restart_path and cfg.restart_from_file:
            got = _resume_state(cfg_k, scene, engine, state0, restart_path,
                                log, f"lane {lane_k}")
            if got is not None:
                state, lay, geom, t, steps = got
                log(f"  lane {lane_k}: resuming from t={t:.6f}")
        mon = _LaneMonitor(cfg_k, scene.n_fluid)
        mon.sample(t, state)
        SWEEP_COUNTS["lanes"] += 1
        host = "open_s"
        wall = 0.0
        steps_run = 0   # steps executed in this call (throughput denominator)
        v_max = float("nan")
        eps = 1e-9
        while t < cfg.end_time - eps:
            target = min(t + cfg.output_interval, cfg.end_time)
            _sync(engine.device)
            t0 = time.perf_counter()
            SWEEP_COUNTS[host] += t0 - t_mark
            host = "point_s"
            with interval_range():
                res = engine.run_interval(state, lay, geom, f(target - t),
                                          g=float(g_k), mu=float(mu_k))
                _sync(engine.device)
            t_mark = time.perf_counter()
            wall += t_mark - t0
            if on_interval is not None:
                on_interval(lane_k, (state, lay, geom), res)
                t_mark = time.perf_counter()
            if bool(res.overflow):
                raise RuntimeError("neighbor cell capacity exceeded in sweep")
            v_max = float(res.v_max)
            if not np.isfinite(v_max):
                raise RuntimeError(f"lane {lane_k}: non-finite velocities in "
                                   f"the interval ending t={target:.6f}")
            state, lay, geom = res.state, res.cands, res.geom
            steps += res.n_steps
            steps_run += res.n_steps
            SWEEP_COUNTS["points"] += 1
            SWEEP_COUNTS["lane_steps"] += int(res.n_steps)
            t = target
            if restart_path:
                checkpoint.save_restart(restart_path, cfg_k.signature, state,
                                        t, steps)
            mon.sample(t, state)
            kept = (f", {res.n_kept_crossings} one-step drift crossing(s) "
                    f"kept" if res.n_kept_crossings else "")
            log(f"  lane {lane_k} output point t={t:.3f}: "
                f"steps={res.n_steps}, vmax={v_max:.4f}{kept}")
        SWEEP_COUNTS[host] += time.perf_counter() - t_mark
    log(f"  lane done: mu={mu_k:g} steps={steps} vmax={v_max:.4f} "
        f"wall={wall:.1f}s")
    return state, steps_run, wall, mon


def run_sweep(cfg: SPHConfig, gs, mus, log=print,
              lane_chunk: Optional[int] = None, paths=None,
              device="cuda") -> dict:
    """Run ``len(gs)`` workloads to cfg.end_time on ``device``.

    The fused engine runs the lanes one after another on one engine and
    one build (``lane_chunk`` is logged and ignored there); the per-step
    engines run chunks of ``lane_chunk`` lanes in lockstep (None = every
    lane at once). ``paths`` (a ``simulation.SimulationPaths``) gives each
    lane the single run's restarts, monitors and postprocess handoff.

    Returns each workload's L2 error against its own analytic profile
    (``l2_errors``), the final states as host arrays with a leading lane
    axis (``final_states``), ``total_lane_steps``, ``wall_time`` (each
    interval on the host clock, synchronized at both ends on a card),
    ``lane_artifacts`` (the handoff paths with ``paths``) and
    ``particle_steps_per_sec`` summed over the lanes. All workloads share
    the scene."""
    gs = np.asarray(gs, np.float64)
    mus = np.asarray(mus, np.float64)
    if gs.shape != mus.shape or gs.ndim != 1:
        raise ValueError(f"gs {gs.shape} and mus {mus.shape} must be two "
                         "1-D arrays of one length")
    n_work = gs.size
    chunk = n_work if lane_chunk is None else max(1, int(lane_chunk))
    device = torch.device(device)
    scene = build_scene(cfg)
    engine = make_engine(cfg, scene, device)
    state0, lay0, geom0, overflow = engine.init(
        initial_state(cfg, scene, device))
    if bool(overflow):
        raise RuntimeError("neighbor cell capacity exceeded at init")
    finals = []
    monitors = [] if paths is not None else None
    total = 0
    wall = 0.0
    if resolve_engine_name(cfg) == "pallas":
        if lane_chunk is not None:
            log("note: --sweep-lane-chunk is inapplicable on the fused "
                "sweep path (lanes already run one at a time); ignoring")
        for k in range(n_work):
            log(f"sweep lane {k}/{n_work} (sequential, one build, (g, mu) "
                f"as kernel arguments, engine=pallas)")
            st, steps, w, mon = _run_lane_seq(
                cfg, engine, scene, state0, lay0, geom0, gs[k], mus[k], log,
                paths=paths, lane_k=k)
            finals.append(State(*(a[None] for a in st)))
            if monitors is not None:
                monitors.append(mon)
            total += steps
            wall += w
    else:
        for c0 in range(0, n_work, chunk):
            c1 = min(c0 + chunk, n_work)
            if n_work > chunk:
                log(f"sweep lanes {c0}..{c1 - 1} (chunked: {chunk} of "
                    f"{n_work} lanes resident)")
            st, steps, w = _run_lanes(cfg, engine, scene, state0, lay0,
                                      geom0, gs[c0:c1], mus[c0:c1], log,
                                      paths=paths, lane_base=c0,
                                      monitors=monitors)
            finals.append(st)
            total += steps
            wall += w
    states = State(*(np.concatenate([a.detach().cpu().numpy()
                                     for a in field])
                     for field in zip(*finals)))

    # each workload's L2 against its own analytic profile
    l2s = []
    nf = scene.n_fluid
    for k in range(n_work):
        yk = np.asarray(states.y[k][:nf], np.float64)
        uk = np.asarray(states.vx[k][:nf], np.float64)
        y_mid, u_mean = pp.binned_profile_mean(yk, uk, 0.0, cfg.DH,
                                               cfg.n_bins)
        u_exact = gs[k] / (2.0 * mus[k] / cfg.rho0) * y_mid * (cfg.DH
                                                                - y_mid)
        l2s.append(pp.compute_l2_error(u_mean, u_exact))

    lane_artifacts = None
    if paths is not None:
        lane_artifacts = [
            _lane_artifacts(_lane_cfg(cfg, gs[k], mus[k]), scene,
                            _lane_slice(states, k), monitors[k], paths, k,
                            log)["postprocess_npz"]
            for k in range(n_work)]

    return {
        "l2_errors": np.asarray(l2s),
        "final_states": states,
        "total_lane_steps": total,
        "wall_time": wall,
        "lane_artifacts": lane_artifacts,
        "particle_steps_per_sec": total * scene.n_fluid / wall
        if wall > 0 else float("nan"),
    }
