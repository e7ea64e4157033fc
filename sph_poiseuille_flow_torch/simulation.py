"""Host-side simulation driver (torch port of the JAX package's
``simulation.py``): config -> scene -> engine, the outer output-interval
loop (SPH_Poiseuille.m:246-302), monitors, signature-guarded restarts at
every output point and the postprocess handoff.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from . import interop
from .config import SPHConfig, env_override, load_config
from .models.poiseuille import Scene, build_scene
from .stepper import State, initial_state, make_engine
from .utils import checkpoint
from .utils import postprocess as pp
from .utils.profile import interval_range


@dataclasses.dataclass
class SimulationPaths:
    """Output/restart paths with the reference's env-var overrides
    (SPH_Poiseuille.m:19-26)."""

    restart: str = "restart.npz"
    result_png: str = os.path.join("results", "SPH_Poiseuille_result.png")
    profile_evolution_png: str = os.path.join(
        "results", "SPH_centerline_profile_evolution.png")
    postprocess_npz: str = os.path.join(
        "results", "SPH_Poiseuille_postprocess.npz")

    @classmethod
    def from_env(cls, base_dir: str = ".") -> "SimulationPaths":
        return cls(
            restart=env_override(
                "SPH_RESTART_PATH_OVERRIDE",
                os.path.join(base_dir, "restart.npz")),
            result_png=env_override(
                "SPH_RESULT_PNG_OVERRIDE",
                os.path.join(base_dir, "results",
                             "SPH_Poiseuille_result.png")),
            profile_evolution_png=env_override(
                "SPH_PROFILE_PNG_OVERRIDE",
                os.path.join(base_dir, "results",
                             "SPH_centerline_profile_evolution.png")),
            postprocess_npz=env_override(
                "SPH_POSTPROCESS_MAT_OVERRIDE",
                os.path.join(base_dir, "results",
                             "SPH_Poiseuille_postprocess.npz")),
        )


def _host(a) -> np.ndarray:
    return a.detach().cpu().double().numpy()


class Simulation:
    """End-to-end run: init/restart -> interval loop -> postprocess, on
    one explicit device, or with ``mesh_devices`` = N on an N-slab mesh
    of that device type (``parallel.ShardedPallasEngine`` and its
    siblings; N = 1 still runs the sharded engine)."""

    def __init__(self, cfg: SPHConfig, paths: Optional[SimulationPaths] = None,
                 log: Callable[[str], None] = print, device="cuda",
                 mesh_devices: Optional[int] = None):
        self.cfg = cfg
        self.paths = paths or SimulationPaths()
        self.log = log
        self.device = torch.device(device)
        self.scene: Scene = build_scene(cfg)
        if mesh_devices is not None and mesh_devices >= 1:
            self.engine = self._make_sharded_engine(mesh_devices)
            self.device = self.engine.device
        else:
            self.engine = make_engine(cfg, self.scene, self.device)
        self.t = 0.0
        self.step = 0
        self.profile_times: List[float] = []
        self.mid_profile_u: List[np.ndarray] = []
        self.full_profile_u: List[np.ndarray] = []
        self.tau_history: List[tuple] = []  # (t, tau_bottom, tau_top)
        self.v_max_history: List[float] = []
        self.wall_time_in_loop = 0.0
        self.total_steps_run = 0
        self.host_syncs = 0

    def _make_sharded_engine(self, n_devices: int):
        """The sharded engine of ``--mesh N`` (JAX simulation.py:87-105):
        the resolved engine name picks the decomposition (pallas and
        cellgrid: y-slabs; gather: neighbor-row blocks)."""
        from .parallel import (ShardedCellEngine, ShardedEngine,
                               ShardedPallasEngine, make_mesh)
        from .stepper import resolve_engine_name
        name = resolve_engine_name(self.cfg)
        mesh = make_mesh(n_devices, device=self.device.type)
        cls = {"pallas": ShardedPallasEngine,
               "cellgrid": ShardedCellEngine,
               "gather": ShardedEngine}[name]
        where = (f"virtual: {n_devices} slabs on {mesh.devices[0]}"
                 if mesh.virtual and n_devices > 1 else
                 ", ".join(str(d) for d in mesh.devices))
        self.log(f"mesh: {n_devices} devices ({where}), engine={name} "
                 f"(y-slab sharded)" if name != "gather" else
                 f"mesh: {n_devices} devices ({where}), engine=gather "
                 f"(row-sharded)")
        cfg = (self.cfg if name == self.cfg.engine
               else dataclasses.replace(self.cfg, engine=name))
        return cls(cfg, self.scene, mesh)

    # ---- monitors ----
    def _sample_mid_profile(self, state: State):
        cfg = self.cfg
        nf = self.scene.n_fluid
        x, y, vx = (_host(a[:nf]) for a in (state.x, state.y, state.vx))
        _, u_mean = pp.mid_channel_profile(
            x, y, vx, cfg.DL, cfg.DH, cfg.mid_x, cfg.mid_half_width,
            cfg.n_bins)
        self.profile_times.append(self.t)
        self.mid_profile_u.append(u_mean)
        # full-channel binned profile per output point: feeds the
        # time-averaged L2 (docs/VALIDATION.md)
        _, u_full = pp.binned_profile_mean(y, vx, 0.0, cfg.DH, cfg.n_bins)
        self.full_profile_u.append(u_full)

    def _drain_step_log(self, res) -> None:
        """Print the interval's step-log rows in the reference's per-step
        format (SPH_Poiseuille.m:285-291; JAX ``Simulation._drain_step_log``,
        simulation.py:126-145)."""
        from .stepper import STEP_LOG_CAP
        cfg = self.cfg
        n = int(res.step_log_n)
        for r in np.asarray(res.step_log[:min(n, STEP_LOG_CAP)]):
            self.log(f"step={int(r[0])}, t={r[1]:.6f}/{cfg.end_time:.6f}, "
                     f"dt={r[2]:.4e}, pairs={int(r[3])}, vmax={r[4]:.4f}")
            self.log(f"  [thick-wall-noslip] tau_bot={r[5]:.4f}, "
                     f"tau_top={r[6]:.4f}, tau_target={cfg.tau_target:.4f}")
        if n > STEP_LOG_CAP:
            self.log(f"  (step log truncated: {n - STEP_LOG_CAP} rows "
                     f"beyond the {STEP_LOG_CAP}-row buffer dropped)")

    # ---- restart ----
    def _try_restart(self, state: State) -> State:
        cfg = self.cfg
        if not cfg.restart_from_file:
            return state
        payload, reason = checkpoint.load_restart(
            self.paths.restart, cfg.signature, self.scene.n_total)
        if payload is None:
            self.log(f"Restart unavailable ({reason}); starting clean.")
            return state
        state = interop.state_from_numpy(
            {k: payload[k] for k in ("x", "y", "vx", "vy", "rho", "p",
                                     "drho_dt", "fx", "fy", "fpx", "fpy")},
            dtype=state.x.dtype, device=self.device, base=state)
        self.t = payload["t"]
        self.step = payload["step"]
        self.log(f"Restart: resuming from t={self.t:.6f}, step={self.step}.")
        return state

    def _dispatch_interval(self, state, cands, geom, interval, fdtype):
        """Run one output interval: one engine call by default, or -- when
        ``cfg.max_steps_per_dispatch > 0`` -- a sequence of step-bounded
        calls that reproduces the single call's trajectory bit for bit
        (the engine carries the interval-local Kahan clock and the
        rollback chunk length across calls). With the step log on, only
        the last call's rows are drained, as in the JAX package."""
        msd = int(getattr(self.cfg, "max_steps_per_dispatch", 0) or 0)
        if msd > 0 and getattr(self.engine, "mesh", None) is not None:
            raise RuntimeError(
                "max_steps_per_dispatch is a single-device scale lever "
                "(the sharded engines already bound per-dispatch work "
                "by the slab decomposition); run without --mesh")
        if msd <= 0:
            res = self.engine.run_interval(
                state, cands, geom, fdtype.type(interval),
                t_base=fdtype.type(self.t), step_base=self.step)
            self.host_syncs += res.n_syncs
            return res, int(res.n_steps)
        il = fdtype.type(interval)
        t_loc = fdtype.type(0.0)
        t_cmp = fdtype.type(0.0)
        total = 0
        n_roll = 0
        n_sync = 0
        sub_len = None
        while True:
            kw = {} if sub_len is None else {"sub_len0": sub_len}
            res = self.engine.run_interval(
                state, cands, geom, il, max_steps=msd, t_local0=t_loc,
                t_comp0=t_cmp, t_base=fdtype.type(self.t),
                step_base=self.step + total, steps_done0=total, **kw)
            k = int(res.n_steps)
            total += k
            sub_len = res.sub_len
            n_roll += int(res.n_rollbacks)
            n_sync += res.n_syncs
            state, cands, geom = res.state, res.cands, res.geom
            t_loc, t_cmp = res.t_local, res.t_comp
            if bool(res.overflow) or bool(res.skin_guard):
                break  # surface the flag at the interval level, fail fast
            if float(t_loc) >= float(il) or k == 0:
                break
        self.host_syncs += n_sync
        return res._replace(n_rollbacks=n_roll, n_syncs=n_sync), total

    # ---- main entry ----
    def run(self) -> dict:
        cfg = self.cfg
        self.log("SPH Poiseuille Flow Simulation (PyTorch port, "
                 f"device={self.device})")
        self.log("boundary mode: thick-wall particles + in-operator "
                 "no-slip / no-penetration")
        self.log(f"params: DL={cfg.DL:.3f}, DH={cfg.DH:.3f}, "
                 f"dp={cfg.dp:.4f}, h={cfg.h:.4f}")
        self.log(f"params: rho0={cfg.rho0:.3f}, mu={cfg.mu:.3f}, "
                 f"U_bulk={cfg.U_bulk:.6f}, c_f={cfg.c_f:.3f}")
        self.log(f"derived: g={cfg.gravity_g:.6f}, Umax={cfg.U_max:.6f}, "
                 f"p0={cfg.p0:.6f}, transport_coeff={cfg.transport_coeff:.3f}")
        self.log(f"simulation: end_time={cfg.end_time:.3f}, "
                 f"output_interval={cfg.output_interval:.3f}, "
                 f"sort_interval={cfg.sort_interval}")
        self.log(f"particles: fluid={self.scene.n_fluid}, "
                 f"wall={self.scene.n_wall}, total={self.scene.n_total}")

        state = initial_state(cfg, self.scene, self.device)
        state = self._try_restart(state)

        # initial layout + density pass (SPH_Poiseuille.m:165-173)
        state, cands, geom, overflow = self.engine.init(state)
        if bool(overflow):
            raise RuntimeError(
                "neighbor cell capacity exceeded during initialization; "
                "increase cell_capacity")

        self._sample_mid_profile(state)

        # host-side scalars enter at the CONFIG dtype (an f32 cast would
        # truncate interval/t on the float64 path)
        fdtype = np.dtype(cfg.dtype)
        eps = 1e-9
        while self.t < cfg.end_time - eps:
            target = min(self.t + cfg.output_interval, cfg.end_time)
            interval = target - self.t
            t0 = time.perf_counter()
            with interval_range():
                res, n_steps = self._dispatch_interval(
                    state, cands, geom, interval, fdtype)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            elapsed = time.perf_counter() - t0
            self.wall_time_in_loop += elapsed
            self.total_steps_run += n_steps
            if bool(res.overflow):
                raise RuntimeError(
                    f"neighbor cell capacity exceeded during interval "
                    f"ending t={target:.6f}; increase cell_capacity")
            if bool(res.skin_guard):
                raise RuntimeError(
                    f"neighbor drift guard: a SINGLE step straight out "
                    f"of a rebuild crossed a per-axis drift budget "
                    f"during interval ending t={target:.6f} -- rollback "
                    f"backoff cannot recover this (divergence, or a "
                    f"skin far too small for one step's motion); "
                    f"increase neighbor_skin or check the dt criteria")
            if int(res.n_rollbacks) > 0:
                self.log(
                    f"  [drift-guard] {int(res.n_rollbacks)} sub-chunk "
                    f"rollback(s) in interval ending t={target:.6f}")
            if not np.isfinite(float(res.v_max)):
                raise RuntimeError(
                    f"simulation diverged (non-finite velocities) in the "
                    f"interval ending t={target:.6f} at step {self.step}")
            state, cands, geom = res.state, res.cands, res.geom
            self.t = target
            self.step += n_steps
            self.tau_history.append((self.t, float(res.tau_bottom),
                                     float(res.tau_top)))
            self.v_max_history.append(float(res.v_max))

            if cfg.step_log_every > 0:
                self._drain_step_log(res)

            self.log(
                f"output point: t={self.t:.6f}, step={self.step}, "
                f"steps_in_interval={n_steps}, dt~={interval / max(n_steps, 1):.4e}, "
                f"pairs={int(res.n_pairs)}, vmax={float(res.v_max):.4f}, "
                f"wall={elapsed:.2f}s")
            self.log(
                f"  [thick-wall-noslip] tau_bot={float(res.tau_bottom):.4f}, "
                f"tau_top={float(res.tau_top):.4f}, "
                f"tau_target={cfg.tau_target:.4f}")

            checkpoint.save_restart(self.paths.restart, cfg.signature,
                                    state, self.t, self.step)
            self._sample_mid_profile(state)

        # ---- postprocess handoff (SPH_Poiseuille.m:304-310) ----
        data = pp.make_postprocess_data(
            cfg, self.scene, state,
            np.asarray(self.profile_times),
            np.stack(self.mid_profile_u, axis=1),
            self.paths.result_png, self.paths.profile_evolution_png,
            full_profile_u=np.stack(self.full_profile_u, axis=1))
        pp.save_postprocess_npz(self.paths.postprocess_npz, data)
        result = pp.run_postprocess(data, quiet=False)
        self.log(f"postprocess data saved: {self.paths.postprocess_npz}")

        result.update(
            t=self.t, step=self.step,
            tau_bottom=self.tau_history[-1][1] if self.tau_history
            else float("nan"),
            tau_top=self.tau_history[-1][2] if self.tau_history
            else float("nan"),
            tau_history=list(self.tau_history),
            v_max_history=list(self.v_max_history),
            wall_time_in_loop=self.wall_time_in_loop,
            host_syncs=self.host_syncs,
            particle_steps_per_sec=(
                self.total_steps_run * self.scene.n_fluid
                / self.wall_time_in_loop
                if self.wall_time_in_loop > 0 else float("nan")),
            final_state=state,
        )
        return result


def run_from_ini(config_path: str, base_dir: str = ".",
                 log: Callable[[str], None] = print, device="cuda",
                 **engine_kwargs) -> dict:
    cfg = load_config(config_path, **engine_kwargs)
    paths = SimulationPaths.from_env(base_dir)
    return Simulation(cfg, paths, log=log, device=device).run()
