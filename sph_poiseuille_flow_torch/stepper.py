"""Interval stepper of the fused cell-layout engine (torch port of the JAX
package's ``stepper.PallasCellEngine``).

Operator order is the reference's (SPH_Poiseuille.m:254-283) and the JAX
package's: density -> KGC -> viscous(+gravity) -> shifting -> pressure ->
kick -> continuity -> positions, with the candidate rebuild after the
step. The JAX package runs an output interval as nested
``lax.while_loop``s on device; here the host drives the same loops:

* a sub-chunk is one ``fused_chunk_call`` (up to ``sub_steps`` steps, no
  host sync inside on CUDA), followed by ``pair_drift_bounds``;
* ONE host sync per sub-chunk reads (bx, by, t, t_comp, steps);
* the predictive soft stop, the 3/4-budget floor and the rollback with
  halving decide on the host, in float32 exactly as the JAX loop does;
* a rollback simply drops the sub-chunk's outputs (the chunk leaves its
  inputs intact);
* every sub-chunk group ends in a ``build_fused_layout`` rebuild.

With ``step_log_every > 0`` the interval runs step by step instead (the
JAX ``CellEngine._run_interval`` loop that ``PallasCellEngine`` falls back
to, stepper.py:520-593): one fused step, the rebuild cadence
``min(rebuild_every, 8)`` with the absolute-displacement guard, the wall
shear every step and a step-log row every ``step_log_every`` steps (the
reference's per-step log, SPH_Poiseuille.m:285-291). It takes one host
sync per step; it is not the hot path.

``CellEngine`` is the JAX package's XLA cell-layout engine
(stepper.py:395-594) in plain torch ops (``ops/cellgrid.py``), in float32
or float64 on any device: the engine of float64 runs. Its interval loop is
a Python loop with one host sync per step (dt for the Kahan clock and the
drift flag that decides an early rebuild).

``Engine`` is the JAX package's packed-gather engine (stepper.py:173-393)
in plain torch ops: dense ``(n_fluid, C)`` neighbor rows
(``ops/neighbors.py``) and the row-math operators of ``ops/density.py``,
``viscosity.py``, ``transport.py``, ``integration.py`` and
``monitors.py``, with four packed gathers a step. It runs in float32 or
float64 on any device, with ``CellEngine``'s interval loop (one host sync
a step).

Both per-step engines also run a chunk of (g, mu) sweep lanes in lockstep
(``run_lanes``, for ``parallel/sweep.py``): the step mapped over a leading
lane axis with ``torch.func.vmap``, one host sync a batched step.

State lives as a ``NamedTuple`` of 1-D tensors on one explicit device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import SPHConfig
from .models.poiseuille import Scene
from .ops import cellgrid as cg
from .ops import fused_cell as pc
from .ops import neighbors as nbr
from .ops.density import density_sums, kernel_gradient_correction
from .ops.integration import (continuity_rate, finalize_density, half_drift,
                              half_kick_eos, kick, periodic_wrap,
                              pressure_force, verlet_dt)
from .ops.monitors import wall_shear
from .ops.neighbors import gather_pack
from .ops.transport import transport_correction
from .ops.viscosity import viscous_force


class State(NamedTuple):
    """Particle state (fluid first, walls last; reference
    SPH_Poiseuille.m:107-123, 208-219): separate 1-D tensors."""

    x: torch.Tensor
    y: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    rho: torch.Tensor
    p: torch.Tensor
    drho_dt: torch.Tensor
    fx: torch.Tensor        # pressure force (reference `force`)
    fy: torch.Tensor
    fpx: torch.Tensor       # prior force (viscous + gravity)
    fpy: torch.Tensor
    vol: torch.Tensor
    b11: torch.Tensor
    b12: torch.Tensor
    b21: torch.Tensor
    b22: torch.Tensor


STEP_LOG_CAP = 1024  # step-log rows kept per interval
STEP_LOG_COLS = 7    # step, t, dt, n_pairs, v_max, tau_bottom, tau_top

# the range that marks each rebuild of the chunk path on its layout sets
# in a capture (``--profile``; a no-op when no profiler runs)
REBUILD_SPAN = "sph_rebuild"


class IntervalResult(NamedTuple):
    """One interval's outcome. Device values (tau, v_max, n_pairs,
    overflow) stay 0-dim tensors; values the host loop already knows are
    plain numbers."""

    state: State
    cands: NamedTuple           # FusedLayout (fused), CellLayout (cellgrid),
    #                             Candidates (gather)
    geom: object                # pair count (fused), CellGeometry
    #                             (cellgrid), Geometry (gather)
    tau_bottom: torch.Tensor
    tau_top: torch.Tensor
    n_steps: int
    overflow: torch.Tensor      # bool: cell-capacity overflow
    # The per-step paths' single-step displacement guard and the mesh's
    # slab-row jump. The fused chunk path never sets it, where the JAX
    # package's flags a one-step sub-chunk straight out of a rebuild that
    # crosses the drift budget: that step cannot miss a pair
    # (``PallasCellEngine._run_group``), so it is kept and counted in
    # ``n_kept_crossings``; a diverging run stops on non-finite values.
    skin_guard: bool
    v_max: torch.Tensor
    n_pairs: torch.Tensor
    n_rollbacks: int = 0
    t_local: Optional[np.floating] = None
    t_comp: Optional[np.floating] = None
    sub_len: Optional[int] = None
    n_syncs: int = 0            # host syncs the interval took
    n_kept_crossings: int = 0   # fused: one-step crossings kept (above)
    # step_log_every > 0 only: (STEP_LOG_CAP, STEP_LOG_COLS) host rows and
    # the number of rows due (rows past the cap are counted, not kept)
    step_log: Optional[np.ndarray] = None
    step_log_n: int = 0


def _log_row_update(every, logbuf, logn, g_step, t_after, dt, n_pairs,
                    vmax, tau_b, tau_t):
    """Append one step-log row to ``logbuf`` (in place) when ``g_step``
    lands on the ``every``-step cadence (JAX ``_log_row_update``,
    stepper.py:127-138). Rows beyond STEP_LOG_CAP are dropped but still
    counted. Returns the new row count."""
    if g_step % every != 0:
        return logn
    if logn < STEP_LOG_CAP:
        logbuf[logn] = (g_step, t_after, dt, n_pairs, vmax, tau_b, tau_t)
    return logn + 1


def _t_add(t, comp, dt):
    """Kahan-compensated interval clock ``t += dt`` (the JAX package's
    ``stepper._t_add``; SPH_Poiseuille.m:250, :259, :267 remainder
    semantics)."""
    y = dt - comp
    s = t + y
    return s, (s - t) - y


def initial_state(cfg: SPHConfig, scene: Scene, device) -> State:
    dtype = getattr(torch, cfg.dtype)
    n = scene.n_total

    def arr(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    z = torch.zeros(n, dtype=dtype, device=device)
    mass = arr(scene.mass)
    rho = torch.full((n,), cfg.rho0, dtype=dtype, device=device)
    return State(
        x=arr(scene.x), y=arr(scene.y), vx=z, vy=z.clone(), rho=rho,
        p=z.clone(), drho_dt=z.clone(), fx=z.clone(), fy=z.clone(),
        fpx=z.clone(), fpy=z.clone(), vol=mass / rho,
        b11=torch.ones(n, dtype=dtype, device=device), b12=z.clone(),
        b21=z.clone(), b22=torch.ones(n, dtype=dtype, device=device))


def _lane_where(mask: torch.Tensor, a, b):
    """Per lane, ``a`` where ``mask`` else ``b``, over NamedTuples of
    tensors with a leading lane axis (``lax.cond`` and the frozen lanes of
    a ``while_loop`` under ``jax.vmap``)."""
    def sel(u, v):
        return torch.where(mask.reshape((-1,) + (1,) * (u.dim() - 1)), u, v)
    return type(a)(*(sel(u, v) for u, v in zip(a, b)))


class _PerStepEngine:
    """What the two per-step engines share (``CellEngine``, ``Engine``):
    the set-up, the neighbor refresh decided on the host and the interval
    loop, a Python loop with one host sync per step (JAX
    ``Engine._run_interval`` and ``CellEngine._run_interval``,
    stepper.py:302-393, :520-593), and the same loop over a lane axis
    (``run_lanes``, the JAX sweep's ``jax.vmap`` of the interval). A
    subclass gives ``_advance`` (the step up to its wrapped positions),
    ``_rebuild``, ``_drift_over``, ``_geometry``, ``final_shear`` and
    ``_count_pairs``."""

    def __init__(self, cfg: SPHConfig, scene: Scene, device,
                 s_multiple: int = 1):
        self.device = torch.device(device)
        self.cfg = cfg
        self.scene = scene
        self.spec = nbr.make_grid_spec(cfg, scene, s_multiple=s_multiple)
        dtype = getattr(torch, cfg.dtype)
        self.dtype = dtype
        self._mass = torch.as_tensor(scene.mass, dtype=dtype,
                                     device=self.device)
        self._wall_vx = torch.zeros(scene.n_total, dtype=dtype,
                                    device=self.device)
        self._wall_vy = torch.zeros_like(self._wall_vx)
        self._lane_fns = None

    def _false(self):
        return torch.zeros((), dtype=torch.bool, device=self.device)

    def _refresh(self, lay, x0, y0, x, y, dt, step_idx: int):
        """The neighbor refresh after a step: (layout, host dt, guard). The
        one host sync of the step reads dt and the accumulated-drift flag
        together; the rebuild the JAX loop takes under ``lax.cond`` is
        decided here. Accumulated drift past the half skin rebuilds early
        (self-healing); a single step's crossing is the unrecoverable
        guard (stepper.py:235-264, :445-458)."""
        cfg = self.cfg
        if cfg.rebuild_every <= 1:
            return self._rebuild(x, y), dt.item(), self._false()
        drift_over = self._drift_over(lay, x, y)
        dt_h, over = torch.stack([dt, drift_over.to(dt.dtype)]).tolist()
        if step_idx % cfg.rebuild_every == 0 or over:
            lay = self._rebuild(x, y)
        guard = nbr.step_displacement_exceeded(self.spec, x0, y0, x, y)
        return lay, dt_h, guard

    def _step(self, state: State, lay, geom, step_idx: int, remain, g, mu,
              shear: bool):
        """One step: the physics, then the neighbors refreshed every
        ``rebuild_every`` steps or on accumulated drift and the geometry
        every step. Returns (state, layout, geometry, dt, host dt,
        overflow, guard, tau_bottom, tau_top); tau is None unless
        ``shear``."""
        new_state, dt = self._advance(state, lay, geom, remain, g, mu)
        lay, dt_h, guard = self._refresh(lay, state.x, state.y, new_state.x,
                                         new_state.y, dt, step_idx)
        geom = self._geometry(lay, new_state)
        tau = (self.final_shear(new_state, lay, geom, mu) if shear
               else (None, None))
        return (new_state, lay, geom, dt, dt_h, lay.overflow, guard) + tau

    def step(self, state: State, lay, geom, step_idx: int = 0,
             remain=float("inf"), g=None, mu=None):
        """One step with the wall shear on its post-rebuild neighbors:
        (state, layout, geometry, dt, overflow, guard, tau_bottom,
        tau_top)."""
        cfg = self.cfg
        g = cfg.gravity_g if g is None else g
        mu = cfg.mu if mu is None else mu
        r = self._step(state, lay, geom, step_idx, remain, g, mu, True)
        return r[:4] + r[5:]

    def run_interval(self, state: State, lay, geom, interval_len,
                     g=None, mu=None, max_steps=None, t_local0=None,
                     t_comp0=None, sub_len0=None, t_base=None,
                     step_base=None, steps_done0=None) -> IntervalResult:
        """Run to the next output point. ``max_steps``/``t_local0``/
        ``t_comp0``/``steps_done0``: trajectory-preserving step-bounded
        dispatch (``sub_len0`` is accepted and ignored). The wall shear is
        observed only where it is read: every step with the step log, else
        once from the final carry, which equals the last step's in-loop
        value (the same post-rebuild neighbors and post-kick state)."""
        del sub_len0
        cfg, spec = self.cfg, self.spec
        g = cfg.gravity_g if g is None else g
        mu = cfg.mu if mu is None else mu
        f = np.float32 if self.dtype == torch.float32 else np.float64
        every = int(cfg.step_log_every)
        nf = spec.n_fluid
        interval = f(interval_len)
        t_local = f(0.0) if t_local0 is None else f(t_local0)
        t_comp = f(0.0) if t_comp0 is None else f(t_comp0)
        t_base = f(0.0) if t_base is None else f(t_base)
        step_base = 0 if step_base is None else int(step_base)
        sd0 = 0 if steps_done0 is None else int(steps_done0)
        logbuf = (np.zeros((STEP_LOG_CAP, STEP_LOG_COLS), dtype=f)
                  if every > 0 else None)
        logn = n_steps = n_syncs = 0
        overflow = guard = self._false()
        tau_b = tau_t = torch.zeros((), dtype=self.dtype, device=self.device)
        while t_local < interval and (max_steps is None
                                      or n_steps < int(max_steps)):
            (state, lay, geom, _, dt_h, ovf, grd, tb, tt) = self._step(
                state, lay, geom, sd0 + n_steps, interval - t_local, g, mu,
                every > 0)
            n_syncs += 1
            overflow = torch.logical_or(overflow, ovf)
            guard = torch.logical_or(guard, grd)
            t_local, t_comp = _t_add(t_local, t_comp, f(dt_h))
            if every > 0:
                tau_b, tau_t = tb, tt
                vmax = torch.sqrt(torch.max(state.vx[:nf] ** 2
                                            + state.vy[:nf] ** 2))
                row = torch.stack([self._count_pairs(lay, geom).to(
                    self.dtype), vmax, tau_b, tau_t]).tolist()
                logn = _log_row_update(every, logbuf, logn,
                                       step_base + n_steps + 1,
                                       t_base + t_local, dt_h, *row)
            n_steps += 1
        if every == 0:
            tau_b, tau_t = self.final_shear(state, lay, geom, mu)
        v_max = torch.sqrt(torch.max(state.vx[:nf] ** 2
                                     + state.vy[:nf] ** 2))
        n_pairs = self._count_pairs(lay, geom)
        return IntervalResult(
            state=state, cands=lay, geom=geom, tau_bottom=tau_b,
            tau_top=tau_t, n_steps=n_steps, overflow=overflow,
            skin_guard=bool(guard), v_max=v_max, n_pairs=n_pairs,
            t_local=t_local, t_comp=t_comp, n_syncs=n_syncs + 1,
            step_log=logbuf, step_log_n=logn)

    def _lane_advance(self, state: State, lay, geom, remain, g, mu):
        """A lane's step up to its refresh: (state, dt, accumulated-drift
        flag, single-step guard); mapped over the lanes by ``run_lanes``."""
        new_state, dt = self._advance(state, lay, geom, remain, g, mu)
        if self.cfg.rebuild_every <= 1:
            return new_state, dt, self._false(), self._false()
        return (new_state, dt, self._drift_over(lay, new_state.x,
                                                new_state.y),
                nbr.step_displacement_exceeded(self.spec, state.x, state.y,
                                               new_state.x, new_state.y))

    def _lanes(self):
        """The lane-mapped functions (``torch.func.vmap`` over a leading
        lane axis), made once."""
        if self._lane_fns is None:
            vmap = torch.func.vmap
            self._lane_fns = dict(
                advance=vmap(self._lane_advance),
                rebuild=vmap(self._rebuild),
                geometry=vmap(self._geometry),
                shear=vmap(self.final_shear),
                pairs=vmap(self._count_pairs))
        return self._lane_fns

    def run_lanes(self, states: State, lays, geoms, interval_len, gs,
                  mus) -> IntervalResult:
        """Run every lane to the next output point in lockstep (the JAX
        sweep's ``jax.vmap(engine._run_interval)``, sweep.py:163-164).
        ``states``, ``lays`` and ``geoms`` carry a leading lane axis, ``gs``
        and ``mus`` one value a lane. Each step is one mapped step of every
        lane and ONE host sync, which reads every lane's dt and drift flag
        together. A lane rebuilds when its own cadence or drift says so:
        the mapped rebuild runs once and each lane takes its result or
        keeps its layout (``torch.where``, as ``lax.cond`` under vmap). A
        lane that reached the output point is frozen (its carry, clock and
        step count stay) while the others run on, so each lane takes the
        steps and rebuilds of its single run. No step log. Returns an
        ``IntervalResult`` whose fields hold one value a lane: ``n_steps``
        and ``skin_guard`` as numpy arrays, the rest as tensors."""
        cfg, spec = self.cfg, self.spec
        fns = self._lanes()
        f = np.float32 if self.dtype == torch.float32 else np.float64
        nf = spec.n_fluid
        n = states.x.shape[0]
        gs = torch.as_tensor(np.asarray(gs), dtype=self.dtype,
                             device=self.device)
        mus = torch.as_tensor(np.asarray(mus), dtype=self.dtype,
                              device=self.device)
        interval = f(interval_len)
        t_local = np.zeros(n, f)
        t_comp = np.zeros(n, f)
        n_steps = np.zeros(n, np.int64)
        n_syncs = 0
        rb = int(cfg.rebuild_every)
        overflow = lays.overflow
        guard = torch.zeros(n, dtype=torch.bool, device=self.device)
        active = t_local < interval
        while active.any():
            remain = torch.as_tensor(interval - t_local, device=self.device)
            new, dt, drift, grd = fns["advance"](states, lays, geoms, remain,
                                                 gs, mus)
            # the one host sync of the step, for every lane
            dt_h, drift_h = torch.stack([dt, drift.to(dt.dtype)]).tolist()
            n_syncs += 1
            every_lane = bool(active.all())
            act = torch.as_tensor(active, device=self.device)
            step_idx = int(n_steps[active][0])
            due = active & ((rb <= 1 or step_idx % rb == 0)
                            | np.asarray(drift_h, bool))
            if due.any():
                rebuilt = fns["rebuild"](new.x, new.y)
                lays = (rebuilt if due.all() else _lane_where(
                    torch.as_tensor(due, device=self.device), rebuilt, lays))
            geom_new = fns["geometry"](lays, new)
            if every_lane:
                states, geoms = new, geom_new
            else:
                states = _lane_where(act, new, states)
                geoms = _lane_where(act, geom_new, geoms)
            overflow = torch.logical_or(overflow, lays.overflow)
            guard = torch.logical_or(guard, torch.logical_and(grd, act))
            tl, tc = _t_add(t_local, t_comp, np.asarray(dt_h, f))
            t_local = np.where(active, tl, t_local)
            t_comp = np.where(active, tc, t_comp)
            n_steps += active
            active = t_local < interval
        tau_b, tau_t = fns["shear"](states, lays, geoms, mus)
        v_max = torch.sqrt(torch.amax(states.vx[:, :nf] ** 2
                                      + states.vy[:, :nf] ** 2, dim=1))
        n_pairs = fns["pairs"](lays, geoms)
        return IntervalResult(
            state=states, cands=lays, geom=geoms, tau_bottom=tau_b,
            tau_top=tau_t, n_steps=n_steps, overflow=overflow,
            skin_guard=guard.cpu().numpy(), v_max=v_max, n_pairs=n_pairs,
            t_local=t_local, t_comp=t_comp, n_syncs=n_syncs + 1)


class CellEngine(_PerStepEngine):
    """The cell-layout engine of plain torch ops (``ops/cellgrid.py``; the
    JAX package's ``CellEngine``, stepper.py:395-594): every per-pair
    access is a static slice of the padded cell grid; one packed scatter
    and one packed collect per step touch particle order. It runs in
    float32 or float64 on any device.

    API as the fused engine's: ``init(state) -> (state, layout, geometry,
    overflow)``, ``step`` and ``run_interval(state, layout, geometry,
    interval_len, ...) -> IntervalResult``. ``s_multiple`` pads the cell
    rows so that S = ny*nx divides by it (the grid of the y-slab engine,
    ``parallel.ShardedCellEngine``)."""

    def __init__(self, cfg: SPHConfig, scene: Scene, device,
                 s_multiple: int = 1):
        super().__init__(cfg, scene, device, s_multiple=s_multiple)
        self._wall_y = torch.as_tensor(scene.y, dtype=self.dtype,
                                       device=self.device)

    def _rebuild(self, x, y):
        return cg.build_layout(self.spec, x, y, self._mass, self._wall_vx,
                               self._wall_vy, self._wall_y)

    def _drift_over(self, lay, x, y):
        return cg.displacement_exceeded(self.spec, lay, x, y)

    def _count_pairs(self, lay, geom):
        return cg.count_pairs(lay, geom)

    def _geometry(self, lay, state: State):
        return cg.compute_geometry(self.spec, lay, state.x, state.y)

    def _advance(self, state: State, lay, geom, remain, g, mu):
        """The step up to its wrapped positions (JAX ``CellEngine._step``
        before the refresh): (state, dt)."""
        cfg, spec = self.cfg, self.spec
        nf = spec.n_fluid
        dt = verlet_dt(state.vx[:nf], state.vy[:nf], cfg.c_f, cfg.h,
                       mu / cfg.rho0, g, remain)
        out = self._cell_step(lay, geom, state, dt, cfg.transport_coeff, g,
                              mu)
        new_state = State(
            x=periodic_wrap(spec, out["x"]), y=out["y"], vx=out["vx"],
            vy=out["vy"], rho=out["rho"], p=out["p"],
            drho_dt=out["drho_dt"], fx=out["fx"], fy=out["fy"],
            fpx=out["fpx"], fpy=out["fpy"], vol=out["vol"],
            b11=out["b11"], b12=out["b12"], b21=out["b21"],
            b22=out["b22"])
        return new_state, dt

    def _cell_step(self, lay, geom, state: State, dt, transport_coeff, g,
                   mu):
        """The cell step of ``state`` (``ops/cellgrid.cell_step``); the
        y-slab engine runs it slab by slab."""
        cfg = self.cfg
        return cg.cell_step(
            self.spec, lay, geom, self._mass, state.x, state.y, state.vx,
            state.vy, state.drho_dt, dt, cfg.rho0, cfg.p0, cfg.c_f,
            cfg.inv_sigma0, transport_coeff, g, mu, cfg.wall_visc_factor)

    def init(self, state: State):
        """Initial layout + density/KGC/EOS pass (SPH_Poiseuille.m:165-173):
        a zero-dt, zero-shift cell step whose kinematic outputs are
        identities. ``drho_dt`` is kept (it carries across a restart into
        the first half-kick)."""
        cfg = self.cfg
        lay = self._rebuild(state.x, state.y)
        geom = self._geometry(lay, state)
        out = self._cell_step(
            lay, geom, state,
            torch.zeros((), dtype=self.dtype, device=self.device), 0.0,
            cfg.gravity_g, cfg.mu)
        state = state._replace(
            rho=out["rho"], p=out["p"], vol=out["vol"], b11=out["b11"],
            b12=out["b12"], b21=out["b21"], b22=out["b22"])
        return state, lay, geom, lay.overflow

    def final_shear(self, state: State, lay, geom, mu):
        """The wall shear of the loop's final carry, which equals the final
        step's in-loop value (same post-rebuild layout and post-kick state,
        SPH_Poiseuille.m:280-283)."""
        return cg.cell_wall_shear(
            self.spec, lay, geom, state.vx, state.vol, state.b11, state.b12,
            state.b21, state.b22, mu, self.cfg.wall_visc_factor)


class Engine(_PerStepEngine):
    """The packed-gather engine of plain torch ops (the JAX package's
    ``Engine``, stepper.py:173-393): every physics operator is row math
    over the compacted ``(n_fluid, C)`` candidate rows, and all
    neighbor-side values flow through four packed gathers a step:

      A [vol] -> B [B(4), v(2), rho_half, p_half] -> C [v_new(2)]
      -> D [x, y, vol] (the next step's geometry)

    Operator order is the reference's (SPH_Poiseuille.m:254-283):
    density -> KGC -> viscous(+gravity) -> shifting -> Verlet (stage-1
    force, kick, stage 2, finalize) -> wrap -> candidate refresh ->
    geometry; the Verlet step integrates on the pre-shift geometry, as
    the reference does. It runs in float32 or float64 on any device and
    launches none of the port's kernels.

    API as ``CellEngine``'s: ``init(state) -> (state, candidates,
    geometry, overflow)``, ``step`` and ``run_interval(state, candidates,
    geometry, interval_len, ...) -> IntervalResult``."""

    def _rebuild(self, x, y):
        return nbr.build_candidates(self.spec, x, y, self._mass,
                                    self._wall_vx, self._wall_vy)

    def _drift_over(self, cands, x, y):
        return nbr.displacement_exceeded(self.spec, cands, x, y)

    def _count_pairs(self, cands, geom):
        return nbr.count_pairs(geom)

    def _geometry(self, cands, state: State):
        return nbr.compute_geometry(self.spec, cands, state.x, state.y,
                                    state.vol)

    def _advance(self, state: State, cands, geom, remain, g, mu):
        """The step up to its wrapped positions (JAX ``Engine._step``
        before the refresh): (state, dt). The Verlet step integrates on
        the pre-shift geometry, as the reference does."""
        cfg, spec = self.cfg, self.spec
        nf = spec.n_fluid
        js = cands.jsafe
        mass = self._mass

        # dt depends only on pre-step velocities (SPH_Poiseuille.m:259)
        dt = verlet_dt(state.vx[:nf], state.vy[:nf], cfg.c_f, cfg.h,
                       mu / cfg.rho0, g, remain)

        # density reinit + stage-1 half-kick EOS
        rho, vol = density_sums(spec, geom, cands, mass, cfg.rho0,
                                cfg.inv_sigma0)
        rho_half, p_half = half_kick_eos(spec, rho, state.drho_dt, dt,
                                         cfg.rho0, cfg.p0)

        (vol_j,) = gather_pack(js, (vol,))                     # gather A
        b11, b12, b21, b22 = kernel_gradient_correction(spec, geom, vol_j)

        (b11_j, b12_j, b21_j, b22_j, vx_j, vy_j, rho_half_j,
         p_half_j) = gather_pack(js, (b11, b12, b21, b22, state.vx,
                                      state.vy, rho_half, p_half))  # B

        fpx, fpy = viscous_force(
            spec, geom, cands, state.vx, state.vy, vol, b11, b12, b21, b22,
            vol_j, b11_j, b12_j, b21_j, b22_j, vx_j, vy_j, mu, cfg.h,
            cfg.wall_visc_factor)
        fpx = torch.cat([fpx[:nf] + mass[:nf] * g, fpx[nf:]])

        x, y = transport_correction(
            spec, geom, state.x, state.y, b11, b12, b21, b22,
            vol_j, b11_j, b12_j, b21_j, b22_j, cfg.h, cfg.transport_coeff)

        # verlet: stage 1 force, kick, stage 2, finalize
        x, y = half_drift(spec, x, y, state.vx, state.vy, dt)
        fx, fy, _ = pressure_force(
            spec, geom, cands, rho_half, p_half, mass, state.vx,
            state.vy, fpx, fpy, vol, b11, b12, b21, b22,
            vol_j, b11_j, b12_j, b21_j, b22_j, vx_j, vy_j,
            rho_half_j, p_half_j, cfg.rho0, cfg.c_f)
        vx2, vy2 = kick(spec, state.vx, state.vy, fpx, fpy, fx, fy, mass,
                        dt)
        x, y = half_drift(spec, x, y, vx2, vy2, dt)
        vx2_j, vy2_j = gather_pack(js, (vx2, vy2))             # gather C
        drho_dt = continuity_rate(spec, geom, cands, rho_half, vx2, vy2,
                                  vol_j, vx2_j, vy2_j)
        rho, p = finalize_density(spec, rho_half, drho_dt, dt, cfg.rho0,
                                  cfg.p0)
        x = periodic_wrap(spec, x)
        return State(x=x, y=y, vx=vx2, vy=vy2, rho=rho, p=p,
                     drho_dt=drho_dt, fx=fx, fy=fy, fpx=fpx, fpy=fpy,
                     vol=vol, b11=b11, b12=b12, b21=b21, b22=b22), dt

    def init(self, state: State):
        """Initial candidate build + density/KGC pass
        (SPH_Poiseuille.m:165-173; JAX ``Engine._init``). ``drho_dt`` is
        kept (it carries across a restart into the first half-kick)."""
        cfg, spec = self.cfg, self.spec
        nf = spec.n_fluid
        cands = self._rebuild(state.x, state.y)
        geom = nbr.compute_geometry(spec, cands, state.x, state.y,
                                    state.vol)
        rho, vol = density_sums(spec, geom, cands, self._mass, cfg.rho0,
                                cfg.inv_sigma0)
        (vol_j,) = gather_pack(cands.jsafe, (vol,))
        b11, b12, b21, b22 = kernel_gradient_correction(spec, geom, vol_j)
        p_f = cfg.p0 * (rho[:nf] / cfg.rho0 - 1.0)
        p = torch.cat([p_f, p_f.new_zeros((spec.n_total - nf,))])
        state = state._replace(rho=rho, p=p, vol=vol, b11=b11, b12=b12,
                               b21=b21, b22=b22)
        return state, cands, geom, cands.overflow

    def final_shear(self, state: State, cands, geom, mu):
        """The wall shear of the carry (SPH_Poiseuille.m:280-283), on its
        post-rebuild candidates and the geometry's gathered volumes."""
        cfg = self.cfg
        return wall_shear(self.spec, geom, cands, state.vx, state.vol,
                          state.b11, state.b12, state.b21, state.b22,
                          cfg.DL, mu, cfg.h, cfg.wall_visc_factor)


class SubChunkRun:
    """A group's sub-chunk runner (``PallasCellEngine._run_group``): a
    call runs up to ``n_sub`` steps from the kept state and returns (what
    it reached, steps, t, t_comp, host syncs); ``read`` brings what the
    group's decision needs of it to the host; ``keep`` makes the last
    call's state the kept one, ``state`` returns the kept state
    (``fused_cell.BufferedChunkRun`` keeps the same protocol on
    persistent buffers)."""

    def __init__(self, cur):
        self.cur, self.new = cur, None

    def read(self, bounds, new, steps, t, t_comp):
        """(bx, by, t, t_comp, steps) of a call's result on the host, in
        one sync: the drift bounds (``bounds(new)``; 0 where ``bounds`` is
        None) and the clock, in the clock's type."""
        zero = torch.zeros((), dtype=t.dtype, device=t.device)
        bx, by = (zero, zero) if bounds is None else bounds(new)
        vals = torch.stack([bx, by, t, t_comp.to(t.device),
                            steps.to(t.device, t.dtype)]).tolist()
        return (*vals[:4], int(vals[4]))

    def keep(self):
        self.cur = self.new

    def state(self):
        return self.cur


class ChunkRun(SubChunkRun):
    """The chunk kernel over ``lay``'s cores from the kept carry (xH, yH,
    vxH, vyH, drP and the aux cores); a call returns the chunk's state
    cores, whose xP/yP the drift bounds read."""

    def __init__(self, spec, lay, carry, interval, scalars,
                 cache_slots: int = 0):
        super().__init__(carry)
        self.spec, self.lay, self.interval = spec, lay, interval
        self.scalars, self.cache_slots = scalars, cache_slots

    def __call__(self, n_sub, t_i, tc_i):
        c = self.cur
        st2, aux2, steps, t2, tc2 = pc.fused_chunk_call(
            self.spec, self.lay, c["xH"], c["yH"], c["vxH"], c["vyH"],
            c["drP"], t_i, tc_i, self.interval, n_sub, *self.scalars,
            cache_slots=self.cache_slots)
        self.new = dict(st2, **aux2)
        return st2, steps, t2, tc2, 0


class PallasCellEngine:
    """The fused cell-layout engine (the JAX package's flagship): every
    physics step runs through the three fused kernels of
    ``ops/fused_cell.py``; state is carried AS CORES inside an interval
    and returns to particle order only at rebuilds and interval ends.

    API as the JAX engine's: ``init(state) -> (state, layout, n_pairs,
    overflow)`` and ``run_interval(state, layout, n_pairs, interval_len,
    ...) -> IntervalResult``."""

    def __init__(self, cfg: SPHConfig, scene: Scene, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and cfg.dtype != "float32":
            raise NotImplementedError(
                f"the fused engine's CUDA kernels are float32 only (as "
                f"Pallas compiles f32 only), not {cfg.dtype}: run "
                f"{cfg.dtype} through the cell-layout engine (engine "
                f"'cellgrid', which 'auto' picks for float64)")
        self.cfg = cfg
        self.scene = scene
        self.spec = nbr.make_grid_spec(cfg, scene, lane_pack=True)
        dtype = getattr(torch, cfg.dtype)
        self.dtype = dtype
        self._mass = torch.as_tensor(scene.mass, dtype=dtype,
                                     device=self.device)
        self._wall_vx = torch.zeros(scene.n_total, dtype=dtype,
                                    device=self.device)
        self._wall_vy = torch.zeros_like(self._wall_vx)
        self._wall_y = torch.as_tensor(scene.y, dtype=dtype,
                                       device=self.device)
        self._shear = None
        # the chunk path's persistent buffers, and the rebuild's layout
        # sets beside them; False runs every sub-chunk through the
        # stateless fused_chunk_call (ChunkRun) and every rebuild through
        # _do_rebuild instead: the reference the tests and chip_smoke.py
        # hold the buffers to
        self.chunk_buffers = True
        self._chunks = pc.ChunkRunner()
        self._rebuilds = pc.RebuildRunner()
        self._statics = None

    def _rebuild(self, x, y, state_fields=()):
        out = pc.build_fused_layout(
            self.spec, x, y, self._mass, self._wall_vx, self._wall_vy,
            self._wall_y, state_fields=state_fields,
            shear=self._shear)
        # the wall shear's rows of the first layout serve every later one
        lay = out[0] if state_fields else out
        self._shear = lay.shear_rows, lay.shear_tbt
        return out

    def _fused_cell_step(self, lay, x, y, vx, vy, drho_dt, dt, g, mu,
                         transport_coeff=None):
        """The one fused step of init and of the per-step path (JAX
        ``PallasCellEngine._fused_cell_step``); the y-slab engine
        (``parallel.ShardedPallasEngine``) runs it slab by slab."""
        cfg = self.cfg
        tc = (cfg.transport_coeff if transport_coeff is None
              else transport_coeff)
        return pc.fused_cell_step(
            self.spec, lay, x, y, vx, vy, drho_dt, dt, cfg.rho0, cfg.p0,
            cfg.c_f, cfg.inv_sigma0, tc, g, mu, cfg.wall_visc_factor)

    def init(self, state: State):
        """Initial layout + one fused step with dt=0 and no shifting
        (SPH_Poiseuille.m:165-173): rho, p, vol and B. drho_dt is kept
        (it carries across a restart into the first half-kick)."""
        cfg = self.cfg
        lay = self._rebuild(state.x, state.y)
        out = self._fused_cell_step(
            lay, state.x, state.y, state.vx, state.vy, state.drho_dt, 0.0,
            cfg.gravity_g, cfg.mu, transport_coeff=0.0)
        state = state._replace(
            rho=out["rho"], p=out["p"], vol=out["vol"], b11=out["b11"],
            b12=out["b12"], b21=out["b21"], b22=out["b22"])
        return state, lay, out["n_pairs"], lay.overflow

    def final_shear(self, state: State, lay, mu):
        """Interval-final wall shear on the post-rebuild layout
        (SPH_Poiseuille.m:280-283)."""
        return pc.fused_wall_shear(
            self.spec, lay, state.x, state.y, state.vx, state.vol,
            state.b11, state.b12, state.b21, state.b22, mu,
            self.cfg.wall_visc_factor)

    def _scatter_all(self, lay, s: State):
        spec = self.spec
        mc = pc.make_core
        mp = pc.make_plain
        return dict(
            xH=mc(spec, lay.pidx, s.x, fill=pc._BIG_X, xshift=spec.DL),
            yH=mc(spec, lay.pidx, s.y), vxH=mc(spec, lay.pidx, s.vx),
            vyH=mc(spec, lay.pidx, s.vy), drP=mp(spec, lay.pidx, s.drho_dt),
            rhoP=mp(spec, lay.pidx, s.rho), pP=mp(spec, lay.pidx, s.p),
            fxP=mp(spec, lay.pidx, s.fx), fyP=mp(spec, lay.pidx, s.fy),
            fpxP=mp(spec, lay.pidx, s.fpx), fpyP=mp(spec, lay.pidx, s.fpy),
            volH=mc(spec, lay.pidx, s.vol), b11H=mc(spec, lay.pidx, s.b11),
            b12H=mc(spec, lay.pidx, s.b12), b21H=mc(spec, lay.pidx, s.b21),
            b22H=mc(spec, lay.pidx, s.b22))

    def _do_rebuild(self, lay, st):
        """Collect positions/velocities/drho back to particle order, wrap x
        (positions leave a chunk unwrapped; SPH_Poiseuille.m:570-577) and
        rebuild the layout with the state riding the same scatter."""
        spec = self.spec
        pk = torch.stack([st["xP"].reshape(-1), st["yP"].reshape(-1),
                          st["drP"].reshape(-1)], dim=-1)
        pk = pk[torch.clamp(lay.pidx, max=pk.shape[0] - 1)]
        hk = torch.stack([st["vxH"].reshape(-1), st["vyH"].reshape(-1)],
                         dim=-1)
        hk = hk[torch.clamp(lay.hidx, max=hk.shape[0] - 1)]
        xp = periodic_wrap(spec, pk[:, 0])
        nl, (vxP, vyP, drP) = self._rebuild(
            xp, pk[:, 1], state_fields=(hk[:, 0], hk[:, 1], pk[:, 2]))
        return nl, dict(
            xH=pc.halo_ify(spec, nl.refx_p, fill=pc._BIG_X, xshift=spec.DL),
            yH=pc.halo_ify(spec, nl.refy_p), vxH=pc.halo_ify(spec, vxP),
            vyH=pc.halo_ify(spec, vyP), drP=drP)

    def _layout_statics(self):
        """The (6, n) per-particle fields of the layouts' static cores
        (``fused_cell.layout_statics``), built once."""
        if self._statics is None:
            self._statics = torch.stack(pc.layout_statics(
                self.spec, self._mass, self._wall_vx, self._wall_vy,
                self._wall_y, self._mass))
        return self._statics

    def _abs_guard(self, lay, x, y):
        """The per-step path's conservative ABSOLUTE-displacement guard
        (JAX ``fused_guard``, stepper.py:660-666)."""
        spec = self.spec
        if spec.skin <= 0.0:
            return torch.zeros((), dtype=torch.bool, device=self.device)
        ddx = x - pc.take_p(lay, lay.refx_p)
        ddx = ddx - spec.DL * torch.round(ddx / spec.DL)
        ddy = y - pc.take_p(lay, lay.refy_p)
        return torch.max(ddx * ddx + ddy * ddy) > (0.5 * spec.skin) ** 2

    def step(self, state: State, lay, step_idx: int = 0,
             remain=float("inf"), g=None, mu=None):
        """One step of the per-step path (JAX ``PallasCellEngine._step``,
        stepper.py:640-701): the fused step, then a rebuild every
        ``min(rebuild_every, 8)`` steps (positions stay unwrapped between
        rebuilds), the absolute-displacement guard and the wall shear on
        the post-rebuild layout. Returns (state, layout, n_pairs, dt,
        overflow, guard, tau_bottom, tau_top) as tensors."""
        cfg, spec = self.cfg, self.spec
        g = cfg.gravity_g if g is None else g
        mu = cfg.mu if mu is None else mu
        nf = spec.n_fluid
        dt = verlet_dt(state.vx[:nf], state.vy[:nf], cfg.c_f, cfg.h,
                       mu / cfg.rho0, g, remain)
        out = self._fused_cell_step(lay, state.x, state.y, state.vx,
                                    state.vy, state.drho_dt, dt, g, mu)
        x, y = out["x"], out["y"]
        rb_eff = min(cfg.rebuild_every, 8)
        if rb_eff <= 1 or step_idx % rb_eff == 0:
            x = periodic_wrap(spec, x)
            lay = self._rebuild(x, y)
        if rb_eff <= 1:
            guard = torch.zeros((), dtype=torch.bool, device=self.device)
        else:
            guard = self._abs_guard(lay, x, y)
        tau_b, tau_t = pc.fused_wall_shear(
            spec, lay, x, y, out["vx"], out["vol"], out["b11"], out["b12"],
            out["b21"], out["b22"], mu, cfg.wall_visc_factor)
        new_state = State(
            x=x, y=y, vx=out["vx"], vy=out["vy"], rho=out["rho"],
            p=out["p"], drho_dt=out["drho_dt"], fx=out["fx"], fy=out["fy"],
            fpx=out["fpx"], fpy=out["fpy"], vol=out["vol"],
            b11=out["b11"], b12=out["b12"], b21=out["b21"],
            b22=out["b22"])
        return (new_state, lay, out["n_pairs"], dt, lay.overflow, guard,
                tau_b, tau_t)

    def _run_interval_steps(self, state: State, lay, geom, interval_len,
                            g, mu, max_steps, t_local0, t_comp0, t_base,
                            step_base, steps_done0) -> IntervalResult:
        """The per-step interval loop with the step log (JAX
        ``CellEngine._run_interval``, stepper.py:520-593). One host sync
        per step reads dt (for the Kahan clock) and the step's log
        values; the flags stay on the device until the end."""
        cfg, spec = self.cfg, self.spec
        f = np.float32 if self.dtype == torch.float32 else np.float64
        every = int(cfg.step_log_every)
        nf = spec.n_fluid
        interval = f(interval_len)
        t_local = f(0.0) if t_local0 is None else f(t_local0)
        t_comp = f(0.0) if t_comp0 is None else f(t_comp0)
        t_base = f(0.0) if t_base is None else f(t_base)
        step_base = 0 if step_base is None else int(step_base)
        sd0 = 0 if steps_done0 is None else int(steps_done0)
        logbuf = np.zeros((STEP_LOG_CAP, STEP_LOG_COLS), dtype=f)
        logn = n_steps = n_syncs = 0
        npairs = torch.as_tensor(geom, device=self.device).to(torch.int32)
        overflow = lay.overflow
        guard = torch.zeros((), dtype=torch.bool, device=self.device)
        tau_b = tau_t = torch.zeros((), dtype=self.dtype, device=self.device)
        while t_local < interval and (max_steps is None
                                      or n_steps < int(max_steps)):
            state, lay, npairs, dt, ovf, grd, tau_b, tau_t = self.step(
                state, lay, sd0 + n_steps, interval - t_local, g, mu)
            overflow = torch.logical_or(overflow, ovf)
            guard = torch.logical_or(guard, grd)
            vmax = torch.sqrt(torch.max(state.vx[:nf] ** 2
                                        + state.vy[:nf] ** 2))
            dt_h, *row = torch.stack([dt, npairs.to(self.dtype), vmax,
                                      tau_b, tau_t]).tolist()
            n_syncs += 1
            t_local, t_comp = _t_add(t_local, t_comp, f(dt_h))
            logn = _log_row_update(every, logbuf, logn,
                                   step_base + n_steps + 1,
                                   t_base + t_local, dt_h, *row)
            n_steps += 1
        v_max = torch.sqrt(torch.max(state.vx[:nf] ** 2
                                     + state.vy[:nf] ** 2))
        return IntervalResult(
            state=state, cands=lay, geom=npairs, tau_bottom=tau_b,
            tau_top=tau_t, n_steps=n_steps, overflow=overflow,
            skin_guard=bool(guard), v_max=v_max, n_pairs=npairs,
            t_local=t_local, t_comp=t_comp, n_syncs=n_syncs + 1,
            step_log=logbuf, step_log_n=logn)

    @property
    def _np_dtype(self):
        return np.float32 if self.dtype == torch.float32 else np.float64

    def _group_lengths(self):
        """(steps of a group = rebuild_every, the longest sub-chunk)."""
        rb = max(1, int(self.cfg.rebuild_every))
        return rb, min(rb, int(os.environ.get("SPH_SUB_STEPS", "")
                               or getattr(self.cfg, "sub_steps", 16)))

    def _sub_chunk_run(self, spec, lay, carry, interval, scalars, drift,
                       cache_slots: int = 0, lay_key=None):
        """A group's chunk-kernel runner: on the persistent buffers
        (``fused_cell.BufferedChunkRun``; ``lay_key``: see
        ``ChunkRunner.group``), or with ``chunk_buffers`` off through the
        stateless ``fused_chunk_call`` (``ChunkRun``)."""
        if self.chunk_buffers:
            return self._chunks.group(spec, lay, carry, interval, scalars,
                                      drift, cache_slots, lay_key)
        return ChunkRun(spec, lay, carry, interval, scalars, cache_slots)

    def _run_group(self, run, bounds, interval, t_i, tc_i, sub_len, rb,
                   sub_max):
        """One sub-chunk group of the chunk design (the JAX loop over
        ``sub_cond``/``sub_body``, stepper.py:834-945), which the y-slab
        engine shares. ``run(n_sub, t, t_comp)
        -> (new, steps, t, t_comp, host syncs)`` runs up to n_sub steps
        from its kept state; ``bounds(new)`` gives the (bx, by) drift
        bounds of what it returned (``None``: no skin). After each
        sub-chunk one host sync reads the bounds and the clock in the
        engine's float type: a genuine crossing rolls the sub-chunk back
        (not kept; the next is half as long), the predictive stop (1.5x the
        last increment) and the 3/4-consumed floor end the group before
        one; else ``run.keep()``. A crossing by a one-step sub-chunk
        straight out of a rebuild is no trip: every pair term of a step is
        taken at the positions it starts from, on which the candidates
        were built, so it cannot have missed a pair (the particle shifting
        alone moves a compressed cluster's particles ~0.2 dp apiece in one
        step); it is kept and the group ends on the rebuild its bounds
        call for (the JAX package flags it instead). The group also ends at
        ``rb`` steps or the output point. Returns (t, t_comp, steps,
        rollbacks, the next group's sub-chunk length, host syncs, kept
        one-step crossings)."""
        f = self._np_dtype
        predict = os.environ.get("SPH_DRIFT_PREDICTOR", "1") != "0"
        sxb, syb = f(self.spec.skin_x), f(self.spec.skin_y)
        done_i, nrb, n_syncs, n_kept, slen = 0, 0, 0, 0, sub_len
        soft = False
        bp = (f(0.0), f(0.0))
        while not soft and done_i < rb and t_i < interval:
            n_sub = min(slen, rb - done_i)
            *got, syncs = run(n_sub, t_i, tc_i)
            n_syncs += syncs
            # the one host sync of the sub-chunk
            *vals, steps = run.read(bounds, *got)
            n_syncs += 1
            bx, by, t2, tc2 = (f(v) for v in vals)
            if bounds is not None:
                # a genuine crossing rolls the sub-chunk back; the
                # PREDICTIVE stop (1.5x the last increment) and the
                # 3/4-consumed floor schedule rebuilds before that
                trip = bx > sxb or by > syb
                if predict:
                    soft2 = bool(
                        bx + f(1.5) * (bx - bp[0]) > sxb
                        or by + f(1.5) * (by - bp[1]) > syb
                        or bx > f(0.75) * sxb or by > f(0.75) * syb)
                else:
                    soft2 = bool(trip)
            else:
                soft2, trip = True, False
            one_step = n_sub == 1 and done_i == 0
            recov = bool(trip) and not one_step
            n_kept += int(bool(trip) and one_step)
            if recov:
                slen = max(n_sub // 2, 1)
            else:
                run.keep()
                t_i, tc_i = t2, tc2
                done_i += steps
            soft = soft2 or recov
            bp = (bx, by)
            nrb += int(recov)
        # a trip-free group earns the next group a doubled sub-chunk
        sub_len = min(2 * slen, sub_max) if nrb == 0 else slen
        return t_i, tc_i, done_i, nrb, sub_len, n_syncs, n_kept

    def run_interval(self, state: State, lay, geom, interval_len,
                     g=None, mu=None, max_steps=None, t_local0=None,
                     t_comp0=None, sub_len0=None, t_base=None,
                     step_base=None, steps_done0=None) -> IntervalResult:
        """Run to the next output point (the JAX
        ``PallasCellEngine._run_interval``, stepper.py:732-1056).
        ``max_steps``/``t_local0``/``t_comp0``/``sub_len0``: trajectory-
        preserving step-bounded dispatch; the bound binds at sub-chunk
        GROUP boundaries, so a call may overshoot it by up to
        rebuild_every - 1 steps. With ``step_log_every > 0`` the interval
        runs step by step (``_run_interval_steps``); ``t_base`` and
        ``step_base`` (the interval's start time and global step) number
        its log rows, ``steps_done0`` keeps its rebuild cadence across a
        split dispatch. The chunk path ignores those three."""
        cfg, spec = self.cfg, self.spec
        g = cfg.gravity_g if g is None else g
        mu = cfg.mu if mu is None else mu
        if cfg.step_log_every > 0:
            return self._run_interval_steps(
                state, lay, geom, interval_len, g, mu, max_steps, t_local0,
                t_comp0, t_base, step_base, steps_done0)
        f = self._np_dtype
        scalars = (cfg.rho0, cfg.p0, cfg.c_f, cfg.inv_sigma0,
                   cfg.transport_coeff, g, mu, cfg.wall_visc_factor)
        interval = f(interval_len)
        rb, sub_max = self._group_lengths()
        R, L, n_groups, nyp = pc.plan(spec)

        t_local = f(0.0) if t_local0 is None else f(t_local0)
        t_comp = f(0.0) if t_comp0 is None else f(t_comp0)
        sub_len = (sub_max if sub_len0 is None
                   else min(int(sub_len0), sub_max))
        cores = self._scatter_all(lay, state)
        pidx_e, hidx_e = lay.pidx, lay.hidx
        npairs = torch.as_tensor(geom, device=self.device).to(torch.int32)
        n_steps, n_roll, n_syncs, n_kept = 0, 0, 0, 0
        overflow = lay.overflow
        # with the chunk buffers the rebuilds write persistent layout sets
        # (fused_cell.BufferedRebuild), which also keep the pair count and
        # the overflow; else _do_rebuild and torch ops take them
        sets = (self._rebuilds.interval(spec, cores, self._layout_statics(),
                                        self._shear, self._do_rebuild)
                if self.chunk_buffers else None)
        lay_key = None

        while t_local < interval and (max_steps is None
                                      or n_steps < int(max_steps)):
            st = cores if sets is not None else dict(
                cores, xP=cores["xH"][1:-1, :, 1:-1],
                yP=cores["yH"][1:-1, :, 1:-1],
                cnt=torch.zeros((n_groups, L), dtype=self.dtype,
                                device=self.device))
            drift = (pc.DriftRef(lay.refx_p, lay.refy_p, lay.isf_c)
                     if spec.skin > 0.0 else None)
            run = self._sub_chunk_run(spec, lay, st, interval, scalars,
                                      drift, lay_key=lay_key)

            def bounds(new, lay=lay):
                return pc.pair_drift_bounds(spec, lay, new["xP"], new["yP"])

            (t_local, t_comp, done_i, nrb, sub_len, syncs,
             kept) = self._run_group(
                 run, bounds if spec.skin > 0.0 else None, interval,
                 t_local, t_comp, sub_len, rb, sub_max)
            n_syncs += syncs
            n_kept += kept
            if sets is None:
                st = run.state()
                new_lay, rebuilt = self._do_rebuild(lay, st)
                npairs = torch.round(torch.sum(st["cnt"])).to(torch.int32)
                overflow = torch.logical_or(overflow, new_lay.overflow)
            else:
                carry, st = st, run.cur
                with torch.profiler.record_function(REBUILD_SPAN):
                    new_lay, rebuilt, lay_key = sets(lay, st,
                                                     st is not carry)
            cores = dict(rebuilt, **{k: st[k] for k in (
                "rhoP", "pP", "fxP", "fyP", "fpxP", "fpyP", "volH", "b11H",
                "b12H", "b21H", "b22H")})
            pidx_e, hidx_e = lay.pidx, lay.hidx
            lay = new_lay
            n_steps += done_i
            n_roll += nrb
        if sets is not None and not sets.first:
            npairs, overflow = sets.totals(overflow)

        def tk(core, idx):
            flat = core.reshape(-1)
            return flat[torch.clamp(idx, max=flat.numel() - 1)]

        # xH/yH/vxH/vyH/drP are in the CURRENT layout (the trailing rebuild
        # re-scattered them); the aux cores are in the exec layout
        state = State(
            x=periodic_wrap(spec, tk(cores["xH"], lay.hidx)),
            y=tk(cores["yH"], lay.hidx), vx=tk(cores["vxH"], lay.hidx),
            vy=tk(cores["vyH"], lay.hidx),
            rho=tk(cores["rhoP"], pidx_e), p=tk(cores["pP"], pidx_e),
            drho_dt=tk(cores["drP"], lay.pidx),
            fx=tk(cores["fxP"], pidx_e), fy=tk(cores["fyP"], pidx_e),
            fpx=tk(cores["fpxP"], pidx_e), fpy=tk(cores["fpyP"], pidx_e),
            vol=tk(cores["volH"], hidx_e), b11=tk(cores["b11H"], hidx_e),
            b12=tk(cores["b12H"], hidx_e), b21=tk(cores["b21H"], hidx_e),
            b22=tk(cores["b22H"], hidx_e))
        tau_b, tau_t = self.final_shear(state, lay, mu)
        nf = spec.n_fluid
        v_max = torch.sqrt(torch.max(state.vx[:nf] ** 2
                                     + state.vy[:nf] ** 2))
        if sets is not None:
            lay = sets.detach(lay)
        return IntervalResult(
            state=state, cands=lay, geom=npairs, tau_bottom=tau_b,
            tau_top=tau_t, n_steps=n_steps, overflow=overflow,
            skin_guard=False, v_max=v_max, n_pairs=npairs,
            n_rollbacks=n_roll, t_local=t_local, t_comp=t_comp,
            sub_len=sub_len, n_syncs=n_syncs, n_kept_crossings=n_kept)


def resolve_engine_name(cfg: SPHConfig, scene: Scene = None) -> str:
    """Resolve cfg.engine: "auto" is the fused engine in float32 and the
    cell-layout engine in float64 (the fused kernels are float32, as the
    JAX package's Pallas kernels are; its "auto" sends float64 to
    "cellgrid" too). Unlike the JAX package, "auto" keeps the fused engine
    off the accelerator: its plain twins are the CPU path. "gather" is the
    packed-gather engine, which "auto" never picks."""
    if cfg.engine == "auto":
        return "cellgrid" if cfg.dtype == "float64" else "pallas"
    if cfg.engine in ("pallas", "cellgrid", "gather"):
        return cfg.engine
    raise ValueError(f"unknown engine {cfg.engine!r}")


def make_engine(cfg: SPHConfig, scene: Scene, device):
    """Engine factory honoring cfg.engine on an explicit device."""
    name = resolve_engine_name(cfg, scene)
    if name != cfg.engine:
        cfg = dataclasses.replace(cfg, engine=name)
    if name == "cellgrid":
        return CellEngine(cfg, scene, device)
    if name == "gather":
        return Engine(cfg, scene, device)
    return PallasCellEngine(cfg, scene, device)
