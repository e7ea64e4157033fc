#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``sph_poiseuille_flow_torch``) on one
CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure before the last line:

1. build the hand-written CUDA kernels from ``csrc/`` with nvcc (sm_90a),
   printing the compiler's register/spill report and the card;
2. hold each kernel against its plain PyTorch version on the card, on a
   seeded, jittered state at each grid the main path runs, in each form
   the layout knobs select (recompute "none", the geometry cache that
   "auto" picks there, "partial" with a forced k_cut that splits K, and
   "rows"): (a) ``config.ini`` with the CLI defaults (dp=0.05, K=16, no
   skin): the fused step at dt=0 with no shift and at a real dt, a
   one-step chunk as the interval loop calls it there, a chunk that
   reaches the interval end mid-chunk, the wall shear; (b) the validated
   dp=0.01 channel with the shipping knobs (skin 0.3dp, rebuild_every 128,
   K=14, nx=100): the fused step at both dts, a 16-step chunk, the wall
   shear (its per-slot partials too, and two launches bit-equal). The rows
   kernels are also held to the recompute kernels, which they must equal
   bit for bit on every core; then the recompute, cache and rows forms at
   K=48 on a small dense grid (three cell columns of the tiny box at
   dp=0.025, up to 47 particles a cell, so a window row of 144 candidates
   spans two pieces of the kernels' mask): "none", "full", what "auto"
   picks there and "rows", the step at both dts (pair count exact) and a
   16-step chunk against the plain twin, and rows against none bit for bit
   on every core; at each grid the rows step and chunk launched twice,
   bit-equal;
2b. the probes' kernels at both grids in every form: each sweep prefix
   of the step (``probes.fused_step_sweeps``) equals the kernel's full step
   bit for bit on the cores it writes, leaves the others zero and holds
   its plain prefix; each sweep relaunched over a completed step's buffers
   (``StepBuffers``) leaves every core bit-equal;
   the no-op writes x's first halo row into vol's and nothing else; the
   one-hot expand equals ``repeat`` bit for bit at the JAX test's shape and
   at (b)'s window, and on rows that hold -0, inf and NaN it equals what
   the product is (``probes.expand_onehot_values``; the plain product,
   cuBLAS here, held to the kernel bit for bit on the finite rows and
   recorded on the others). Then the probe entry point (``python -m
   sph_poiseuille_flow_torch.probe``) runs at (b) with a short warm-up in
   the recompute, cache and rows forms, with the launch counts reset
   before each run and its kernels nonzero after it; its JSON gives the
   sweeps', the no-op's and the expand's times, plain times and bounds in
   the kernels line;
2c. the geometry-cache form at both grids and at K=48: the list its sweep 0 writes
   (cache and partial) against the plain list (``fused_cell.
   cache_list_plain``: n and idx exactly, ex, ey, r, dw*m1, dw*mw to
   TOL_STEP); two chunk launches on the same inputs bit-equal; and the
   v_max the chunk carries from each step to the next equal to the max of
   vx^2 + vy^2 over the working velocity cores after that step, exactly;
3. drive the main path through the CLI (``run.main``): (a) ``config.ini``
   as shipped (20 s, "auto", so the geometry cache), which must pass its
   5% L2 gate; (b) the dp=0.01 channel with the shipping knobs for a few
   tenths of a second under "auto" (the cache), ``--geom-cache none`` and
   ``--fused-rows 1``, each of which must stay clean (the simulation
   raises on overflow, on an unrecoverable drift-guard trip and on
   non-finite velocities) with v_max and tau rising; (c) a short
   ``config.ini`` run with ``--step-log-every``, whose log rows are
   printed; (d) a short ``config.ini`` run with ``--dtype float64``,
   which "auto" sends to the cell-layout engine of plain torch ops (no
   kernel may launch); (e) ``--engine gather`` on ``config.ini`` for
   0.1 s in float32 and in float64, the packed-gather engine of plain
   torch ops (``stepper.Engine``; no kernel may launch). The launch
   counts are reset to 0 before each run and each kernel of the form the
   run selects (with the rebuild, ``fused_rebuild``, in the chunk path's
   runs) must be nonzero after it;
3b. the cell-layout engine (``CellEngine``) on the card over 0.05 s of
   ``config.ini``: in float32 against the fused engine (the same steps,
   every field within the tolerances of tests/test_pallas.py:63-72), in
   float64 with clean flags and within 1e-3 of the float32 run in each
   field's own unit (a sanity check, not a parity gate); then the gather
   engine against ``CellEngine``: one step from config.ini's seeded
   jittered state in float32 (tests/test_cellgrid.py:110-117's
   tolerances) and in float64 (every field within 1e-10 of its scale),
   and 0.05 s from rest in float32 (the same steps and pairs, v_max and
   tau within :128-134's tolerances);
4. time each kernel and form against its plain version with CUDA events
   at the (b) shapes and at dp=0.025, and the cache chunk at each lane
   group size of its sweep 0 and of its sweeps 1-3
   (``fused_cell_cuda.CACHE_GROUPS0``, ``CACHE_GROUPS``; the shipped pick
   is ``fused_cell_cuda.cache_groups``), with the sweeps each size runs;
   the recompute form's chunk, step and sweeps at each lane group size
   (``fused_cell_cuda.WIN_GROUPS``; the pick is ``win_groups``); the rows
   form's at the tile ``fused_cell_cuda.rows_tile`` picks (TX columns, G
   lanes per anchor) and its neighbours;
   the wall shear through its wrapper and its kernel alone on its
   persistent buffers; and the no-op on a step's buffers against a row
   ``copy_``, in turns, five times each, with their spread;
5. ``bench_torch.measure(0.025)``, the port's benchmark with its full
   protocol (five warm and five timed 0.5 s intervals), whose JSON is
   printed on a line of its own; it fails on a dirty flag or a malformed
   line. (The three-scale ``python3 bench_torch.py`` is not repeated
   here.)
6. the (g, mu) sweep (``parallel.run_sweep``): (i) through the CLI
   (``--sweep-mus``) at dp=0.01 with the shipping knobs, the eight lanes of
   docs/VALIDATION.md's sweep for 0.1 s: every lane finite with v_max
   rising, the fused kernels of the form "auto" picks launched and no
   other, and lanes 2 (mu = 0.1, the config's) and 6 (mu = 0.25, its
   single run built from ``_lane_cfg``) bit-equal to a single
   ``PallasCellEngine`` run on the card from the same init; (ii) the
   lane-batched path, ``config.ini`` in float64 on ``CellEngine``, four
   lanes for 0.05 s, each within 1e-10 of its own single run, with the ms
   per lane-step of one lane alone and of the four. Its launches count in
   the kernels line.
7. the multi-device path on the one card (``parallel/sharding.py``; every
   slab on cuda:0): (i) the step kernel on every extended slab of one
   (ghost 4), two and four slabs at (b) from the jittered state, as
   ``ShardedPallasEngine._one_step`` builds its inputs (the layout shim,
   the occupancy bound, the whole domain's cache lanes), in every form
   (none, the "auto" pick on the slab's spec, partial, rows) at both dts
   against its plain twin, and the 16-step chunk on the one slab's
   extended slab likewise; then ``ShardedPallasEngine`` with one slab
   (ghost 4, the chunk kernel on its extended slab), two and four slabs
   (the step kernel on each) against the single-device
   ``PallasCellEngine`` at (b) under ``--geom-cache none``, and two slabs
   under ``--fused-rows 1`` against the single-device rows run, for 0.02 s
   from the same init: equal steps, pairs and rollbacks and every
   ``State`` field bit-equal (the largest difference per field printed
   otherwise, and the check fails);
   (ii) ``--mesh 1``, ``--mesh 2`` and ``--mesh 4`` through the CLI at (b)
   under "auto" for 0.3 s: clean flags, tau finite and rising, ``sph_step``
   in the form the slab resolves to launched once per slab per slab step
   and no other step or chunk form, the wall shear once per interval (one
   slab: phase 3's launches), the final state bit-equal to phase 3's
   single-device (b) run (a slab's cache kernels take the whole domain's
   lanes per anchor; a slab that resolves to another kernel form than the
   whole domain fails the check), and ms per step beside that run's;
   (iii) ``--mesh 2 --dtype float64`` (``ShardedCellEngine``) on
   config.ini for 0.05 s within 1e-10 of ``CellEngine`` on the same
   padded grid, no kernel launched.
   Its launches count in the kernels line.
8. where cmake exists: the gather engine's operators in float64 on the
   card against the native C++ oracle (``utils/native_oracle.py``) within
   1e-9 of each output's scale; where it does not, a line says so.
9. the interval path's runner on the card at the benchmark's two grids
   (its configurations ``channel-dp0.01`` and ``channel-dp0.005``, their
   developed state from a fixed seed), with the shipping knobs and with
   the predictor off and a skin of 0.1 dp, which forces rollbacks: (i) a
   group's runner (``fused_cell.ChunkRunner``, ``sph_chunk_run``)
   through five calls, one of them not kept, each bit-equal to
   ``fused_chunk_call`` (``sph_chunk``) and ``pair_drift_bounds`` from the
   state it began in (every core, bx, by, the clock, the steps; one host
   sync a call; the kept state whole after the call not kept); (ii) the
   drift kernel against ``pair_drift_bounds`` bit for bit (or both NaN)
   after a 4-step run: on the layout's references, on references with an
   all-empty 2 x 2 block of cells, and with a NaN velocity in one fluid
   slot (a NaN position); (iii) the engine's interval to 384 steps
   (``max_steps``, bound at a group's end): ``CHUNK_BUFFERS`` one key's
   sets and one run a host sync, ``REBUILD_BUFFERS`` one key's sets and
   one run a group (no plain rebuild), ``LAUNCHES`` the chunk once a host
   sync, the rebuild once a group and the shear once, rollbacks where
   forced (printed); and its ``cands`` and state unchanged after two more
   intervals;
10. the rebuild on persistent layout sets (``fused_cell.BufferedRebuild``,
   ``sph_rebuild``) against ``PallasCellEngine._do_rebuild`` at the
   benchmark's two grids, bit for bit in every array of the layout and
   the carry (``pidx``, ``hidx``, the static cores, ``refx``/``refy``,
   ``occ``, the overflow flag, xH, yH, vxH, vyH, drP), the pair count and
   the interval's overflow: from a 4-step chunk's kept state and from a
   group's carry (nothing kept); with one cell crowded past K (inside the
   bucket of ids the kernel keeps a cell) and one past the bucket, both
   flagging overflow; and again from the crowded layout, whose overflowed
   particles take the sentinel index.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line
(each kernel with its time, its plain version's and the least time the
card could take for the same work) and, last, ``{"ok": true, "device":
{...}}``. Imports nothing of JAX. Outputs go to ``results/chip_smoke/``
(git-ignored).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "results", "chip_smoke")

# The validated dp=0.01 channel (docs/VALIDATION.md) with the shipping
# knobs: 32,400 particles on a 100 x 39 cell grid, K=14.
DP001 = dict(DL=3.0, DH=1.0, dp=0.01, rho0=1.0, mu=0.1, U_bulk=0.666667,
             c_f=15.0, end_time=0.3, output_interval=0.1, sort_interval=100,
             restart_from_file=False, neighbor_skin=0.3 * 0.01,
             rebuild_every=128, cell_capacity=14, lane_pack_nx=100)
# the dp=0.025 shipping grid (4,800 fluid particles, nx=40), for timing
DP0025 = dict(DP001, dp=0.025, neighbor_skin=0.3 * 0.025, lane_pack_nx=40)
# a dense small grid at K=48: the tiny box of the JAX package's Pallas
# tests at dp=0.025 with three cell columns, up to 47 particles a cell
K48 = dict(DL=1.0, DH=0.5, dp=0.025, rho0=1.0, mu=0.1, U_bulk=0.666667,
           c_f=15.0, end_time=0.5, output_interval=0.25, sort_interval=100,
           restart_from_file=False, cell_capacity=48, lane_pack_nx=3)
# the forms held at K=48: the recompute form (its window rows walked in
# pieces), the cache over every rank, what "auto" picks (a cache form) and
# the rows form (its tile's window rows walked in pieces too)
K48_FORMS = (("none", dict(geom_cache="none")),
             ("full", dict(geom_cache="full")), ("cache", {}),
             ("rows", dict(fused_rows="1")))
# the K=48 forms that resolve to a geometry cache
K48_CACHE_FORMS = K48_FORMS[1:3]

# The forms of the step and the chunk, as (label, spec knobs): "cache" is
# what "auto" picks at the grid ("full" at (a) and dp=0.025, "ring" at
# (b), one kernel here); "partial" caches half the anchor ranks.
FORMS = (("none", dict(geom_cache="none")), ("cache", {}),
         ("partial", None), ("rows", dict(fused_rows="1")))

# Kernel vs plain tolerances, as a bound on max|kernel - plain| relative to
# max(1, max|plain|) of each core. Both run the same float32 operations in
# the same order per pair; they differ in the order of the 9K-term window
# sums (a register loop against torch's reduction tree) and in rsqrtf, so
# one step differs by a few ulp of the largest term: 1e-4 leaves two
# decades of room. Sixteen chunk steps compound that through the dt and
# the positions: 1e-3. ``p`` is rho error times p0 = c_f^2 rho0 = 225, so
# its bound is p0 times rho's (absolute). The pair count ``cnt`` is a
# count: one step must match it exactly; over a chunk a pair that drifts
# within an ulp of the cutoff may flip, which moves a lane by 0.5 or 1, so
# a chunk's count gets an absolute bound of 2 pairs per lane.
TOL_STEP = 1e-4
TOL_CHUNK = 1e-3
CNT_CHUNK = 2.0


def _abs_bound(name: str, tol: float, p0: float, cnt: float):
    if name.startswith(("pP", "phH")):
        return tol * p0
    if name.startswith("cnt"):
        return cnt
    return None


def _say(msg: str) -> None:
    print(msg, flush=True)


class Check:
    """Collects kernel-vs-plain errors per kernel."""

    def __init__(self):
        self.max_abs = {}
        # (relative error, core) of the largest relative error since a
        # caller last set it to (0.0, "")
        self.worst = (0.0, "")

    def core(self, kernel: str, name: str, got, ref, tol: float,
             absolute: float = None, record: bool = True,
             say: bool = True) -> float:
        """Hold ``got`` to ``ref``; returns the error relative to the
        core's scale."""
        import torch
        if got.shape != ref.shape:
            raise AssertionError(f"{kernel}/{name}: shape {tuple(got.shape)}"
                                 f" vs plain {tuple(ref.shape)}")
        got = got.double()
        ref = ref.double()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{kernel}/{name}: non-finite output")
        # empty slots of the x cores sit at 1e9: they must pass through
        # exactly, and they are left out of the error scale
        parked = ref.abs() >= 1e8
        if not bool((got[parked] == ref[parked]).all()):
            raise AssertionError(f"{kernel}/{name}: empty slots moved")
        got = torch.where(parked, 0.0, got)
        ref = torch.where(parked, 0.0, ref)
        err = float((got - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        bound = tol * scale if absolute is None else absolute
        rel = err / scale
        self.worst = max(self.worst, (rel, f"{kernel}/{name}"))
        if say:
            _say(f"  {kernel:17s} {name:18s} max_abs={err:.3e} "
                 f"rel={rel:.3e} bound={bound:.1e}")
        if record:
            self.max_abs[kernel] = max(self.max_abs.get(kernel, 0.0), err)
        if not err <= bound:
            raise AssertionError(f"{kernel}/{name}: kernel vs plain error "
                                 f"{err:.3e} above {bound:.1e}")
        return rel


def _grids():
    """(label, config) of each grid the main path runs: (a) config.ini
    with the CLI defaults, (b) the dp=0.01 channel with the shipping
    knobs."""
    from sph_poiseuille_flow_torch.config import derive_config, load_config
    return (("a", load_config(os.path.join(ROOT, "config.ini"))),
            ("b", derive_config(**DP001)))


def _jittered_case(cfg, device):
    """Spec, scene, layout and halo'd state cores of ``cfg``'s channel with
    a seeded jitter (that of the JAX package's Pallas tests)."""
    import numpy as np
    import torch
    from sph_poiseuille_flow_torch.models.poiseuille import build_scene
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    from sph_poiseuille_flow_torch.ops.neighbors import make_grid_spec

    scene = build_scene(cfg)
    spec = make_grid_spec(cfg, scene, lane_pack=True)
    rng = np.random.default_rng(7)
    nf, n = scene.n_fluid, scene.n_total
    x = np.asarray(scene.x, np.float64).copy()
    y = np.asarray(scene.y, np.float64).copy()
    x[:nf] = np.mod(x[:nf] + rng.uniform(-0.35, 0.35, nf) * cfg.dp, cfg.DL)
    y[:nf] += rng.uniform(-0.35, 0.35, nf) * cfg.dp
    vx, vy, dr = (np.zeros(n) for _ in range(3))
    vx[:nf] = rng.normal(0, 0.4, nf)
    vy[:nf] = rng.normal(0, 0.1, nf)
    dr[:nf] = rng.normal(0, 0.05, nf)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    x, y, vx, vy, dr = map(t, (x, y, vx, vy, dr))
    zeros = torch.zeros(n, dtype=torch.float32, device=device)
    lay = fc.build_fused_layout(spec, x, y, t(scene.mass), zeros, zeros,
                                t(scene.y))
    if bool(lay.overflow):
        raise AssertionError(f"jittered dp={cfg.dp} state overflows "
                             f"K={spec.K}")
    cores = dict(
        xH=fc.make_core(spec, lay.pidx, x, fill=fc._BIG_X, xshift=spec.DL),
        yH=fc.make_core(spec, lay.pidx, y),
        vxH=fc.make_core(spec, lay.pidx, vx),
        vyH=fc.make_core(spec, lay.pidx, vy),
        drP=fc.make_plain(spec, lay.pidx, dr))
    return scene, spec, lay, cores, (vx, vy)


def _form_spec(spec, knobs):
    """``spec`` with a form's layout knobs; ``None`` is "partial" with half
    the anchor ranks cached (a split that is not a multiple of a warp)."""
    if knobs is None:
        knobs = dict(geom_cache="partial", geom_kcut=spec.K // 2)
    return dataclasses.replace(spec, **knobs)


# The chunk cases of each grid, as (n_sub, interval, expected steps): the
# interval loop of (a) calls one-step chunks (rebuild_every 1); the clamp
# case ends its interval mid-chunk (dt is about 1e-3 at dp=0.05), so the
# remainder clamp and the active flag are held too; (b) calls 16 steps.
CHUNKS = {"a": ((1, 1.0, 1), (16, 5.5e-3, None)),
          "b": ((16, 1.0, 16),), "k48": ((16, 1.0, 16),)}


def phase_build() -> None:
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda
    t0 = time.perf_counter()
    path = fused_cell_cuda.build(verbose=True)
    _say(f"build: {os.path.relpath(path, ROOT)} in "
         f"{time.perf_counter() - t0:.1f} s")


def _check_form(device, check: Check, label: str, cfg, spec, lay, args,
                dt, flabel: str, chunks=None, cache_slots: int = 0,
                say: bool = True) -> dict:
    """The step at both dts and the grid's chunk cases in one form, each
    against its plain twin in the same form. Returns the kernel outputs.
    ``chunks``: the chunk cases (default ``CHUNKS[label]``);
    ``cache_slots``: the kernels' lane pick (``fused_cell_cuda._const``);
    ``say``: print a line per core."""
    import torch
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc

    sform = fc.step_form(spec, torch.float32)
    cform = fc.chunk_form(spec, torch.float32)
    kstep = fcc.launch_key("fused_step", sform[0])
    kchunk = fcc.launch_key("fused_chunk", cform[0])
    if say:
        _say(f"  form {flabel} ({label}): step {sform} -> {kstep}, chunk "
             f"{cform} -> {kchunk}")
    if flabel == "partial" and not 0 < cform[1] < spec.K:
        raise AssertionError(f"partial k_cut {cform[1]} does not split "
                             f"K={spec.K}")
    outs = {}
    for dtv, tc in ((0.0, 0.0), (dt, cfg.transport_coeff)):
        sc = (cfg.rho0, cfg.p0, cfg.c_f, cfg.inv_sigma0, tc, cfg.gravity_g,
              cfg.mu, cfg.wall_visc_factor)
        got = fc.fused_step_cores(spec, lay, *args, dtv, *sc,
                                  cache_slots=cache_slots)
        ref = fc.fused_step_cores_plain(spec, lay, *args, dtv, *sc)
        torch.cuda.synchronize()
        tag = f"{label}/{flabel}:" + ("" if tc else "@0:")
        for k in sorted(ref):
            check.core(kstep, tag + k, got[k], ref[k], TOL_STEP,
                       _abs_bound(k, TOL_STEP, cfg.p0, 0.0), say=say)
        outs[f"step{'' if tc else '@0'}"] = got

    sc = (cfg.rho0, cfg.p0, cfg.c_f, cfg.inv_sigma0, cfg.transport_coeff,
          cfg.gravity_g, cfg.mu, cfg.wall_visc_factor)
    for n_sub, interval, want in (CHUNKS[label] if chunks is None
                                  else chunks):
        got = fc.fused_chunk_call(spec, lay, *args, 0.0, 0.0, interval,
                                  n_sub, *sc, cache_slots=cache_slots)
        ref = fc.fused_chunk_call_plain(spec, lay, *args, 0.0, 0.0, interval,
                                        n_sub, *sc)
        torch.cuda.synchronize()
        gs, rs = int(got[2]), int(ref[2])
        if gs != rs or (want is not None and gs != want):
            raise AssertionError(f"{kchunk} ({label}, n_sub={n_sub}): "
                                 f"steps {gs} / plain {rs}, expected "
                                 f"{want if want is not None else rs}")
        if want is None:
            # the interval ends inside the chunk: the clamp lands on it
            if not 1 < gs < n_sub or float(got[3]) != float(ref[3]):
                raise AssertionError(
                    f"{kchunk} ({label}): {gs} steps, t={float(got[3])!r}"
                    f" / plain {float(ref[3])!r} at interval {interval}")
        tol = TOL_STEP if n_sub == 1 else TOL_CHUNK
        cnt = 0.0 if n_sub == 1 else CNT_CHUNK
        tag = f"{label}/{flabel}{n_sub}:"
        for part in (0, 1):
            for k in sorted(ref[part]):
                check.core(kchunk, tag + k, got[part][k], ref[part][k], tol,
                           _abs_bound(k, tol, cfg.p0, cnt), say=say)
        for i, k in ((3, "t"), (4, "t_comp")):
            check.core(kchunk, tag + k, got[i].reshape(1),
                       ref[i].reshape(1), tol * 1e-3, say=say)
        _say(f"  {kchunk} ({label}) n_sub={n_sub} interval={interval} "
             f"steps={gs} t={float(got[3]):.9e} plain t={float(ref[3]):.9e}")
        outs[f"chunk{n_sub}"] = {**got[0], **{f"aux:{k}": v
                                              for k, v in got[1].items()}}
    return outs


def _rows_vs_none(check: Check, label: str, cfg, outs: dict) -> None:
    """The rows kernels walk the recompute form's window in its order with
    its arithmetic from their staged tile, and the recompute kernels add
    each anchor's terms in that order: every core must be bit-equal."""
    import torch
    n_eq = n_all = 0
    for case, got in outs["rows"].items():
        step = case.startswith("step")
        tol = TOL_STEP if step else TOL_CHUNK
        for k, v in got.items():
            n_all += 1
            n_eq += int(torch.equal(v, outs["none"][case][k]))
            check.core("fused_step_rows" if step else "fused_chunk_rows",
                       f"{label}/rows-none:{case}:{k}", v,
                       outs["none"][case][k], tol,
                       _abs_bound(k.split(":")[-1], tol, cfg.p0,
                                  0.0 if step else CNT_CHUNK),
                       record=False)
    _say(f"  rows vs recompute kernels ({label}): {n_eq} of {n_all} cores "
         "bit-equal")
    if n_eq != n_all:
        raise AssertionError(f"rows vs recompute kernels ({label}): only "
                             f"{n_eq} of {n_all} cores bit-equal")


def _rows_twice(label: str, cfg, spec, lay, args, dt, outs: dict) -> None:
    """The rows step and the grid's last chunk case launched again on the
    same inputs: bit-equal to the first launches (``outs["rows"]``)."""
    import torch
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    rspec = _form_spec(spec, dict(fused_rows="1"))
    sc = (cfg.rho0, cfg.p0, cfg.c_f, cfg.inv_sigma0, cfg.transport_coeff,
          cfg.gravity_g, cfg.mu, cfg.wall_visc_factor)
    step = fc.fused_step_cores(rspec, lay, *args, dt, *sc)
    n_sub, interval, _ = CHUNKS[label][-1]
    got = fc.fused_chunk_call(rspec, lay, *args, 0.0, 0.0, interval, n_sub,
                              *sc)
    torch.cuda.synchronize()
    chunk = {**got[0], **{f"aux:{k}": v for k, v in got[1].items()}}
    _equal(f"rows step ({label}) launched twice", step, outs["rows"]["step"],
           step)
    _equal(f"rows chunk ({label}) launched twice", chunk,
           outs["rows"][f"chunk{n_sub}"], chunk)
    _say(f"  rows kernels ({label}): two launches bit-equal (step, "
         f"{n_sub}-step chunk)")


def phase_kernels(device, check: Check, label: str, cfg) -> dict:
    import torch
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc
    from sph_poiseuille_flow_torch.ops.integration import verlet_dt

    scene, spec, lay, c, (vx, vy) = _jittered_case(cfg, device)
    R, L, n_groups, nyp = fc.plan(spec)
    _say(f"kernels ({label}): dp={cfg.dp} grid nx={spec.nx} ny={spec.ny} "
         f"K={spec.K} R={R} n_groups={n_groups}, halo'd core "
         f"{(nyp + 2, spec.K, spec.nx + 2)}, {scene.n_total} particles")
    nf = scene.n_fluid
    dt = verlet_dt(vx[:nf], vy[:nf], cfg.c_f, cfg.h, cfg.nu, cfg.gravity_g,
                   1.0)
    args = (c["xH"], c["yH"], c["vxH"], c["vyH"], c["drP"])
    outs = {flabel: _check_form(device, check, label, cfg,
                                _form_spec(spec, knobs), lay, args, dt,
                                flabel)
            for flabel, knobs in FORMS}

    _rows_vs_none(check, label, cfg, outs)
    _rows_twice(label, cfg, spec, lay, args, dt, outs)

    # the wall shear on the stepped cores, as the engine calls it
    sc = (cfg.rho0, cfg.p0, cfg.c_f, cfg.inv_sigma0, cfg.transport_coeff,
          cfg.gravity_g, cfg.mu, cfg.wall_visc_factor)
    o = fc.fused_step_cores_plain(spec, lay, *args, dt, *sc)
    sh = (c["xH"], c["yH"], o["vxH"], o["volH"], o["b11H"], o["b12H"],
          o["b21H"], o["b22H"], cfg.mu, cfg.wall_visc_factor)
    got = fc.fused_wall_shear_cores(spec, lay, *sh)
    ref = fc.fused_wall_shear_cores_plain(spec, lay, *sh)
    for k, gv, rv in (("tau_b", got[0], ref[0]), ("tau_t", got[1], ref[1])):
        check.core("fused_wall_shear", f"{label}:{k}", gv.reshape(1),
                   rv.reshape(1), TOL_STEP)
    _say(f"  tau_bottom ({label})={float(got[0]):.6f} "
         f"plain={float(ref[0]):.6f}")
    # the per-slot partials, slot by slot, and two launches bit-equal
    tbt = fcc.wall_shear(spec, R, lay, *sh).clone()
    again = fcc.wall_shear(spec, R, lay, *sh).clone()
    ref = fc.fused_wall_shear_slots_plain(spec, lay, *sh)
    check.core("fused_wall_shear", f"{label}:slots", tbt, ref, TOL_STEP)
    if not torch.equal(tbt, again):
        raise AssertionError(f"fused_wall_shear ({label}): two launches "
                             "differ")
    # the row list against the JAX kernel's window over every row: the
    # rows left out hold exactly +0 there, the listed rows match the kernel
    full = fc.fused_wall_shear_slots_plain(spec, lay, *sh, every_row=True)
    rows = lay.shear_rows.to(torch.int64)
    out_rows = torch.ones(nyp, dtype=torch.bool, device=device)
    out_rows[rows] = False
    if full[:, out_rows].count_nonzero():
        raise AssertionError(f"fused_wall_shear ({label}): a row left out "
                             "of the row list has a nonzero partial")
    check.core("fused_wall_shear", f"{label}:slots_every_row",
               tbt[:, rows], full[:, rows], TOL_STEP)
    _say(f"  fused_wall_shear ({label}): {rows.numel()} of {nyp} rows "
         f"launched, {int((tbt != 0).sum())} nonzero partials "
         f"({int((full != 0).sum())} over every row); two launches "
         "bit-equal")
    return dict(cfg=cfg, spec=spec, lay=lay, args=args, sc=sc, dt=dt, sh=sh)


def phase_k48(device, check: Check) -> dict:
    """The forms of K48_FORMS on the dense K=48 grid: the step at both dts
    and a 16-step chunk against the plain twin, and the rows kernels
    against the recompute kernels, bit for bit on every core."""
    import torch
    from sph_poiseuille_flow_torch.config import derive_config
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    from sph_poiseuille_flow_torch.ops.integration import verlet_dt

    cfg = derive_config(**K48)
    scene, spec, lay, c, (vx, vy) = _jittered_case(cfg, device)
    occ = int(lay.occ.max())
    _say(f"kernels (k48): dp={cfg.dp} grid nx={spec.nx} ny={spec.ny} "
         f"K={spec.K}, max occupancy {occ}, {scene.n_total} particles")
    if occ <= 32:
        raise AssertionError(f"k48: occupancy {occ} leaves the second piece "
                             "of a window row empty")
    nf = scene.n_fluid
    dt = verlet_dt(vx[:nf], vy[:nf], cfg.c_f, cfg.h, cfg.nu, cfg.gravity_g,
                   1.0)
    args = (c["xH"], c["yH"], c["vxH"], c["vyH"], c["drP"])
    outs = {}
    for flabel, knobs in K48_FORMS:
        fspec = _form_spec(spec, knobs)
        form = fc.chunk_form(fspec, torch.float32)[0]
        if (form != flabel if flabel in ("none", "rows")
                else form in ("none", "rows")):
            raise AssertionError(f"k48 ({flabel}): resolves to {form}")
        outs[flabel] = _check_form(device, check, "k48", cfg, fspec, lay,
                                   args, dt, flabel)
    _rows_vs_none(check, "k48", cfg, outs)
    _rows_twice("k48", cfg, spec, lay, args, dt, outs)
    sc = (cfg.rho0, cfg.p0, cfg.c_f, cfg.inv_sigma0, cfg.transport_coeff,
          cfg.gravity_g, cfg.mu, cfg.wall_visc_factor)
    return dict(cfg=cfg, spec=spec, lay=lay, args=args, sc=sc, dt=dt)


def _equal(what: str, got: dict, ref: dict, keys) -> None:
    import torch
    bad = [k for k in keys if not torch.equal(got[k], ref[k])]
    if bad:
        raise AssertionError(f"{what}: {bad} not bit-equal")


def phase_probes(device, check: Check, label: str, k: dict) -> None:
    """The probes' kernels at one grid, in every form: the sweep prefixes
    against the kernel's full step (bit for bit on the cores they write,
    zero elsewhere) and against the plain prefixes, each single sweep
    relaunched over a completed step's buffers (bit-equal), the no-op; at
    (b) also the expand.
    Their times come from the probe runs (``phase_probe_cli``)."""
    import torch
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc
    from sph_poiseuille_flow_torch.ops import probes

    cfg, spec, lay, args, sc, dt = (k[n] for n in ("cfg", "spec", "lay",
                                                   "args", "sc", "dt"))
    R = fc.plan(spec)[0]
    for flabel, knobs in FORMS:
        fspec = _form_spec(spec, knobs)
        form = fc.step_form(fspec, torch.float32)
        key = fcc.launch_key("fused_step_sweeps", form[0])
        tag = f"{label}/{flabel}"
        full = fc.fused_step_cores(fspec, lay, *args, dt, *sc)
        worst = 0.0
        for m in range(1, 5):
            got = probes.fused_step_sweeps(fspec, lay, *args, dt, *sc,
                                           first=0, count=m)
            ref = probes.fused_step_sweeps_plain(fspec, lay, *args, dt, *sc,
                                                 first=0, count=m)
            torch.cuda.synchronize()
            written = {c for s in range(m) for c in probes.SWEEP_WRITES[s]}
            _equal(f"{key} ({tag}) prefix {m} vs the step", got, full,
                   written & set(full))
            for name, v in got.items():
                if name not in written:
                    if bool(v.any()):
                        raise AssertionError(f"{key} ({tag}) prefix {m} "
                                             f"wrote {name}")
                    continue
                worst = max(worst, check.core(
                    key, f"{tag}/p{m}:{name}", v, ref[name], TOL_STEP,
                    _abs_bound(name, TOL_STEP, cfg.p0, 0.0), say=False))

        # each sweep again over the completed step's buffers
        b = fcc.StepBuffers(fspec, R, lay, *args, dt, sc, *form)
        b.sweeps(0, 4)
        torch.cuda.synchronize()
        done = {c: v.clone() for c, v in b.outputs().items()}
        _equal(f"{key} ({tag}) buffers vs the step",
               dict(done, cnt=fc._cnt_rows(fspec, done["cnt"])), full, full)
        for s in range(4):
            b.sweeps(s, 1)
            torch.cuda.synchronize()
            _equal(f"{key} ({tag}) sweep {s} relaunched", b.outputs(), done,
                   done)

        o = probes.fused_noop(fspec, lay, *args, dt, *sc)
        torch.cuda.synchronize()
        x0 = args[0][0, 0, :]
        if not torch.equal(o["volH"][0, 0, :], x0):
            raise AssertionError(f"fused_noop ({tag}): vol[0, 0, :] != "
                                 "x[0, 0, :]")
        o["volH"][0, 0, :] = 0.0
        if any(bool(v.any()) for v in o.values()):
            raise AssertionError(f"fused_noop ({tag}) wrote past its row")
        check.max_abs["fused_noop"] = 0.0
        _say(f"probes ({tag}) {key}: prefixes 1-4 bit-equal to the step on "
             f"their cores and zero elsewhere, vs plain max rel "
             f"{worst:.2e}; sweeps 0-3 relaunched bit-equal; no-op exact")
    if label == "b":
        phase_expand(device, check, spec)


def phase_cache(device, check: Check, label: str, k: dict,
                forms=FORMS[1:3]) -> None:
    """The geometry-cache form at one grid: the list sweep 0 writes, in
    the cache and the partial form, against the plain list (n and idx
    exactly, the floats to TOL_STEP); the grid's last chunk case launched
    twice on the same inputs, bit-equal; and that chunk cut after m = 0,
    1, .. n_sub steps, whose v_max^2 (the value the next step's control
    reads) must equal the max of vx^2 + vy^2 over the working velocity
    cores it returns, exactly."""
    import torch
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc

    cfg, spec, lay, args, sc, dt = (k[n] for n in ("cfg", "spec", "lay",
                                                   "args", "sc", "dt"))
    R = fc.plan(spec)[0]
    for flabel, knobs in forms:
        fspec = _form_spec(spec, knobs)
        form = fc.step_form(fspec, torch.float32)
        b = fcc.StepBuffers(fspec, R, lay, *args, dt, sc, *form)
        b.sweeps(0, 1)
        got = b.cache_list()
        ref = fc.cache_list_plain(fspec, lay, args[0], args[1], form[1])
        torch.cuda.synchronize()
        tag = f"{label}/{flabel}/list"
        if not torch.equal(got["n"], ref["n"]):
            bad = int((got["n"] != ref["n"]).sum())
            raise AssertionError(f"{tag}: n differs in {bad} slots")
        used = (torch.arange(ref["idx"].shape[1], device=device)[None, :]
                < ref["n"][:, None])
        if not torch.equal(torch.where(used, got["idx"], -1), ref["idx"]):
            raise AssertionError(f"{tag}: idx differs from the plain list")
        for name in ("ex", "ey", "r", "c1", "cw"):
            check.core("fused_step_cache", f"{tag}:{name}",
                       torch.where(used, got[name], 0.0), ref[name],
                       TOL_STEP)
        _say(f"cache list ({tag}) {form}: n and idx exact over "
             f"{ref['n'].numel()} cached slots, {int(ref['n'].sum())} "
             f"pairs, max n {int(ref['n'].max())}")

    form = fc.chunk_form(spec, torch.float32)
    host = torch.empty(())
    dt_visc, dt_body = fc.chunk_dt_limits(spec, cfg.rho0, float(cfg.gravity_g),
                                          float(cfg.mu), host)
    n_sub, interval, _ = CHUNKS[label][-1]

    def chunk(m):
        o = fcc.chunk(spec, R, lay, *args, 0.0, 0.0, interval, m, dt_visc,
                      dt_body, sc, *form)
        torch.cuda.synchronize()
        return o

    one, two = chunk(n_sub), chunk(n_sub)
    for (i, a), b in zip(enumerate(one), two):
        pairs = (zip(a, b) if i == 0 else
                 ((a[n], b[n]) for n in a) if i == 1 else ((a, b),))
        if not all(torch.equal(x, y) for x, y in pairs):
            raise AssertionError(f"fused_chunk_cache ({label}): two launches"
                                 f" on the same inputs differ (part {i})")
    steps = int(one[2])
    for m in range(n_sub + 1):
        st, _, _, _, _, vmax2 = chunk(m)
        vx, vy = st[2], st[3]
        want = torch.max(vx * vx + vy * vy)
        if not torch.equal(vmax2, want):
            raise AssertionError(f"fused_chunk_cache ({label}) after {m} "
                                 f"steps: v_max^2 {float(vmax2)!r}, the "
                                 f"cores' max {float(want)!r}")
    _say(f"cache chunk ({label}) {form}: two launches bit-equal ({steps} "
         f"of n_sub={n_sub} steps); v_max^2 exact after each of 0..{n_sub} "
         f"steps, last {float(vmax2):.9e}")


def phase_expand(device, check: Check, spec) -> None:
    """The one-hot expand bit-equal to ``repeat`` at the JAX test's shape
    (K=4, bx=8) and at the (b) window's (9K, nx), on values that need more
    than 10 mantissa bits; what TF32 would make of the product is printed
    as a record."""
    import numpy as np
    import torch
    from sph_poiseuille_flow_torch.ops import probes

    for K, bx in ((4, 8), (spec.K, spec.nx)):
        rng = np.random.default_rng(3)
        rows = 9 * K
        v = np.where(rng.random((rows, bx)) < 0.5,
                     rng.integers(1, 8192, (rows, bx)) * 2 + 1,
                     rng.random((rows, bx)) * 3.0).astype(np.float32)
        v = torch.as_tensor(v, device=device)
        want = v.repeat(1, K)
        got = probes.expand_onehot(v, K)
        ref = probes.expand_onehot_plain(v, K)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(ref, want)):
            raise AssertionError(f"expand_onehot ({rows}, {bx}) x{K}: not "
                                 "v tiled exactly")
        E = probes.onehot_tiling(bx, K, v)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            n_tf32 = int((torch.matmul(v, E) != want).sum())
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        _say(f"expand_onehot ({rows}, {bx}) x{K}: bit-equal to repeat; "
             f"torch.matmul under TF32 gets {n_tf32} of {want.numel()} "
             "elements wrong (a record)")
        _expand_special(v, K)
    check.max_abs["expand_onehot"] = 0.0


def _expand_special(v, K: int) -> None:
    """The expand on rows of ``v`` made to hold -0 (one row all negative
    with a -0, one with a -0 among positives), an inf beside a NaN, a lone
    -inf and a lone NaN: bit for bit what the product is
    (``probes.expand_onehot_values``: NaN where it is NaN, the bits
    elsewhere); the plain product (cuBLAS) held to the kernel bit for bit
    on the finite rows without a -0, and where it differs on the others,
    recorded."""
    import torch
    from sph_poiseuille_flow_torch.ops import probes

    v = v.clone()
    bx = v.shape[1]
    v[1] = -v[1].abs()
    v[1, 0] = -0.0
    v[2, bx // 2] = -0.0
    v[3, 1] = float("inf")
    v[3, 2 % bx] = float("nan")
    v[4, 0] = -float("inf")
    v[5, bx - 1] = float("nan")
    got = probes.expand_onehot(v, K)
    ref = probes.expand_onehot_plain(v, K)
    want = probes.expand_onehot_values(v, K)
    torch.cuda.synchronize()

    def same(a, b):
        nan = torch.isnan(b)
        return (torch.equal(torch.isnan(a), nan)
                and torch.equal(a[~nan].view(torch.int32),
                                b[~nan].view(torch.int32)))

    if not same(got, want):
        raise AssertionError(f"expand_onehot ({v.shape[0]}, {bx}) x{K}: "
                             "not the product's values on -0/inf/NaN rows")
    # finite rows without a -0: the rows a sum's order cannot change
    negz = ((v == 0) & torch.signbit(v)).any(dim=1)
    finite = torch.isfinite(v).all(dim=1) & ~negz
    if not torch.equal(got[finite].view(torch.int32),
                       ref[finite].view(torch.int32)):
        raise AssertionError(f"expand_onehot ({v.shape[0]}, {bx}) x{K}: "
                             "finite rows differ from the plain product")
    rows = [r for r in range(v.shape[0]) if not same(ref[r:r + 1],
                                                      want[r:r + 1])]
    _say(f"expand_onehot ({v.shape[0]}, {bx}) x{K} with -0/inf/NaN rows: "
         f"the product's values bit for bit (-0 -> +0, NaN where a "
         f"non-finite entry meets); the plain product (cuBLAS) differs from "
         f"them in rows {rows} (a record)")


# the probe runs at (b): (name, flags, the LAUNCHES key of its sweeps)
PROBE_RUNS = (("none", [], "fused_step_sweeps"),
              ("cache", ["--geom-cache", "auto"], "fused_step_sweeps_cache"),
              ("rows", ["--fused-rows", "1"], "fused_step_sweeps_rows"))


def phase_probe_cli() -> tuple:
    """The probe entry point at (b) with a short warm-up in the default
    form, under the cache and under the rows form: the counts are reset
    before each run and its kernels must have launched in it. Returns
    ({run: launch counts}, {run: the probe's JSON}), whose times, plain
    times and bounds make the probes' entries of the kernels line."""
    from sph_poiseuille_flow_torch import probe
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc

    counts, results = {}, {}
    for name, flags, key in PROBE_RUNS:
        buf = io.StringIO()
        fcc.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            rc = probe.main(["0.01", "0.1", "14", "0.3", "--lane-pack-nx",
                             "100", "--rebuild-every", "128", "--n", "20"]
                            + flags)
        counts[name] = dict(fcc.LAUNCHES)
        out = buf.getvalue().splitlines()
        with open(os.path.join(OUT, f"probe_{name}.txt"), "w") as f:
            f.write(buf.getvalue())
        for ln in out:
            if ln.startswith(("spec:", "developed", "full", "sweep",
                              "sum", "no-op", "one-hot")):
                _say(f"  {ln}")
        _say(out[-1])
        res = results[name] = json.loads(out[-1])["probe"]
        if rc != 0 or res["device"] != "cuda":
            raise AssertionError(f"probe ({name}): rc {rc}, {res['device']}")
        for kk in (key, "fused_noop", "expand_onehot"):
            if counts[name][kk] <= 0:
                raise AssertionError(f"probe ({name}): kernel {kk} was never "
                                     "launched")
        _say(f"probe ({name}) launches={counts[name]}")
    return counts, results


def _probe_times(results: dict) -> dict:
    """{kernels-line name: (ms, plain_ms, bound_ms, bound_by, library_ms)}
    from the probe runs' JSON: each sweep from the run of its form (device
    time relaunched on persistent buffers), the no-op (on buffers) and the
    expand from the default form's run."""
    out = {}
    for name, _, key in PROBE_RUNS:
        r = results[name]
        for s in range(4):
            out[f"{key}:sweep{s}"] = (
                r["ms"][f"sweep{s}"],
                r["ms"][f"plain_sweep{s}"], r["bound_ms"][f"sweep{s}"],
                r["bound_by"][f"sweep{s}"], None)
    r = results[PROBE_RUNS[0][0]]
    for name, kind, ms in (("fused_noop", "noop", "noop_bufs"),
                           ("expand_onehot", "expand", "expand")):
        out[name] = (r["ms"][ms], r["ms"][f"plain_{kind}"],
                     r["bound_ms"][kind], r["bound_by"][kind],
                     r["ms"][f"library_{kind}"])
    return out


def _run_cli(name: str, ini_text, extra, capture: bool = False) -> dict:
    """One in-process CLI run; returns the result dict of the run (with
    its standard output under "stdout" when ``capture``)."""
    import torch
    from sph_poiseuille_flow_torch import run as cli
    from sph_poiseuille_flow_torch import simulation

    base = os.path.join(OUT, name)
    os.makedirs(base, exist_ok=True)
    if ini_text is None:
        ini = os.path.join(ROOT, "config.ini")
    else:
        ini = os.path.join(base, "config.ini")
        with open(ini, "w") as f:
            f.write(ini_text)
    for k in ("SPH_CONFIG_OVERRIDE", "SPH_RESTART_PATH_OVERRIDE",
              "SPH_RESULT_PNG_OVERRIDE", "SPH_PROFILE_PNG_OVERRIDE",
              "SPH_POSTPROCESS_MAT_OVERRIDE"):
        os.environ.pop(k, None)
    captured = {}
    orig_run = simulation.Simulation.run

    def run_and_keep(self):
        captured["engine"] = type(self.engine).__name__
        captured["result"] = orig_run(self)
        return captured["result"]

    simulation.Simulation.run = run_and_keep
    buf = io.StringIO()
    try:
        t0 = time.perf_counter()
        with (contextlib.redirect_stdout(buf) if capture
              else contextlib.nullcontext()):
            rc = cli.main(["--config", ini, "--base-dir", base,
                           "--device", "cuda"] + list(extra))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        simulation.Simulation.run = orig_run
    res = captured["result"]
    res["engine"] = captured["engine"]
    res["rc"] = rc
    res["wall_total"] = wall
    res["stdout"] = buf.getvalue()
    return res


# the dp=0.01 runs of phase 3: (name, CLI flags, LAUNCHES suffix of the
# form the run selects)
RUNS_B = (("b", [], "_cache"), ("b_none", ["--geom-cache", "none"], ""),
          ("b_rows", ["--fused-rows", "1"], "_rows"))


def _launched(run: str, counts: dict, want: set) -> None:
    """Each kernel in ``want`` ran in the run, and no other form of the
    step or the chunk did: no form gives way to another. A run of the
    chunk path also launches the rebuild between its groups
    (``fused_rebuild``); the per-step path does not."""
    for k, v in counts.items():
        if k in want and v <= 0:
            raise AssertionError(f"main ({run}): kernel {k} was never "
                                 "launched")
        if k not in want and v != 0:
            raise AssertionError(f"main ({run}): kernel {k} launched {v} "
                                 "times, outside the run's form")


def phase_main() -> dict:
    import math
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc

    counts = {}
    # (a) config.ini as shipped (20 s), through the CLI with its defaults
    fcc.reset_launch_counts()
    ra = _run_cli("a_config_ini", None, [])
    counts["a"] = dict(fcc.LAUNCHES)
    _say(f"main (a) config.ini: rc={ra['rc']} L2={100 * ra['L2_error']:.4f}% "
         f"(recompute form: 1.7366%, PERF.md) steps={ra['step']} "
         f"t={ra['t']:.3f} tau_bottom={ra['tau_bottom']:.5f} "
         f"psteps/s={ra['particle_steps_per_sec']:.4e} "
         f"host_syncs={ra['host_syncs']} launches={counts['a']}")
    if ra["rc"] != 0 or not ra["passed"]:
        raise AssertionError(f"(a) config.ini: L2 {ra['L2_error']:.4%} "
                             "did not pass the 5% gate")
    if not math.isfinite(ra["tau_bottom"]):
        raise AssertionError("(a) config.ini: non-finite tau")
    _launched("a", counts["a"], {"fused_step_cache", "fused_chunk_cache",
                                 "fused_wall_shear", "fused_rebuild"})

    # (b) the dp=0.01 channel with the shipping knobs, a few tenths of s,
    # in each form a user can select
    ini = ("[physical]\nDL = 3.0\nDH = 1.0\ndp = 0.01\nrho0 = 1.0\n"
           "mu = 0.1\nU_bulk = 0.666667\nc_f = 15.0\n"
           f"[simulation]\nend_time = {DP001['end_time']}\n"
           f"output_interval = {DP001['output_interval']}\n"
           "sort_interval = 100\nrestart_from_file = 0\n")
    from sph_poiseuille_flow_torch.config import derive_config
    tau_target = derive_config(**DP001).tau_target
    runs = {"a": ra}
    for name, flags, suffix in RUNS_B:
        fcc.reset_launch_counts()
        rb = _run_cli(f"{name}_dp001", ini,
                      ["--neighbor-skin", str(DP001["neighbor_skin"]),
                       "--rebuild-every", "128", "--cell-capacity", "14",
                       "--lane-pack-nx", "100"] + flags)
        counts[name] = dict(fcc.LAUNCHES)
        runs[name] = rb
        taus = [tb for _, tb, _ in rb["tau_history"]]
        vmaxs = rb["v_max_history"]
        st = rb["final_state"]
        import torch
        finite = all(bool(torch.isfinite(getattr(st, f)).all())
                     for f in st._fields)
        _say(f"main ({name}) dp=0.01 {' '.join(flags) or 'auto'}: "
             f"steps={rb['step']} t={rb['t']:.3f} "
             f"tau_bottom={['%.5f' % v for v in taus]} "
             f"v_max={['%.4f' % v for v in vmaxs]} "
             f"psteps/s={rb['particle_steps_per_sec']:.4e} "
             f"host_syncs={rb['host_syncs']} launches={counts[name]}")
        if not finite or not all(math.isfinite(v) for v in taus):
            raise AssertionError(f"({name}) dp=0.01: non-finite state or tau")
        if not all(b > a for a, b in zip(taus, taus[1:])) or taus[0] <= 0:
            raise AssertionError(f"({name}) dp=0.01: tau not rising: {taus}")
        if not all(b > a for a, b in zip(vmaxs, vmaxs[1:])) or vmaxs[0] <= 0:
            raise AssertionError(f"({name}) dp=0.01: v_max not rising: "
                                 f"{vmaxs}")
        if not taus[-1] < 1.2 * tau_target:
            raise AssertionError(f"({name}) dp=0.01: tau {taus[-1]} "
                                 f"overshoots tau_target {tau_target}")
        _launched(name, counts[name], {"fused_step" + suffix,
                                       "fused_chunk" + suffix,
                                       "fused_wall_shear", "fused_rebuild"})

    # (c) the per-step log path: config.ini for 0.05 s, a row every 10
    fcc.reset_launch_counts()
    rc = _run_cli("c_step_log", None,
                  ["--step-log-every", "10", "--set",
                   "simulation.end_time=0.05", "--set",
                   "simulation.output_interval=0.025"], capture=True)
    counts["c"] = dict(fcc.LAUNCHES)
    runs["c"] = rc
    pat = re.compile(r"step=(\d+), t=\d+\.\d{6}/\d+\.\d{6}, "
                     r"dt=\d\.\d{4}e[+-]\d+, pairs=\d+, vmax=\d+\.\d{4}$")
    lines = rc["stdout"].splitlines()
    rows = [ln for ln in lines if pat.match(ln)]
    for i, ln in enumerate(lines):
        if pat.match(ln):
            _say(f"  {ln}")
            _say(f"  {lines[i + 1]}")
    steps = [int(pat.match(ln).group(1)) for ln in rows]
    _say(f"main (c) step log: {len(rows)} rows over {rc['step']} steps, "
         f"host_syncs={rc['host_syncs']} launches={counts['c']}")
    if (len(rows) < 2 or any(s % 10 for s in steps)
            or steps != sorted(set(steps))
            or not all(lines[i + 1].startswith("  [thick-wall-noslip]")
                       for i, ln in enumerate(lines) if pat.match(ln))):
        raise AssertionError(f"(c) step log rows malformed: {rows}")
    _launched("c", counts["c"], {"fused_step_cache", "fused_wall_shear"})

    # (d) float64: "auto" sends it to the cell-layout engine, plain torch
    # ops on the card, so no kernel of the port launches
    fcc.reset_launch_counts()
    rd = _run_cli("d_float64", None,
                  ["--dtype", "float64", "--set", "simulation.end_time=0.1",
                   "--set", "simulation.output_interval=0.05"])
    counts["d"] = dict(fcc.LAUNCHES)
    runs["d"] = rd
    st = rd["final_state"]
    import torch
    _say(f"main (d) config.ini float64: steps={rd['step']} t={rd['t']:.3f} "
         f"tau_bottom={rd['tau_bottom']:.6f} dtype={st.x.dtype} "
         f"device={st.x.device} psteps/s={rd['particle_steps_per_sec']:.4e} "
         f"host_syncs={rd['host_syncs']} launches={counts['d']}")
    if (st.x.dtype != torch.float64 or st.x.device.type != "cuda"
            or not all(bool(torch.isfinite(getattr(st, f)).all())
                       for f in st._fields)
            or not math.isfinite(rd["tau_bottom"]) or rd["step"] <= 0):
        raise AssertionError("(d) float64: not a finite float64 run on the "
                             "card")
    _launched("d", counts["d"], set())

    # (e) the packed-gather engine, plain torch ops on the card, in float32
    # and float64: no kernel of the port launches
    for name, dtype in (("e", "float32"), ("e64", "float64")):
        fcc.reset_launch_counts()
        re_ = _run_cli(f"{name}_gather", None,
                       ["--engine", "gather", "--dtype", dtype, "--set",
                        "simulation.end_time=0.1", "--set",
                        "simulation.output_interval=0.05"])
        counts[name] = dict(fcc.LAUNCHES)
        runs[name] = re_
        st = re_["final_state"]
        _say(f"main ({name}) config.ini --engine gather {dtype}: "
             f"engine={re_['engine']} steps={re_['step']} t={re_['t']:.3f} "
             f"tau_bottom={re_['tau_bottom']:.6f} dtype={st.x.dtype} "
             f"device={st.x.device} "
             f"psteps/s={re_['particle_steps_per_sec']:.4e} "
             f"host_syncs={re_['host_syncs']} launches={counts[name]}")
        if (re_["engine"] != "Engine" or st.x.dtype != getattr(torch, dtype)
                or st.x.device.type != "cuda"
                or not all(bool(torch.isfinite(getattr(st, f)).all())
                           for f in st._fields)
                or not math.isfinite(re_["tau_bottom"])
                or not math.isfinite(re_["tau_top"]) or re_["step"] <= 0):
            raise AssertionError(f"({name}) gather {dtype}: not a finite "
                                 "run of the gather engine on the card")
        _launched(name, counts[name], set())
    return dict(runs=runs, counts=counts)


def phase_cellgrid(device) -> dict:
    """The cell-layout engine on the card over 0.05 s of config.ini: float32
    against the fused engine ("auto"), float64 against float32."""
    import numpy as np
    import torch
    from sph_poiseuille_flow_torch.config import load_config
    from sph_poiseuille_flow_torch.models.poiseuille import build_scene
    from sph_poiseuille_flow_torch.stepper import (CellEngine,
                                                   PallasCellEngine,
                                                   initial_state,
                                                   make_engine)

    base = load_config(os.path.join(ROOT, "config.ini"))
    scene = build_scene(base)
    runs = {}
    for name, kw, kind in (
            ("fused", dict(engine="auto"), PallasCellEngine),
            ("cell32", dict(engine="cellgrid"), CellEngine),
            ("cell64", dict(engine="auto", dtype="float64"), CellEngine)):
        cfg = dataclasses.replace(base, **kw)
        eng = make_engine(cfg, scene, device)
        if type(eng) is not kind:
            raise AssertionError(f"cellgrid ({name}): {type(eng).__name__}")
        t0 = time.perf_counter()
        s, lay, g, ovf = eng.init(initial_state(cfg, scene, device))
        r = eng.run_interval(s, lay, g, np.dtype(cfg.dtype).type(0.05))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name] = r
        finite = all(bool(torch.isfinite(getattr(r.state, f)).all())
                     for f in r.state._fields)
        _say(f"cellgrid ({name}) {type(eng).__name__} {cfg.dtype}: "
             f"{r.n_steps} steps in {wall:.2f} s, v_max={float(r.v_max):.9f} "
             f"tau_bottom={float(r.tau_bottom):.9f} "
             f"tau_top={float(r.tau_top):.9f}")
        if (bool(ovf) or bool(r.overflow) or r.skin_guard or not finite
                or r.state.x.device != torch.device(device)):
            raise AssertionError(f"cellgrid ({name}): flags or state not "
                                 "clean")
    fused, c32, c64 = runs["fused"], runs["cell32"], runs["cell64"]
    if not fused.n_steps == c32.n_steps == c64.n_steps:
        raise AssertionError(f"cellgrid: steps {fused.n_steps} (fused) / "
                             f"{c32.n_steps} (f32) / {c64.n_steps} (f64)")
    # tests/test_pallas.py:63-72, in particle order
    tols = {"p": (1e-2, 2.5e-2), "drho_dt": (5e-3, 5e-3)}
    cfg = base
    units = {"p": cfg.p0, "drho_dt": cfg.rho0 * cfg.c_f / cfg.h}
    worst32 = worst64 = 0.0
    for f in fused.state._fields:
        a = getattr(fused.state, f).double()
        b = getattr(c32.state, f).double()
        rtol, atol = tols.get(f, (2e-3, 5e-4))
        frac = float(((b - a).abs() / (atol + rtol * a.abs())).max())
        worst32 = max(worst32, frac)
        if frac > 1.0:
            raise AssertionError(f"cellgrid f32 vs fused: {f} off by "
                                 f"{frac:.2f} of its tolerance")
        d = getattr(c64.state, f)
        scale = max(units.get(f, 1.0), float(b.abs().max()))
        rel = float((d - b).abs().max()) / scale
        worst64 = max(worst64, rel)
        if not rel <= 1e-3:
            raise AssertionError(f"cellgrid f64 vs f32: {f} differs by "
                                 f"{rel:.2e} of its scale")
    _say(f"cellgrid: f32 vs fused {fused.n_steps} steps each, worst field at "
         f"{worst32:.3f} of the tests/test_pallas.py tolerance; f64 vs f32 "
         f"worst {worst64:.2e} of the field's scale (bound 1e-3)")
    gather = phase_gather(device, base, scene, c32)
    return dict(worst32=worst32, worst64=worst64, steps=c32.n_steps,
                gather=gather)


def _jittered_state(cfg, scene, device):
    """``initial_state`` with the seeded jitter of ``_jittered_case``
    (positions, velocities, drho) in ``cfg``'s dtype."""
    import numpy as np
    import torch
    from sph_poiseuille_flow_torch.stepper import initial_state

    rng = np.random.default_rng(7)
    nf, n = scene.n_fluid, scene.n_total
    x = np.asarray(scene.x, np.float64).copy()
    y = np.asarray(scene.y, np.float64).copy()
    x[:nf] = np.mod(x[:nf] + rng.uniform(-0.35, 0.35, nf) * cfg.dp, cfg.DL)
    y[:nf] += rng.uniform(-0.35, 0.35, nf) * cfg.dp
    vx, vy, dr = (np.zeros(n) for _ in range(3))
    vx[:nf] = rng.normal(0, 0.4, nf)
    vy[:nf] = rng.normal(0, 0.1, nf)
    dr[:nf] = rng.normal(0, 0.05, nf)
    dtype = getattr(torch, cfg.dtype)
    return initial_state(cfg, scene, device)._replace(**{
        k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in
        dict(x=x, y=y, vx=vx, vy=vy, drho_dt=dr).items()})


def phase_gather(device, base, scene, c32) -> dict:
    """The packed-gather engine (``Engine``) against ``CellEngine`` on the
    card: one step from the jittered state in float32 (tests/
    test_cellgrid.py:110-117) and float64 (1e-10 of each field's scale),
    and 0.05 s of config.ini from rest in float32 against phase 3b's
    ``CellEngine`` run (the same steps and pairs; v_max and tau within
    tests/test_cellgrid.py:128-134's tolerances)."""
    import numpy as np
    import torch
    from sph_poiseuille_flow_torch.stepper import (CellEngine, Engine,
                                                   initial_state,
                                                   make_engine)

    out = {}
    tols = {"p": (1e-2, 2.5e-2), "drho_dt": (5e-3, 5e-3)}
    for dtype in ("float32", "float64"):
        cfg = dataclasses.replace(base, engine="gather", dtype=dtype)
        steps = []
        for kind in (Engine, CellEngine):
            eng = kind(cfg, scene, device)
            s, lay, g, ovf = eng.init(_jittered_state(cfg, scene, device))
            r = eng.step(s, lay, g, remain=1.0)
            if bool(ovf) or bool(r[4]) or bool(r[5]):
                raise AssertionError(f"gather ({dtype}): {kind.__name__} "
                                     "flags not clean")
            steps.append(r)
        (ga, *gs), (ce, *cs) = steps[0], steps[1]
        worst = 0.0
        for f in ga._fields:
            a = getattr(ce, f).double()
            b = getattr(ga, f).double()
            if b.dtype != torch.float64 or getattr(ga, f).dtype != getattr(
                    torch, dtype) or b.device != a.device:
                raise AssertionError(f"gather ({dtype}): {f} dtype/device")
            if dtype == "float32":
                rtol, atol = tols.get(f, (2e-3, 5e-4))
                frac = float(((b - a).abs() / (atol + rtol * a.abs())).max())
            else:
                frac = float((b - a).abs().max()) / (
                    1e-10 * max(1.0, float(a.abs().max())))
            worst = max(worst, frac)
            if not frac <= 1.0:
                raise AssertionError(f"gather ({dtype}) step vs CellEngine: "
                                     f"{f} off by {frac:.2f} of its "
                                     "tolerance")
        rel = 1e-6 if dtype == "float32" else 1e-10
        trel = 1e-3 if dtype == "float32" else 1e-10
        tabs = 1e-6 if dtype == "float32" else 0.0
        dt_g, dt_c = float(gs[2]), float(cs[2])
        if abs(dt_g - dt_c) > rel * abs(dt_c):
            raise AssertionError(f"gather ({dtype}): dt {dt_g} vs {dt_c}")
        for k in (5, 6):
            tg, tc = float(gs[k]), float(cs[k])
            if not abs(tg - tc) <= tabs + trel * abs(tc):
                raise AssertionError(f"gather ({dtype}): tau {tg} vs {tc}")
        out[f"step_{dtype}"] = worst
        _say(f"gather ({dtype}): one jittered step against CellEngine, "
             f"worst field at {worst:.3f} of its tolerance; dt {dt_g:.9e} / "
             f"{dt_c:.9e}; tau_bottom {float(gs[5]):.9f} / "
             f"{float(cs[5]):.9f}")

    cfg = dataclasses.replace(base, engine="gather")
    eng = make_engine(cfg, scene, device)
    if type(eng) is not Engine:
        raise AssertionError(f"gather: make_engine gave "
                             f"{type(eng).__name__}")
    t0 = time.perf_counter()
    s, lay, g, ovf = eng.init(initial_state(cfg, scene, device))
    r = eng.run_interval(s, lay, g, np.float32(0.05))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(getattr(r.state, f)).all())
                 for f in r.state._fields)
    _say(f"gather (interval) Engine float32: {r.n_steps} steps in "
         f"{wall:.2f} s, n_pairs={int(r.n_pairs)} (CellEngine "
         f"{int(c32.n_pairs)}), v_max={float(r.v_max):.9f} "
         f"({float(c32.v_max):.9f}), tau_bottom={float(r.tau_bottom):.9f} "
         f"({float(c32.tau_bottom):.9f}), tau_top={float(r.tau_top):.9f} "
         f"({float(c32.tau_top):.9f})")
    if (bool(ovf) or bool(r.overflow) or r.skin_guard or not finite
            or r.state.x.device != torch.device(device)):
        raise AssertionError("gather (interval): flags or state not clean")
    if r.n_steps != c32.n_steps or int(r.n_pairs) != int(c32.n_pairs):
        raise AssertionError(f"gather (interval): steps {r.n_steps} / "
                             f"{c32.n_steps}, pairs {int(r.n_pairs)} / "
                             f"{int(c32.n_pairs)}")
    if not abs(float(r.v_max) - float(c32.v_max)) <= 1e-3 * abs(
            float(c32.v_max)):
        raise AssertionError("gather (interval): v_max off")
    for a, b in ((r.tau_bottom, c32.tau_bottom), (r.tau_top, c32.tau_top)):
        if not abs(float(a) - float(b)) <= 1e-5 + 2e-3 * abs(float(b)):
            raise AssertionError(f"gather (interval): tau {float(a)} vs "
                                 f"{float(b)}")
    out.update(interval_steps=r.n_steps, interval_wall_s=wall)
    return out


def phase_bench() -> dict:
    """``bench_torch.measure(0.025)`` with its full protocol; it raises on
    a dirty flag, and the line must have bench.py's keys, a positive
    value and one positive entry per timed interval."""
    import bench_torch
    t0 = time.perf_counter()
    out = bench_torch.measure(0.025)
    keys = {"metric", "value", "unit", "vs_baseline", "mean_value",
            "mean_vs_baseline", "intervals"}
    if (set(out) != keys or out["metric"] != "particle_steps_per_sec_dp0.025"
            or not out["value"] > 0 or len(out["intervals"]) != 5
            or not all(v > 0 for v in out["intervals"])
            or out["value"] != max(out["intervals"])):
        raise AssertionError(f"bench: malformed line {out}")
    _say(f"bench dp=0.025: best {out['value']:.4e} mean "
         f"{out['mean_value']:.4e} particle-steps/s in "
         f"{time.perf_counter() - t0:.1f} s")
    return out


# phase 6: the full eight lanes of docs/VALIDATION.md's dp=0.01 sweep,
# and the lanes the batched path holds against single runs
SWEEP_MUS = (0.05, 0.075, 0.1, 0.125, 0.15, 0.2, 0.25, 0.3)
SWEEP_EQUAL = (2, 6)   # mu = 0.1 (config's) and 0.25
BATCH_MUS = (0.05, 0.1, 0.2, 0.3)


# phase 9: the interval's steps (max_steps, bound at a group's end)
RUNNER_STEPS = 384


def _developed(conf_name: str, device):
    """The benchmark's developed state of one of its configurations (its
    traffic file's jitter, a fixed seed): (config, scene, state)."""
    from benchmark import traffic
    from benchmark.drivers.developed import port_config
    from benchmark.reference.sph import Channel
    from sph_poiseuille_flow_torch.models.poiseuille import build_scene
    from sph_poiseuille_flow_torch.stepper import initial_state

    bench = os.path.join(ROOT, "benchmark")
    with open(os.path.join(bench, "configs", conf_name + ".json")) as f:
        conf = json.load(f)
    with open(os.path.join(bench, "workloads",
                           conf_name + ".developed.json")) as f:
        wl = json.load(f)
    cfg = port_config(conf, wl)
    scene = build_scene(cfg)
    inp = traffic.developed_state(Channel.from_physics(conf["physical"]),
                                  wl["state"], 2 ** 31 + 11, device)
    s0 = initial_state(cfg, scene, device)._replace(
        **{k: inp[k].float() for k in ("x", "y", "vx", "vy", "rho",
                                       "drho_dt")})
    return cfg, scene, s0


def _drift_bits(v) -> str:
    import numpy as np
    v = np.float32(float(v))
    return f"{v:.6e} ({v.view(np.uint32):#010x})"


def _runner_drift(device, label: str, cfg, scene, s0) -> None:
    """The drift kernel against ``pair_drift_bounds`` after a 4-step run
    through the runner: on the layout's references, on references with an
    all-empty 2 x 2 block of cells (parked, not fluid) and with a NaN
    velocity in one fluid slot, whose position the chunk makes NaN."""
    import math
    import numpy as np
    import torch
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    from sph_poiseuille_flow_torch.stepper import PallasCellEngine

    eng = PallasCellEngine(cfg, scene, device)
    s, lay, _, _ = eng.init(s0)
    spec = eng.spec
    cores = eng._scatter_all(lay, s)
    nyp, K, nx = lay.refx_p.shape
    refx, refy = lay.refx_p.clone(), lay.refy_p.clone()
    isf = lay.isf_c[1:nyp + 1, :, 1:nx + 1].contiguous()
    r0, c0 = nyp // 2, nx // 2
    refx[r0:r0 + 2, :, c0:c0 + 2] = fc._BIG_X
    isf[r0:r0 + 2, :, c0:c0 + 2] = 0.0
    vx_nan = cores["vxH"].clone()
    fluid = torch.nonzero(lay.isf_c.reshape(-1) > 0)[len(s0.x) // 4]
    vx_nan.view(-1)[fluid] = float("nan")
    own = fc.DriftRef(lay.refx_p, lay.refy_p, lay.isf_c)
    emptied = fc.DriftRef(refx, refy, isf, False)
    scalars = (cfg.rho0, cfg.p0, cfg.c_f, cfg.inv_sigma0,
               cfg.transport_coeff, cfg.gravity_g, cfg.mu,
               cfg.wall_visc_factor)
    runner = fc.ChunkRunner()
    for case, drift, vxH in (("layout", own, cores["vxH"]),
                             ("empty 2x2 block", emptied, cores["vxH"]),
                             ("NaN position", own, vx_nan)):
        run = runner.group(spec, lay, dict(cores, vxH=vxH), np.float32(0.5),
                           scalars, drift)
        bx, by, _, _, steps, _ = run(4, np.float32(0.0), np.float32(0.0))
        st = run.new
        if drift is own:
            want = fc.pair_drift_bounds(spec, lay, st["xP"], st["yP"])
        else:
            want = drift.bounds(nx, st["xP"], st["yP"])
        got = (bx, by)
        _say(f"runner drift {label} {case}: steps={steps} kernel "
             f"{[_drift_bits(v) for v in got]} plain "
             f"{[_drift_bits(v) for v in want]}")
        for a, b in zip(got, (float(v) for v in want)):
            a = float(a)
            if not (a == b or (math.isnan(a) and math.isnan(b))):
                raise AssertionError(f"runner drift {label} {case}: kernel "
                                     f"{a!r} vs pair_drift_bounds {b!r}")
        if case == "NaN position" and not math.isnan(float(bx)):
            raise AssertionError(f"runner drift {label}: a NaN position "
                                 "gave a finite bound")


# phase 9's runner script: (n_sub, kept) a call; the third is not kept
# (a rollback), the fourth runs from the kept state it left
RUNNER_CALLS = ((16, True), (16, True), (16, False), (8, True), (1, True))


def _runner_script(what: str, eng, s0) -> int:
    """A group's runner on the card (``ChunkRunner.group`` ->
    ``sph_chunk_run``) through ``RUNNER_CALLS``, each call against
    ``fused_chunk_call`` (``sph_chunk``) and ``pair_drift_bounds`` from
    the state it began in, bit for bit: every core of the scratch set
    (``cnt`` summed to ``fused_chunk_call``'s rows) and (bx, by, t,
    t_comp, steps); one host sync a call; a call not kept leaves the kept
    state whole. Returns the steps kept."""
    import numpy as np
    import torch
    from sph_poiseuille_flow_torch.ops import fused_cell as fc

    cfg, spec = eng.cfg, eng.spec
    s, lay, _, _ = eng.init(s0)
    interval = np.float32(0.5)
    scalars = (cfg.rho0, cfg.p0, cfg.c_f, cfg.inv_sigma0,
               cfg.transport_coeff, cfg.gravity_g, cfg.mu,
               cfg.wall_visc_factor)
    run = eng._chunks.group(spec, lay, eng._scatter_all(lay, s), interval,
                            scalars,
                            fc.DriftRef(lay.refx_p, lay.refy_p, lay.isf_c))
    t = tc = np.float32(0.0)
    done = 0
    for i, (n_sub, keep) in enumerate(RUNNER_CALLS):
        c = {k: v.clone() for k, v in run.state().items()}
        st, aux, steps, t2, tc2 = fc.fused_chunk_call(
            spec, lay, c["xH"], c["yH"], c["vxH"], c["vyH"], c["drP"], t, tc,
            interval, n_sub, *scalars)
        bx, by = fc.pair_drift_bounds(spec, lay, st["xP"], st["yP"])
        want = [float(bx), float(by), float(t2), float(tc2), int(steps)]
        *got, steps_g, syncs = run(n_sub, t, tc)
        torch.cuda.synchronize()
        got = [float(v) for v in got] + [steps_g]
        ref = dict(st, **aux)
        new = dict(run.new, cnt=fc._cnt_rows(spec, run.new["cnt"]))
        bad = [k for k in ref if not _bit_equal(ref[k], new[k])]
        if got != want:
            bad.append(f"(bx, by, t, t_comp, steps) {got} against {want}")
        if syncs != 1:
            bad.append(f"{syncs} host syncs")
        if keep:
            run.keep()
            t, tc = np.float32(got[2]), np.float32(got[3])
            done += steps_g
        else:
            bad += [f"kept {k}" for k in c
                    if not _bit_equal(c[k], run.state()[k])]
        if bad:
            raise AssertionError(f"{what} call {i} (n_sub {n_sub}): "
                                 f"sph_chunk_run differs from "
                                 f"fused_chunk_call in {bad}")
    return done


def _counted_groups(eng) -> tuple:
    """Count ``eng``'s sub-chunk groups and its plain rebuilds
    (``_do_rebuild``, which the card's layout sets never call), each in a
    one-element list."""
    groups, plains = [0], [0]
    group, plain = eng._run_group, eng._do_rebuild

    def counted_group(*a):
        groups[0] += 1
        return group(*a)

    def counted_plain(*a):
        plains[0] += 1
        return plain(*a)

    eng._run_group, eng._do_rebuild = counted_group, counted_plain
    return groups, plains


def _snapshot(r) -> dict:
    """Copies of what an ``IntervalResult`` hands its caller: the state,
    every tensor of ``cands``, ``geom``."""
    import torch
    out = {f"state.{k}": v.clone() for k, v in r.state._asdict().items()}
    # shear_tbt is the wall shear's scratch, which every layout of an
    # engine shares and every shear call rewrites
    out.update({f"cands.{k}": v.clone() for k, v in r.cands._asdict().items()
                if torch.is_tensor(v) and k != "shear_tbt"})
    out["geom"] = r.geom.clone()
    return out


def _unchanged(what: str, r, snap: dict) -> None:
    now = _snapshot(r)
    bad = [k for k in snap if not _bit_equal(snap[k], now[k])]
    if bad:
        raise AssertionError(f"{what}: {bad} changed after later intervals")


def phase_runner(device) -> dict:
    """9. The interval path's runner on the card, at the benchmark's two
    grids, with the shipping knobs and with forced rollbacks: its calls
    against ``fused_chunk_call`` and ``pair_drift_bounds`` bit for bit
    (``_runner_script``); the drift kernel against ``pair_drift_bounds``
    with empty cells and a NaN; the engine's interval: its counters
    (``CHUNK_BUFFERS`` runs = host syncs, ``REBUILD_BUFFERS`` runs =
    groups, ``LAUNCHES`` the chunk a sync, the rebuild a group and the
    shear once), rollbacks where forced, and its result unchanged by
    later intervals."""
    import numpy as np
    import torch
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc
    from sph_poiseuille_flow_torch.stepper import PallasCellEngine

    out = {}
    for conf in ("channel-dp0.01", "channel-dp0.005"):
        cfg0, scene, s0 = _developed(conf, device)
        _runner_drift(device, conf, cfg0, scene, s0)
        for case, knobs, predictor in (
                ("shipping", {}, "1"),
                ("rollback", dict(neighbor_skin=0.1 * cfg0.dp), "0")):
            what = f"runner {conf} {case}"
            cfg = dataclasses.replace(cfg0, **knobs)
            kept = _runner_script(what, PallasCellEngine(cfg, scene, device),
                                  s0)
            _say(f"{what}: {len(RUNNER_CALLS)} calls bit-equal to "
                 f"fused_chunk_call and pair_drift_bounds, {kept} steps "
                 "kept")
            old = os.environ.get("SPH_DRIFT_PREDICTOR")
            os.environ["SPH_DRIFT_PREDICTOR"] = predictor
            try:
                eng = PallasCellEngine(cfg, scene, device)
                groups, plains = _counted_groups(eng)
                s, lay, geom, _ = eng.init(s0)
                fcc.reset_launch_counts()
                r = eng.run_interval(s, lay, geom, np.float32(0.5),
                                     max_steps=RUNNER_STEPS)
                torch.cuda.synchronize()
                n_groups = groups[0]
                launches = dict(fcc.LAUNCHES)
                cb = dict(fcc.CHUNK_BUFFERS)
                rb = dict(fcc.REBUILD_BUFFERS)
                # what the call handed back is the caller's: two more
                # intervals leave it as it was
                snap = _snapshot(r)
                r3 = r
                for _ in range(2):
                    r3 = eng.run_interval(r3.state, r3.cands, r3.geom,
                                          np.float32(0.5),
                                          max_steps=RUNNER_STEPS)
                torch.cuda.synchronize()
                _unchanged(what, r, snap)
            finally:
                if old is None:
                    os.environ.pop("SPH_DRIFT_PREDICTOR", None)
                else:
                    os.environ["SPH_DRIFT_PREDICTOR"] = old
            want = dict.fromkeys(launches, 0)
            chunk = fcc.launch_key("fused_chunk",
                                   fc.chunk_form(eng.spec, eng.dtype)[0])
            want.update({chunk: r.n_syncs, "fused_rebuild": n_groups,
                         "fused_wall_shear": 1})
            if launches != want:
                raise AssertionError(f"{what}: launches {launches}, want "
                                     f"{want}")
            if r.n_steps < RUNNER_STEPS or r.skin_guard:
                raise AssertionError(f"{what}: {r.n_steps} steps, guard "
                                     f"{r.skin_guard}")
            if case == "rollback" and r.n_rollbacks == 0:
                raise AssertionError(f"{what}: no sub-chunk rolled back")
            if cb["sets_built"] != 1 or cb["runs"] != r.n_syncs:
                raise AssertionError(f"{what}: CHUNK_BUFFERS {cb}, "
                                     f"{r.n_syncs} host syncs")
            if rb["sets_built"] != 1 or rb["runs"] != n_groups or plains[0]:
                raise AssertionError(f"{what}: REBUILD_BUFFERS {rb}, "
                                     f"{n_groups} groups, {plains[0]} plain "
                                     "rebuilds")
            _say(f"{what}: steps={r.n_steps} rollbacks={r.n_rollbacks} "
                 f"syncs={r.n_syncs} groups={n_groups} CHUNK_BUFFERS={cb} "
                 f"REBUILD_BUFFERS={rb} LAUNCHES chunk={launches[chunk]} "
                 f"rebuild={launches['fused_rebuild']} shear="
                 f"{launches['fused_wall_shear']}; cands and state "
                 "unchanged after two more intervals")
            out[f"{conf}:{case}"] = dict(steps=r.n_steps,
                                         rollbacks=r.n_rollbacks,
                                         syncs=r.n_syncs, groups=n_groups,
                                         **cb, rebuild_runs=rb["runs"],
                                         rebuild_sets_built=rb["sets_built"],
                                         runner_calls=len(RUNNER_CALLS))
    return out


def _bit_equal(a, b) -> bool:
    """Equal arrays, floats bit for bit (-0 apart from +0, NaN payloads)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(
            torch.int32)
    return torch.equal(a, b)


def _crowd(st, lay, ids, kept: bool, where):
    """``st`` with the particles ``ids`` moved to the point ``where`` (x,
    y): in the plain position cores of a kept state, else in the carry's
    halo'd ones (centres)."""
    x, y = ("xP", "yP") if kept else ("xH", "yH")
    idx = lay.pidx[ids] if kept else lay.hidx[ids]
    out = dict(st, **{x: st[x].clone(), y: st[y].clone()})
    out[x].view(-1)[idx] = where[0]
    out[y].view(-1)[idx] = where[1]
    return out


def _rebuild_case(what, eng, sets, lay, st, kept: bool):
    """One rebuild both ways, compared bit for bit; returns the two
    (layout, carry) pairs and the overflow."""
    import torch
    ref_st = st if kept else dict(st, xP=st["xH"][1:-1, :, 1:-1],
                                  yP=st["yH"][1:-1, :, 1:-1])
    ref_lay, ref_carry = eng._do_rebuild(lay, ref_st)
    # twice the kept pair count (the per-slot counts are multiples of 1/2)
    want2 = 2.0 * float(torch.sum(st["cnt"])) if kept else 0.0
    first = sets.first
    got_lay, got_carry, _ = sets(lay, st, kept)
    torch.cuda.synchronize()
    bad = [f for f in ("pidx", "hidx", "isf_c", "mass_c", "wvx_c", "wvy_c",
                       "wbot_c", "wtop_c", "refx_p", "refy_p", "occ",
                       "overflow")
           if not _bit_equal(getattr(ref_lay, f), getattr(got_lay, f))]
    bad += [k for k in ("xH", "yH", "vxH", "vyH", "drP")
            if not _bit_equal(ref_carry[k], got_carry[k])]
    if int(sets.bufs.pairs2) != want2:
        bad.append(f"twice the pairs {int(sets.bufs.pairs2)} against "
                   f"{want2}")
    if first and bool(sets.bufs.overflow_any) != bool(ref_lay.overflow):
        bad.append("overflow_any")
    if bad:
        raise AssertionError(f"{what}: sph_rebuild differs from _do_rebuild "
                             f"in {bad}")
    return (ref_lay, ref_carry), (got_lay, got_carry), bool(ref_lay.overflow)


def phase_rebuild(device) -> dict:
    """10. The rebuild on the layout sets against ``_do_rebuild``, bit for
    bit, at the benchmark's two grids: from a kept state and from a
    carry, with cells crowded past K and past the kernel's bucket, and
    from the crowded layout."""
    import numpy as np
    import torch
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc
    from sph_poiseuille_flow_torch.stepper import PallasCellEngine

    out = {}
    for conf in ("channel-dp0.01", "channel-dp0.005"):
        cfg, scene, s0 = _developed(conf, device)
        eng = PallasCellEngine(cfg, scene, device)
        s, lay, _, _ = eng.init(s0)
        spec = eng.spec
        cores = eng._scatter_all(lay, s)
        scalars = (cfg.rho0, cfg.p0, cfg.c_f, cfg.inv_sigma0,
                   cfg.transport_coeff, cfg.gravity_g, cfg.mu,
                   cfg.wall_visc_factor)
        run = eng._chunks.group(spec, lay, cores, np.float32(0.5), scalars)
        run(4, np.float32(0.0), np.float32(0.0))
        run.keep()
        kept_st = run.cur
        K = spec.K
        cap = fcc.REBUILD_CAP_PER_K * K
        # a cell in the middle of the channel, its centre
        cx, cy = spec.nx // 2, spec.ny // 2
        where = ((cx + 0.5) * spec.cell_x, spec.y0 + (cy + 0.5) * spec.cell_y)
        n_cases = 0
        for kept, st in ((True, kept_st), (False, cores)):
            for crowd in (0, K + 2, cap + K):
                sets = eng._rebuilds.interval(spec, cores,
                                              eng._layout_statics(),
                                              eng._shear, eng._do_rebuild)
                st_c = _crowd(st, lay, torch.arange(crowd, device=device),
                              kept, where) if crowd else st
                what = f"rebuild {conf} kept={kept} crowd={crowd}"
                (ref_lay, ref_c), (got_lay, got_c), ovf = _rebuild_case(
                    what, eng, sets, lay, st_c, kept)
                n_cases += 1
                if bool(ovf) != (crowd > K):
                    raise AssertionError(f"{what}: overflow {ovf}")
                if crowd:
                    # again from the crowded layout, its overflowed
                    # particles at the sentinel index
                    aux = {k: cores[k] for k in ("rhoP", "pP", "fxP", "fyP",
                                                 "fpxP", "fpyP", "volH",
                                                 "b11H", "b12H", "b21H",
                                                 "b22H")}
                    _rebuild_case(what + " again", eng, sets, ref_lay,
                                  dict(ref_c, **aux), False)
                    n_cases += 1
                _say(f"{what}: bit-equal (overflow {ovf}; a second rebuild "
                     f"from it too)" if crowd else f"{what}: bit-equal")
        out[conf] = dict(cases=n_cases, cap=cap, K=K)
    return out


def phase_sweep(device) -> dict:
    """(i) The fused sweep through the CLI at dp=0.01 with the shipping
    knobs, eight lanes for 0.1 s: every lane finite with v_max rising (the
    sweep raises on a dirty flag), the run's kernels launched and no other
    form, and lanes 2 and 6 bit-equal to a single ``PallasCellEngine`` run
    from the same init (lane 6's from ``_lane_cfg``). (ii) The batched
    cellgrid path on config.ini in float64, four lanes for 0.05 s: each
    lane within 1e-10 of its own single run on the card, and the ms per
    lane-step of one lane alone and of the four."""
    import math
    import numpy as np
    import torch
    from sph_poiseuille_flow_torch import parallel
    from sph_poiseuille_flow_torch import run as cli
    from sph_poiseuille_flow_torch.config import load_config
    from sph_poiseuille_flow_torch.models.poiseuille import build_scene
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc
    from sph_poiseuille_flow_torch.parallel.sweep import _lane_cfg
    from sph_poiseuille_flow_torch.stepper import initial_state, make_engine

    def single(cfg, g=None, mu=None):
        scene = build_scene(cfg)
        eng = make_engine(cfg, scene, device)
        s, lay, geom, ovf = eng.init(initial_state(cfg, scene, device))
        t = 0.0
        while t < cfg.end_time - 1e-9:
            target = min(t + cfg.output_interval, cfg.end_time)
            r = eng.run_interval(s, lay, geom,
                                 np.dtype(cfg.dtype).type(target - t), g, mu)
            if bool(ovf) or bool(r.overflow) or r.skin_guard:
                raise AssertionError("sweep: a single run's flags not clean")
            s, lay, geom = r.state, r.cands, r.geom
            t = target
        return s

    # (i) the fused sweep, eight lanes, through the CLI
    t0 = time.perf_counter()
    base = os.path.join(OUT, "sweep_dp001")
    os.makedirs(base, exist_ok=True)
    ini = os.path.join(base, "config.ini")
    with open(ini, "w") as f:
        f.write("[physical]\nDL = 3.0\nDH = 1.0\ndp = 0.01\nrho0 = 1.0\n"
                "mu = 0.1\nU_bulk = 0.666667\nc_f = 15.0\n[simulation]\n"
                "end_time = 0.1\noutput_interval = 0.05\n"
                "sort_interval = 100\nrestart_from_file = 0\n")
    seen = {}
    orig = parallel.run_sweep

    def keep(cfg, gs, mus, **kw):
        seen.update(cfg=cfg, gs=gs, mus=mus, out=orig(cfg, gs, mus, **kw))
        return seen["out"]

    parallel.run_sweep = keep
    buf = io.StringIO()
    fcc.reset_launch_counts()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--config", ini, "--base-dir", base, "--device",
                           "cuda", "--neighbor-skin",
                           str(DP001["neighbor_skin"]), "--rebuild-every",
                           "128", "--cell-capacity", "14", "--lane-pack-nx",
                           "100", "--sweep-mus",
                           ",".join(str(m) for m in SWEEP_MUS)])
        torch.cuda.synchronize()
    finally:
        parallel.run_sweep = orig
    counts = dict(fcc.LAUNCHES)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    out = seen["out"]
    pat = re.compile(r"  lane (\d+) output point t=[\d.]+: steps=(\d+), "
                     r"vmax=([\d.]+)$")
    vmax = {}
    for ln in text.splitlines():
        m = pat.match(ln)
        if m:
            vmax.setdefault(int(m.group(1)), []).append(float(m.group(3)))
    for ln in text.splitlines():
        if ln.startswith(("workload", "throughput", "  lane done")):
            _say(f"  {ln}")
    _say(f"sweep (i) fused dp=0.01, {len(SWEEP_MUS)} lanes x 0.1 s: "
         f"rc={rc} lane-steps={out['total_lane_steps']} "
         f"wall={out['wall_time']:.2f} s (phase {wall:.1f} s) "
         f"psteps/s={out['particle_steps_per_sec']:.4e} launches={counts}")
    st = out["final_states"]
    if st.x.shape[0] != len(SWEEP_MUS) or not all(
            np.isfinite(getattr(st, f)).all() for f in st._fields):
        raise AssertionError("sweep (i): lanes missing or not finite")
    for k in range(len(SWEEP_MUS)):
        v = vmax.get(k, [])
        if len(v) != 2 or not 0 < v[0] < v[1]:
            raise AssertionError(f"sweep (i) lane {k}: v_max not rising: {v}")
    _launched("sweep", counts, {"fused_step_cache", "fused_chunk_cache",
                                "fused_wall_shear", "fused_rebuild"})
    cfg, gs, mus = seen["cfg"], seen["gs"], seen["mus"]
    for k in SWEEP_EQUAL:
        # the config's own workload runs from the config as a user gives
        # it, every other from the lane's config
        ref = single(cfg if mus[k] == cfg.mu else
                     _lane_cfg(cfg, gs[k], mus[k]))
        for f in ref._fields:
            if not np.array_equal(getattr(st, f)[k],
                                  getattr(ref, f).cpu().numpy()):
                raise AssertionError(f"sweep (i) lane {k} (mu={mus[k]}): "
                                     f"{f} differs from its single run")
        _say(f"sweep (i) lane {k} (mu={mus[k]:g}) equals a single "
             "PallasCellEngine run bit for bit")

    # (ii) the batched cellgrid path, float64, four lanes
    cfg = load_config(os.path.join(ROOT, "config.ini"), engine="cellgrid",
                      dtype="float64", ini_overrides={"simulation": dict(
                          end_time=0.05, output_interval=0.05)})
    gs, mus = parallel.make_workloads(cfg, BATCH_MUS)
    one = parallel.run_sweep(cfg, gs[:1], mus[:1], log=lambda _: None,
                             device=device)
    four = parallel.run_sweep(cfg, gs, mus, log=lambda _: None,
                              device=device)
    ms = {n: 1e3 * r["wall_time"] / r["total_lane_steps"]
          for n, r in ((1, one), (4, four))}
    worst = 0.0
    for k in range(len(BATCH_MUS)):
        ref = single(cfg, float(gs[k]), float(mus[k]))
        for f in ref._fields:
            a = getattr(ref, f).cpu().numpy()
            scale = max(1.0, float(np.abs(a).max()))
            rel = float(np.abs(getattr(four["final_states"], f)[k]
                               - a).max()) / scale
            worst = max(worst, rel)
            if not rel <= 1e-10:
                raise AssertionError(f"sweep (ii) lane {k}: {f} off its "
                                     f"single run by {rel:.2e}")
    _say(f"sweep (ii) cellgrid float64 config.ini, {len(BATCH_MUS)} lanes x "
         f"0.05 s: lane-steps={four['total_lane_steps']}, worst lane vs "
         f"single {worst:.2e} (bound 1e-10); ms per lane-step: 1 lane "
         f"{ms[1]:.4f}, {len(BATCH_MUS)} lanes {ms[4]:.4f}")
    if not all(math.isfinite(v) for v in ms.values()):
        raise AssertionError(f"sweep (ii): times {ms}")
    _say(f"sweep phase done in {time.perf_counter() - t0:.1f} s")
    return dict(counts=counts, rc=rc,
                l2=[float(v) for v in out["l2_errors"]],
                lane_steps=out["total_lane_steps"],
                wall=out["wall_time"],
                psteps=out["particle_steps_per_sec"], worst64=worst,
                ms_per_lane_step={str(n): v for n, v in ms.items()})


# phase 7: the multi-device path on the one card. (i) the kernels on the
# slabs' extended specs against their plain twins, and slab counts held bit
# for bit to one device at (b) under the recompute and the rows forms; (ii)
# the CLI with --mesh at (b) under "auto"
MESH_SLABS = ((1, 4), (2, None), (4, None))   # (slabs, ghost)
MESH_EQUAL = (("none", dict(geom_cache="none"), MESH_SLABS),
              ("rows", dict(fused_rows="1"), ((2, None),)))
MESH_CLI = (1, 2, 4)


def _mesh_cli(name, n, ini_text, extra):
    """One --mesh CLI run; the result with the engine's slab facts."""
    from sph_poiseuille_flow_torch import simulation
    seen = {}
    orig = simulation.Simulation._make_sharded_engine

    def keep(self, n_devices):
        seen["engine"] = orig(self, n_devices)
        return seen["engine"]

    simulation.Simulation._make_sharded_engine = keep
    try:
        res = _run_cli(name, ini_text, ["--mesh", str(n)] + list(extra))
    finally:
        simulation.Simulation._make_sharded_engine = orig
    res["engine_obj"] = seen["engine"]
    return res


def _slab_kernels(device, check: Check) -> None:
    """Each kernel of the mesh path on the inputs the path gives it at (b)
    from the jittered state: every extended slab of ``MESH_SLABS``
    (rows_loc + 2 ghost rows, the layout shim, the group's occupancy
    bound, the whole domain's cache lanes), built as ``_one_step`` builds
    them, in every form of ``FORMS`` (none, the "auto" pick on the slab's
    spec, partial, rows): the step at both dts against its plain twin,
    and on one slab (ghost 4) the 16-step chunk too."""
    import torch
    from sph_poiseuille_flow_torch.config import derive_config
    from sph_poiseuille_flow_torch.models.poiseuille import build_scene
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    from sph_poiseuille_flow_torch.ops.integration import verlet_dt
    from sph_poiseuille_flow_torch.parallel import (ShardedPallasEngine,
                                                    make_mesh)

    cfg = derive_config(**DP001)
    scene = build_scene(cfg)
    s0 = _jittered_state(cfg, scene, device)
    nf = scene.n_fluid
    dt = verlet_dt(s0.vx[:nf], s0.vy[:nf], cfg.c_f, cfg.h, cfg.nu,
                   cfg.gravity_g, 1.0)
    for n, ghost in MESH_SLABS:
        eng = ShardedPallasEngine(cfg, scene, make_mesh(n), ghost=ghost)
        s, lay, _, ovf = eng.init(s0)
        if bool(ovf):
            raise AssertionError(f"mesh kernels: {n} slab(s) overflow")
        sts, _, statics, _, _ = eng._entry(s, lay)
        stat_h = eng._stat_h({k: [st[k] for st in statics]
                              for k in ("isf", "mass", "wvx", "wvy")})
        slabs = eng._slab_args(sts, stat_h)
        for flabel, knobs in FORMS:
            fspec = _form_spec(eng.slab_spec, knobs)
            check.worst = (0.0, "")
            for i, (shim, *args) in enumerate(slabs):
                _check_form(device, check, f"mesh{n}/slab{i}", cfg, fspec,
                            shim, args, dt, flabel,
                            chunks=CHUNKS["b"] if n == 1 else (),
                            cache_slots=eng.cache_slots, say=False)
            _say(f"mesh (i) kernels, {n} slab(s) ghost {eng.ghost}, "
                 f"extended slab {tuple(slabs[0][1].shape)}, form {flabel}"
                 f" ({fc.step_form(fspec, torch.float32)}): step"
                 f"{' and 16-step chunk' if n == 1 else ''} on every slab "
                 f"against the plain twin, worst rel {check.worst[0]:.3e} "
                 f"({check.worst[1]})")


def phase_mesh(device, main_res, check: Check) -> dict:
    """(i) The kernels on the slabs' extended specs against their plain
    twins (``_slab_kernels``); then ``ShardedPallasEngine`` with one slab
    (ghost 4), two and four slabs on the card against the single-device
    ``PallasCellEngine`` at (b) under ``--geom-cache none``, and two slabs
    under ``--fused-rows 1``, over 0.02 s from the same init: equal steps,
    pairs and rollbacks and every ``State`` field bit-equal (the largest
    difference per field printed otherwise, and the check fails); the
    step kernel launched slabs x slab steps times (the chunk on one
    slab). (ii) ``--mesh 1``, ``--mesh 2`` and ``--mesh 4`` through the
    CLI at (b) under "auto" for 0.3 s: clean flags, finite rising tau,
    the step kernel of the form the slab resolves to launched once per
    slab per slab step and no other step or chunk form, the wall shear
    once per interval (one slab: phase 3's launches), the slab's kernel
    form and lanes those of the whole domain, and the final state
    bit-equal to phase 3's single-device (b) run; ms per step beside it.
    (iii) ``--mesh 2 --dtype float64`` (``ShardedCellEngine``) on
    config.ini for 0.05 s within 1e-10 of ``CellEngine`` on the same
    padded grid."""
    import math
    import numpy as np
    import torch
    from sph_poiseuille_flow_torch.config import derive_config, load_config
    from sph_poiseuille_flow_torch.models.poiseuille import build_scene
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc
    from sph_poiseuille_flow_torch.parallel import (ShardedCellEngine,
                                                    ShardedPallasEngine,
                                                    make_mesh)
    from sph_poiseuille_flow_torch.stepper import (CellEngine,
                                                   PallasCellEngine,
                                                   initial_state)

    t0 = time.perf_counter()
    counts, out = {}, {}

    # (i) the kernels on the slabs' specs, then bit-equality at (b) under
    # the recompute and the rows forms, 0.02 s
    _slab_kernels(device, check)
    base = derive_config(**DP001)
    scene = build_scene(base)
    s0 = initial_state(base, scene, device)

    def interval(eng):
        s, lay, geom, ovf = eng.init(s0)
        r = eng.run_interval(s, lay, geom, np.float32(0.02))
        torch.cuda.synchronize()
        if bool(ovf) or bool(r.overflow) or r.skin_guard:
            raise AssertionError(f"mesh (i) {type(eng).__name__}: flags "
                                 "not clean")
        return r

    for flabel, knobs, slabs in MESH_EQUAL:
        cfg = dataclasses.replace(base, **knobs)
        fcc.reset_launch_counts()
        ref = interval(PallasCellEngine(cfg, scene, device))
        _say(f"mesh (i) one device, {flabel}: launches {dict(fcc.LAUNCHES)}")
        for n, ghost in slabs:
            fcc.reset_launch_counts()
            eng = ShardedPallasEngine(cfg, scene, make_mesh(n), ghost=ghost)
            t1 = time.perf_counter()
            r = interval(eng)
            wall = time.perf_counter() - t1
            c = dict(fcc.LAUNCHES)
            counts[f"mesh_eq{n}_{flabel}"] = c
            diffs = {}
            for f in ref.state._fields:
                a, b = getattr(ref.state, f), getattr(r.state, f)
                if not torch.equal(a, b):
                    d = (a.double() - b.double()).abs()
                    i = int(torch.argmax(d))
                    diffs[f] = (float(d.max()), i,
                                "fluid" if i < scene.n_fluid else "wall")
            form = fc.step_form(eng.slab_spec, torch.float32)[0]
            _say(f"mesh (i) (b) {flabel}, {n} slab(s) ghost {eng.ghost} "
                 f"rows_loc {eng.rows_loc} (slab form {form}): steps "
                 f"{r.n_steps}/{ref.n_steps} pairs "
                 f"{int(r.n_pairs)}/{int(ref.n_pairs)} rollbacks "
                 f"{r.n_rollbacks}/{ref.n_rollbacks} syncs {r.n_syncs}/"
                 f"{ref.n_syncs} slab steps {eng.slab_steps} in {wall:.2f} "
                 f"s; fields not bit-equal: {diffs or 'none'}; launches {c}")
            for f, (d, i, kind) in diffs.items():
                _say(f"  mesh (i) {f}: largest difference {d:.3e} at "
                     f"particle {i} ({kind})")
            if (diffs or r.n_steps != ref.n_steps or r.n_rollbacks
                    != ref.n_rollbacks or int(r.n_pairs) != int(ref.n_pairs)
                    or float(r.tau_bottom) != float(ref.tau_bottom)):
                raise AssertionError(f"mesh (i): {n} slab(s) not bit-equal "
                                     f"to one device under {flabel}")
            kstep = fcc.launch_key("fused_step", form)
            kchunk = fcc.launch_key("fused_chunk", form)
            want = ({kstep: 1, kchunk: c[kchunk], "fused_wall_shear": 1}
                    if n == 1 else
                    {kstep: n * eng.slab_steps, "fused_wall_shear": 1})
            if n == 1 and c[kchunk] <= 0:
                raise AssertionError("mesh (i): one slab launched no chunk")
            bad = {k: v for k, v in c.items() if v != want.get(k, 0)}
            if bad:
                raise AssertionError(f"mesh (i) {n} slab(s) {flabel}: "
                                     f"launches {bad}, want {want}")

    # (ii) --mesh 2 / 4 at (b) under "auto" through the CLI, 0.3 s
    ini = "".join(
        [f"[physical]\n"]
        + [f"{k} = {DP001[k]}\n" for k in ("DL", "DH", "dp", "rho0", "mu",
                                           "U_bulk", "c_f")]
        + ["[simulation]\n"]
        + [f"{k} = {int(DP001[k])}\n" if k != "end_time"
           and k != "output_interval" else f"{k} = {DP001[k]}\n"
           for k in ("end_time", "output_interval", "sort_interval",
                     "restart_from_file")])
    flags = ["--neighbor-skin", str(DP001["neighbor_skin"]),
             "--rebuild-every", str(DP001["rebuild_every"]),
             "--cell-capacity", str(DP001["cell_capacity"]),
             "--lane-pack-nx", str(DP001["lane_pack_nx"])]
    rb = main_res["runs"]["b"]
    ms_one = 1e3 * rb["wall_time_in_loop"] / rb["step"]
    out["ms_per_step"] = {"1": ms_one}
    for n in MESH_CLI:
        fcc.reset_launch_counts()
        res = _mesh_cli(f"mesh{n}_dp001", n, ini, flags)
        c = dict(fcc.LAUNCHES)
        counts[f"mesh{n}"] = c
        eng = res["engine_obj"]
        form = fc.step_form(eng.slab_spec, torch.float32)[0]
        key = fcc.launch_key("fused_step", form)
        taus = [tb for _, tb, _ in res["tau_history"]]
        st = res["final_state"]
        finite = all(bool(torch.isfinite(getattr(st, f)).all())
                     for f in st._fields)
        ms = 1e3 * res["wall_time_in_loop"] / res["step"]
        out["ms_per_step"][str(n)] = ms
        out[f"mesh{n}"] = dict(steps=res["step"], slab_steps=eng.slab_steps,
                               form=form, rows_loc=eng.rows_loc,
                               host_syncs=res["host_syncs"],
                               wall=res["wall_time_in_loop"], ms=ms,
                               tau=taus)
        _say(f"mesh (ii) --mesh {n} dp={DP001['dp']} auto: engine "
             f"{res['engine']} "
             f"rows_loc {eng.rows_loc} slab form {form} (whole domain "
             f"{fc.step_form(eng.spec, torch.float32)[0]}): steps "
             f"{res['step']} slab steps {eng.slab_steps} tau_bottom "
             f"{['%.5f' % v for v in taus]} host_syncs {res['host_syncs']} "
             f"ms/step {ms:.4f} (one device, phase 3 (b): {ms_one:.4f}) "
             f"launches {c}")
        if (res["engine"] != "ShardedPallasEngine" or not finite
                or not all(math.isfinite(v) for v in taus)
                or not all(b > a for a, b in zip(taus, taus[1:]))):
            raise AssertionError(f"mesh (ii) --mesh {n}: not a clean run")
        # the slabs run the whole domain's kernel form with its lanes per
        # anchor (the cache form's sums depend on them), so the run is
        # phase 3's single-device (b) run, bit for bit. A slab that
        # resolved to another form could not be held to it: that fails.

        def kernel(spec, form, cache_slots=0):
            c = fcc._const(spec, fc.plan(spec)[0], 1.0, 0.0, 0.0, 0.0, 0.0,
                           cache_slots=cache_slots)
            return fcc._form(*form(spec, torch.float32), spec.K), c.cg0, c.cg

        slab_k = kernel(eng.slab_spec, fc.step_form, eng.cache_slots)
        whole_k = kernel(eng.spec, fc.chunk_form)
        diff = {f: float((getattr(st, f).double()
                          - getattr(rb["final_state"], f).double())
                         .abs().max()) for f in st._fields}
        out[f"mesh{n}"]["max_diff_vs_one_device"] = max(diff.values())
        _say(f"  --mesh {n} against one device: steps {res['step']}/"
             f"{rb['step']}, largest field difference "
             f"{max(diff.values()):.3e} (kernel form, lanes: slab {slab_k}, "
             f"whole domain {whole_k}; must be 0)")
        if slab_k != whole_k:
            raise AssertionError(f"mesh (ii) --mesh {n}: the slab resolves "
                                 f"to {slab_k}, the whole domain to "
                                 f"{whole_k}: the run cannot be held to one "
                                 "device bit for bit")
        if any(diff.values()) or res["step"] != rb["step"]:
            raise AssertionError(f"mesh (ii) --mesh {n}: not bit-equal to "
                                 f"one device: {diff}")
        # one slab (ghost 0) runs the single-device loop: phase 3's
        # launches exactly
        want = (main_res["counts"]["b"] if n == 1 else
                {key: n * eng.slab_steps,
                 "fused_wall_shear": len(res["tau_history"])})
        bad = {k: v for k, v in c.items() if v != want.get(k, 0)}
        if bad:
            raise AssertionError(f"mesh (ii) --mesh {n}: launches {bad}, "
                                 f"want {want}")

    # (iii) float64 on two slabs of the cell-layout engine
    fcc.reset_launch_counts()
    res = _mesh_cli("mesh2_f64", 2, None, [
        "--dtype", "float64", "--set", "simulation.end_time=0.05",
        "--set", "simulation.output_interval=0.025"])
    counts["mesh2_f64"] = dict(fcc.LAUNCHES)
    cfg = load_config(os.path.join(ROOT, "config.ini"), dtype="float64",
                      ini_overrides={"simulation": dict(
                          end_time=0.05, output_interval=0.025)})
    scene = build_scene(cfg)
    eng = CellEngine(cfg, scene, device, s_multiple=2)
    s, lay, geom, _ = eng.init(initial_state(cfg, scene, device))
    t = 0.0
    while t < cfg.end_time - 1e-9:
        target = min(t + cfg.output_interval, cfg.end_time)
        r = eng.run_interval(s, lay, geom, np.float64(target - t))
        s, lay, geom, t = r.state, r.cands, r.geom, target
    worst = 0.0
    for f in s._fields:
        a = getattr(s, f)
        rel = float((getattr(res["final_state"], f) - a).abs().max()) / max(
            1.0, float(a.abs().max()))
        worst = max(worst, rel)
    _say(f"mesh (iii) --mesh 2 float64 config.ini 0.05 s: engine "
         f"{res['engine']} steps {res['step']} worst field vs CellEngine "
         f"(s_multiple 2) {worst:.2e} (bound 1e-10) launches "
         f"{counts['mesh2_f64']}")
    if (res["engine"] != "ShardedCellEngine"
            or not isinstance(res["engine_obj"], ShardedCellEngine)
            or not worst <= 1e-10 or any(counts["mesh2_f64"].values())):
        raise AssertionError("mesh (iii): float64 two-slab run off its "
                             "single-device run, or a kernel launched")
    out["f64_worst"] = worst
    _say(f"mesh phase done in {time.perf_counter() - t0:.1f} s")
    out["counts"] = counts
    return out


def phase_oracle(device) -> dict:
    """The gather engine's operators (``ops/``, float64) on the card
    against the native C++ oracle (``utils/native_oracle.py``, built with
    cmake) on a jittered tiny box: density, KGC, the Verlet step and the
    wall shear within 1e-9 of each output's scale. Skipped, and said so,
    where cmake is missing."""
    import shutil
    import numpy as np
    import torch
    from sph_poiseuille_flow_torch.config import derive_config
    from sph_poiseuille_flow_torch.models.poiseuille import build_scene
    from sph_poiseuille_flow_torch.ops import density as den
    from sph_poiseuille_flow_torch.ops import integration as integ
    from sph_poiseuille_flow_torch.ops import monitors as mon
    from sph_poiseuille_flow_torch.ops import neighbors as nbr
    from sph_poiseuille_flow_torch.utils import native_oracle

    if shutil.which("cmake") is None:
        _say("native oracle: cmake not found on this machine; the check "
             "against the C++ oracle is skipped")
        return dict(skipped=True)
    os.environ["SPH_ORACLE_BUILD_DIR"] = os.path.join(OUT, "oracle_build")
    cfg = derive_config(DL=1.0, DH=0.5, dp=0.05, rho0=1.0, mu=0.1,
                        U_bulk=0.666667, c_f=15.0, end_time=1.0,
                        output_interval=0.5, sort_interval=100,
                        restart_from_file=False, dtype="float64")
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
    t0 = time.perf_counter()
    pairs = native_oracle.build_pairs(x, y, nf, cfg.DL, cfg.h)
    rho_c, vol_c, b_c = native_oracle.density_correction(
        pairs, scene.mass, nf, n, cfg.rho0, cfg.h, cfg.inv_sigma0)
    pos = np.stack([x, y], axis=1)
    ver = native_oracle.integration_verlet(
        pairs, vol_c, b_c, rho_c, scene.mass, pos, vel, drho, fprior, 1e-3,
        nf, n, cfg.rho0, cfg.p0, cfg.c_f, wall_vel)
    tau_c = native_oracle.wall_shear_monitor(
        pairs, pos, vel, wall_vel, vol_c, b_c, nf, cfg.DL, cfg.DH, cfg.mu,
        cfg.h)
    build_s = time.perf_counter() - t0

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    spec = nbr.make_grid_spec(cfg, scene)
    xt, yt, mass = t(x), t(y), t(scene.mass)
    z = torch.zeros(n, dtype=torch.float64, device=device)
    cands = nbr.build_candidates(spec, xt, yt, mass, z, z)
    geom = nbr.compute_geometry(spec, cands, xt, yt, z)
    rho, vol = den.density_sums(spec, geom, cands, mass, cfg.rho0,
                                cfg.inv_sigma0)
    (vol_j,) = nbr.gather_pack(cands.jsafe, (vol,))
    b = den.kernel_gradient_correction(spec, geom, vol_j)
    b_o = [t(b_c[:, k]) for k in range(4)]
    geom = nbr.compute_geometry(spec, cands, xt, yt, t(vol_c))
    vx, vy = t(vel[:, 0]), t(vel[:, 1])
    out = integ.verlet_step(
        spec, geom, cands, t(vol_c), *b_o, t(rho_c), mass, xt, yt, vx, vy,
        t(drho), t(fprior[:, 0]), t(fprior[:, 1]),
        torch.tensor(1e-3, dtype=torch.float64, device=device), cfg.rho0,
        cfg.p0, cfg.c_f)
    tau = mon.wall_shear(spec, geom, cands, vx, t(vol_c), *b_o, cfg.DL,
                         cfg.mu, cfg.h, 4.0)
    pairs_of = dict(rho=(rho, rho_c), vol=(vol, vol_c),
                    **{f"b{k}": (b[k], b_c[:, k]) for k in range(4)})
    for name, g, w in zip(("rho2", "p2", "x2", "y2", "vx2", "vy2", "drho2",
                           "fx", "fy"), out,
                          (ver[0], ver[1], ver[2][:, 0], ver[2][:, 1],
                           ver[3][:, 0], ver[3][:, 1], ver[4],
                           ver[5][:, 0], ver[5][:, 1])):
        pairs_of[name] = (g, w)
    worst = 0.0
    for name, (g, w) in pairs_of.items():
        rel = float(np.max(np.abs(g.cpu().numpy() - w))) / max(
            1.0, float(np.max(np.abs(w))))
        worst = max(worst, rel)
        if not rel <= 1e-9:
            raise AssertionError(f"native oracle: {name} off by {rel:.2e}")
    for k in range(2):
        rel = abs(float(tau[k]) - tau_c[k]) / max(1e-12, abs(tau_c[k]))
        worst = max(worst, rel)
        if not rel <= 1e-9:
            raise AssertionError(f"native oracle: tau[{k}] off by {rel:.2e}")
    _say(f"native oracle: built and ran in {build_s:.1f} s; the gather "
         f"operators in float64 on the card against it, {len(pairs_of) + 2}"
         f" outputs, worst {worst:.2e} of scale (bound 1e-9)")
    return dict(skipped=False, worst=worst)


def _time(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _rows_tiles(spec, picked) -> list:
    """The rows form's tile as rows_tile picks it and its neighbours: half
    and twice the columns at its G, and half and twice its G with the
    columns rows_tile would give them; each that fits a block."""
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc
    tx, G = picked
    K = spec.K
    tiles = [picked, (max(1, tx // 2), G), (min(spec.nx, 2 * tx), G)]
    for g in (G // 2, 2 * G):
        if g in fcc.ROWS_GROUPS:
            tiles.append((max(1, min(spec.nx, fcc.ROWS_BLOCK // (K * g))), g))
    out = []
    for t in tiles:
        if t not in out and t[0] * K * t[1] <= fcc.ROWS_BLOCK_MAX:
            out.append(t)
    return out


def phase_timing(device, kern_b: dict) -> dict:
    """Kernel and plain times of every form of step and chunk at the (b)
    shapes and at dp=0.025, and of the shear at (b); with each call's
    bound. Returns {(grid, kernel): (ms, plain_ms, bound_ms, bound_by)}."""
    import torch
    from sph_poiseuille_flow_torch.config import derive_config
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc
    from sph_poiseuille_flow_torch.ops.integration import verlet_dt
    from sph_poiseuille_flow_torch.probe import event_ms
    from sph_poiseuille_flow_torch.utils import roofline

    cfg25 = derive_config(**DP0025)
    _, spec25, lay25, c25, (vx, vy) = _jittered_case(cfg25, device)
    nf = int(spec25.n_fluid)
    grids = {"b": kern_b, "d025": dict(
        spec=spec25, lay=lay25,
        args=(c25["xH"], c25["yH"], c25["vxH"], c25["vyH"], c25["drP"]),
        sc=kern_b["sc"], dt=verlet_dt(vx[:nf], vy[:nf], cfg25.c_f, cfg25.h,
                                      cfg25.nu, cfg25.gravity_g, 1.0))}
    out = {}
    for grid, k in grids.items():
        spec, lay, args, sc, dt = (k[n] for n in ("spec", "lay", "args",
                                                  "sc", "dt"))
        n = roofline.pair_counts(spec, lay, args[0], args[1])
        _say(f"timing ({grid}): {n['anchors']:.0f} visited anchors, "
             f"{n['pairs']:.0f} valid pairs, {n['wall']:.0f} wall pairs")
        for flabel, knobs in FORMS:
            fspec = _form_spec(spec, knobs)
            form = fc.chunk_form(fspec, torch.float32)[0]
            pairs = {
                "fused_step": (
                    lambda: fc.fused_step_cores(fspec, lay, *args, dt, *sc),
                    lambda: fc.fused_step_cores_plain(fspec, lay, *args, dt,
                                                      *sc), 20, ("step", 1)),
                "fused_chunk": (
                    lambda: fc.fused_chunk_call(fspec, lay, *args, 0.0, 0.0,
                                                1.0, 16, *sc),
                    lambda: fc.fused_chunk_call_plain(
                        fspec, lay, *args, 0.0, 0.0, 1.0, 16, *sc), 5,
                    ("chunk", 16)),
            }
            # device memory of one step call above its inputs (the cache
            # form allocates 9K entries of 24 bytes per cached slot)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            held = torch.cuda.memory_allocated(device)
            pairs["fused_step"][0]()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device) - held
            _say(f"memory ({grid}) [{flabel:7s}] one step: peak "
                 f"{peak / 2**20:.1f} MiB above its inputs; the cache list "
                 f"holds {n['pairs'] * 24 / 2**20:.1f} MiB of valid pairs")
            for base, (kern, plain, reps, (kind, steps)) in pairs.items():
                # plain first, then kernel, kernel, plain (in turns)
                p1 = _time(plain, reps)
                k1 = _time(kern, reps)
                k2 = _time(kern, reps)
                p2 = _time(plain, reps)
                bound = roofline.bound(kind, spec, n, steps)
                name = fcc.launch_key(base, form)
                _say(f"timing ({grid}) {name:17s} [{flabel:7s}] kernel "
                     f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
                     f"bound {bound[0]:.4f} ms ({bound[1]})")
                key = (grid, name if flabel != "partial"
                       else name + "[partial]")
                out[key] = (min(k1, k2), min(p1, p2)) + bound
        # the cache form ("auto" here) at each lane group size of sweep 0
        # and of sweeps 1-3, the other as cache_groups picks it: the chunk
        # and the sweeps each size drives, on persistent buffers
        picked = fcc.cache_groups(fc.plan(spec)[3] * spec.K * spec.nx)
        form = fc.step_form(spec, torch.float32)
        R = fc.plan(spec)[0]
        pick = fcc.cache_groups
        lines = []
        try:
            for which, groups, sweeps in (("G0", fcc.CACHE_GROUPS0, (0,)),
                                          ("G", fcc.CACHE_GROUPS, (1, 2, 3))):
                for G in groups:
                    pair = (G, picked[1]) if which == "G0" else (picked[0], G)
                    fcc.cache_groups = lambda n, pair=pair: pair
                    t = min(_time(lambda: fc.fused_chunk_call(
                        spec, lay, *args, 0.0, 0.0, 1.0, 16, *sc), 5)
                        for _ in range(2))
                    b = fcc.StepBuffers(spec, R, lay, *args, dt, sc, *form)
                    b.sweeps(0, 4)
                    sw = [event_ms(lambda s=s: b.sweeps(s, 1), 50,
                                   queued=True) for s in sweeps]
                    lines.append(f"{which}={G}: chunk {t:.4f}, sweep(s) "
                                 + " / ".join(f"{v:.4f}" for v in sw))
        finally:
            fcc.cache_groups = pick
        _say(f"timing ({grid}) fused_*_cache by lanes per anchor, ms "
             f"(picked G0={picked[0]}, G={picked[1]}): " + "; ".join(lines))
        # the recompute form at each lane group size: the chunk and the
        # step's sweeps on persistent buffers
        nspec = _form_spec(spec, dict(geom_cache="none"))
        picked = fcc.win_groups(fc.plan(spec)[3] * spec.K * spec.nx)
        pick = fcc.win_groups
        lines = []
        try:
            for G in fcc.WIN_GROUPS:
                fcc.win_groups = lambda n, G=G: G
                t = min(_time(lambda: fc.fused_chunk_call(
                    nspec, lay, *args, 0.0, 0.0, 1.0, 16, *sc), 5)
                    for _ in range(2))
                b = fcc.StepBuffers(nspec, R, lay, *args, dt, sc, "none", 0)
                b.sweeps(0, 4)
                sw = [event_ms(lambda s=s: b.sweeps(s, 1), 50, queued=True)
                      for s in range(4)]
                step = event_ms(lambda: b.sweeps(0, 4), 50, queued=True)
                out[(grid, f"none:G={G}")] = (t, step, *sw)
                lines.append(f"G={G}: chunk {t:.4f}, step on buffers "
                             f"{step:.4f}, sweeps "
                             + " / ".join(f"{v:.4f}" for v in sw))
        finally:
            fcc.win_groups = pick
        _say(f"timing ({grid}) fused_* recompute by lanes per anchor, ms "
             f"(picked G={picked}): " + "; ".join(lines))
        # the rows form at the tile rows_tile picks and its neighbours: the
        # chunk and the step's sweeps on persistent buffers
        rspec = _form_spec(spec, dict(fused_rows="1"))
        n_slots = fc.plan(spec)[3] * spec.K * spec.nx
        picked = fcc.rows_tile(spec.K, n_slots, spec.nx)
        pick = fcc.rows_tile
        lines = []
        try:
            for tile in _rows_tiles(spec, picked):
                fcc.rows_tile = lambda K, n, nx, tile=tile: tile
                t = min(_time(lambda: fc.fused_chunk_call(
                    rspec, lay, *args, 0.0, 0.0, 1.0, 16, *sc), 5)
                    for _ in range(2))
                b = fcc.StepBuffers(rspec, R, lay, *args, dt, sc, "rows", 0)
                b.sweeps(0, 4)
                sw = [event_ms(lambda s=s: b.sweeps(s, 1), 50, queued=True)
                      for s in range(4)]
                step = event_ms(lambda: b.sweeps(0, 4), 50, queued=True)
                out[(grid, f"rows:TX={tile[0]},G={tile[1]}")] = (t, step,
                                                                 *sw)
                lines.append(f"TX={tile[0]} G={tile[1]}: chunk {t:.4f}, step "
                             f"on buffers {step:.4f}, sweeps "
                             + " / ".join(f"{v:.4f}" for v in sw))
        finally:
            fcc.rows_tile = pick
        _say(f"timing ({grid}) fused_*_rows by tile, ms (picked TX={picked[0]}"
             f", G={picked[1]}): " + "; ".join(lines))
    k = kern_b
    sh = k["sh"]
    p1 = _time(lambda: fc.fused_wall_shear_cores_plain(k["spec"], k["lay"],
                                                       *sh), 20)
    k1 = _time(lambda: fc.fused_wall_shear_cores(k["spec"], k["lay"], *sh),
               20)
    k2 = _time(lambda: fc.fused_wall_shear_cores(k["spec"], k["lay"], *sh),
               20)
    p2 = _time(lambda: fc.fused_wall_shear_cores_plain(k["spec"], k["lay"],
                                                       *sh), 20)
    n = roofline.pair_counts(k["spec"], k["lay"], sh[0], sh[1])
    bound = roofline.bound("shear", k["spec"], n)
    # the kernel alone: relaunched on the layout's partials, queued behind
    # a spin kernel (device time)
    R = fc.plan(k["spec"])[0]
    alone = event_ms(lambda: fcc.wall_shear(k["spec"], R, k["lay"], *sh),
                     200, queued=True)
    _say(f"timing (b) fused_wall_shear  kernel {k1:.4f}/{k2:.4f} ms with its "
         f"wrapper and sums, {alone:.5f} ms alone on its buffers "
         f"({k['lay'].shear_rows.numel()} rows), plain {p1:.4f}/{p2:.4f} "
         f"ms, bound {bound[0]:.6f} ms ({bound[1]})")
    out[("b", "fused_wall_shear")] = (min(k1, k2), min(p1, p2)) + bound
    out[("b", "fused_wall_shear:alone")] = (alone, None) + bound

    # the no-op on a step's buffers against a row copy_, in turns
    spec, lay, args, sc, dt = (k[n] for n in ("spec", "lay", "args", "sc",
                                              "dt"))
    b = fcc.StepBuffers(spec, R, lay, *args, dt, sc, "none", 0)
    b.sweeps(0, 4)
    src = args[0][0, 0, :]
    row = torch.zeros_like(src)
    noop, copy = [], []
    for _ in range(5):
        noop.append(event_ms(b.noop, 200, queued=True))
        copy.append(event_ms(lambda: row.copy_(src), 200, queued=True))
    for name, v in (("sph_noop", noop), ("copy_", copy)):
        v = sorted(v)
        _say(f"timing (b) {name:9s} on buffers, 5 rounds in turns: min "
             f"{v[0]:.5f} median {v[2]:.5f} max {v[4]:.5f} ms (spread "
             f"{v[4] - v[0]:.5f})")
    out[("b", "noop_rounds")] = tuple(noop)
    out[("b", "copy_rounds")] = tuple(copy)
    return out


# the TPU kernel each CUDA kernel replaces: _step_kernel/_kernel_body via
# _fused_call, _chunk_kernel via fused_chunk_call, the geometry cache of
# both (cache_plan), _kernel_body_rows, _shear_kernel via
# fused_wall_shear_cores
_TPU = "sph_poiseuille_flow_tpu/ops/fused_cell.py"
REPLACES = {
    "fused_step": f"{_TPU}:560",
    "fused_step_cache": f"{_TPU}:422",
    "fused_step_rows": f"{_TPU}:1081",
    "fused_chunk": f"{_TPU}:1550",
    "fused_chunk_cache": f"{_TPU}:422",
    "fused_chunk_rows": f"{_TPU}:1081",
    "fused_wall_shear": f"{_TPU}:1928",
}
# the probes' kernels: _step_kernel on a grid cut to a sweep range
# (call_sweeps; prefix_call of experiments/profile_fused.py:72 is the range
# from sweep 0), the no-op body, the one-hot lane tiling
PROBE_REPLACES = {
    **{f"{key}:sweep{s}": "experiments/profile_r3.py:115"
       for _, _, key in PROBE_RUNS for s in range(4)},
    "fused_noop": "experiments/profile_r3.py:170",
    "expand_onehot": "tests/test_pallas.py:155",
}


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import sph_poiseuille_flow_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    if any(m.split(".")[0] == "jax" for m in sys.modules):
        print("chip_smoke: jax was imported", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    os.makedirs(OUT, exist_ok=True)
    from sph_poiseuille_flow_torch.probe import card_line
    card = card_line()
    _say(f"card: {card}; torch {torch.__version__} cuda "
         f"{torch.version.cuda}; python {sys.version.split()[0]}")

    check = Check()
    try:
        t0 = time.perf_counter()
        phase_build()
        kern = {label: phase_kernels(device, check, label, cfg)
                for label, cfg in _grids()}
        k48 = phase_k48(device, check)
        t1 = time.perf_counter()
        for label in kern:
            phase_probes(device, check, label, kern[label])
            phase_cache(device, check, label, kern[label])
        phase_cache(device, check, "k48", k48, K48_CACHE_FORMS)
        probe_counts, probe_res = phase_probe_cli()
        probe_times = _probe_times(probe_res)
        _say(f"probe phase done in {time.perf_counter() - t1:.1f} s")
        main_res = phase_main()
        cell = phase_cellgrid(device)
        timing = phase_timing(device, kern["b"])
        bench = phase_bench()
        sweep = phase_sweep(device)
        main_res["counts"]["sweep"] = sweep["counts"]
        mesh = phase_mesh(device, main_res, check)
        main_res["counts"].update(mesh["counts"])
        oracle = phase_oracle(device)
        runner = phase_runner(device)
        rebuild = phase_rebuild(device)
        _say(f"all phases done in {time.perf_counter() - t0:.1f} s")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    if any(m.split(".")[0] == "jax" for m in sys.modules):
        print("chip_smoke: jax was imported", file=sys.stderr)
        return 1

    kernels = []
    for name, where in REPLACES.items():
        ms, plain_ms, bound_ms, bound_by = timing[("b", name)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "sph_poiseuille_flow_torch/csrc/fused_cell.cu",
            "replaces": where,
            "launches": sum(c[name] for c in main_res["counts"].values()),
            "max_abs_err": check.max_abs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
    for name, where in PROBE_REPLACES.items():
        ms, plain_ms, bound_ms, bound_by, library_ms = probe_times[name]
        key = name.split(":")[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "sph_poiseuille_flow_torch/csrc/fused_cell.cu",
            "replaces": where,
            "launches": sum(c[key] for c in probe_counts.values()),
            "max_abs_err": check.max_abs[key], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"timing": {f"{g}:{n}": v
                                 for (g, n), v in timing.items()}}))
    print(json.dumps({"cellgrid": cell}))
    print(json.dumps({"bench": bench}))
    print(json.dumps({"sweep": {k: v for k, v in sweep.items()
                                if k != "counts"}}))
    print(json.dumps({"mesh": {k: v for k, v in mesh.items()
                               if k != "counts"}}))
    print(json.dumps({"native_oracle": oracle}))
    print(json.dumps({"chunk_runner": runner}))
    print(json.dumps({"rebuild": rebuild}))
    for run, r in main_res["runs"].items():
        print(json.dumps({"run": run, "L2_error": r["L2_error"],
                          "steps": r["step"], "t": r["t"],
                          "tau_bottom": r["tau_bottom"],
                          "particle_steps_per_sec":
                              r["particle_steps_per_sec"],
                          "host_syncs": r["host_syncs"],
                          "wall_time_in_loop": r["wall_time_in_loop"],
                          "launches": main_res["counts"][run]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
