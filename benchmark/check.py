"""The comparison that decides ``correct``.

SPH is chaotic: two runs that differ by rounding alone part ways within
an output interval (a float32 and a float64 run of the same state differ
by about a particle spacing after some thousands of steps), so an output
point cannot be held against a reference run from the interval's start.
The reference follows the program instead, from the program's own state:

* the start: the program's ``engine.init`` of the benchmark's inputs
  (density, pressure, volume, the correction B) against the reference's
  density pass on the same inputs (``init_gap``);
* one output interval drawn from the seed among the window's first
  ``sampled_from``: the program runs it again from its stored input, cut
  at every sub-chunk group by its own trajectory-preserving split
  (``run_interval(..., max_steps=1)``, carrying the clock and the
  sub-chunk length), which must reproduce the window's output bit for bit
  (``rerun_gap``, limit 0). The reference then runs ``segments`` of those
  groups, drawn from the seed and always the last one, from the state the
  program began the group with: the same number of steps, the last group
  onto the output point. Every field of the program's state at the group's
  end is held against the reference's (``pos_gap``, ``vel_gap``,
  ``dens_gap``, ``drho_gap``, ``force_gap``, ``kgc_gap``), and the output
  point's wall shear and largest speed (``tau_gap``, ``vmax_gap``);
* the first group of the window's first interval, from the benchmark's
  inputs, the same way;
* every output point of the window: overflow, the drift guard and finite
  values (``flags``, limit 0).

Each gap is the widest over particles and groups, in the scale of its
field: positions in dp, speeds in U_max, density and pressure in rho0 and
p0, volume in dp^2, the rate of density and each force in its largest
magnitude in the reference, B absolutely, tau in tau_target.

``control=True`` puts the reference in bfloat16 (positions float32) in the
program's place: its groups and its density pass are held against the
float64 reference the same way.
"""

from __future__ import annotations

import math
import random

import torch

from .reference.sph import Fields, Reference

NAMES = ("init_gap", "pos_gap", "vel_gap", "dens_gap", "drho_gap",
         "force_gap", "kgc_gap", "tau_gap", "vmax_gap", "rerun_gap", "flags")


def fields(state) -> Fields:
    return Fields(*(getattr(state, k).double() for k in Fields._fields))


def _max(t) -> float:
    t = t.double()
    if not bool(torch.isfinite(t).all()):
        return math.inf
    return float(t.abs().max()) if t.numel() else 0.0


def _rel(a, b, scale) -> float:
    return _max(a - b) / scale if scale > 0 else _max(a - b)


def state_gaps(ch, prog: Fields, ref: Fields) -> dict:
    """The widest gap of each group of fields, in its scale."""
    dx = prog.x - ref.x
    dx = dx - ch.DL * torch.round(dx / ch.DL)
    u_max = 1.5 * ch.U_bulk
    return dict(
        pos_gap=max(_max(dx), _max(prog.y - ref.y)) / ch.dp,
        vel_gap=max(_rel(prog.vx, ref.vx, u_max),
                    _rel(prog.vy, ref.vy, u_max)),
        dens_gap=max(_rel(prog.rho, ref.rho, ch.rho0),
                     _rel(prog.p, ref.p, ch.p0),
                     _rel(prog.vol, ref.vol, ch.dp * ch.dp)),
        drho_gap=_rel(prog.drho_dt, ref.drho_dt, _max(ref.drho_dt)),
        force_gap=max(_rel(getattr(prog, k), getattr(ref, k),
                           _max(getattr(ref, k)))
                      for k in ("fx", "fy", "fpx", "fpy")),
        kgc_gap=max(_max(getattr(prog, k) - getattr(ref, k))
                    for k in ("b11", "b12", "b21", "b22")))


def density_gap(ch, rho, p, vol, B, ref) -> float:
    r_rho, r_p, r_vol, r_B = ref
    return max(_rel(rho, r_rho, ch.rho0), _rel(p, r_p, ch.p0),
               _rel(vol, r_vol, ch.dp * ch.dp),
               max(_max(a - b) for a, b in zip(B, r_B)))


def rerun(engine, start, interval):
    """The program's interval from ``start`` = (state, layout, pairs), cut
    at every sub-chunk group: [(state at the group's start, steps, clock
    and its compensation at the start)], and the last call's result."""
    st, lay, npairs = start
    f = type(interval)
    t_loc = t_cmp = f(0.0)
    sub_len, groups, res = None, [], None
    while True:
        kw = {} if sub_len is None else {"sub_len0": sub_len}
        res = engine.run_interval(st, lay, npairs, interval, max_steps=1,
                                  t_local0=t_loc, t_comp0=t_cmp, **kw)
        groups.append((st, int(res.n_steps), float(t_loc), float(t_cmp)))
        st, lay, npairs = res.state, res.cands, res.geom
        t_loc, t_cmp, sub_len = res.t_local, res.t_comp, res.sub_len
        if t_loc >= interval or res.n_steps == 0:
            return groups, res


def _output_flags(iv) -> bool:
    return (iv["overflow"] or iv["skin_guard"]
            or not all(math.isfinite(iv[k])
                       for k in ("tau_bottom", "tau_top", "v_max")))


def judge(run, wl: dict, control: bool = False) -> dict:
    """The numbers compared, by name, and the output points that failed."""
    ch = run.ch
    nf = run.n_fluid
    mass = run.mass
    interval = run.interval
    segments = int(wl["check"]["segments"])

    def ref64():
        return Reference(ch, mass, nf)

    def low():
        """The control: the reference in bfloat16, positions float32."""
        return Reference(ch, mass, nf, dtype=torch.bfloat16,
                         pos_dtype=torch.float32)

    g = dict.fromkeys(NAMES, 0.0)

    # the start: the density pass of the inputs
    st0 = fields(run.st0)
    want = ref64().density(st0)
    if control:
        rho, p, vol, B = low().density(st0)
        got = [rho.double(), p.double(), vol.double()]
        got_b = [b.double() for b in B]
    else:
        s = run.init[0]
        got = [s.rho.double(), s.p.double(), s.vol.double()]
        got_b = [getattr(s, k).double() for k in ("b11", "b12", "b21",
                                                   "b22")]
    g["init_gap"] = density_gap(ch, *got, got_b, want)

    # the sampled interval, re-run group by group
    (prev, res_k) = run.kept
    groups, last = rerun(run.engine, prev, interval)
    steps = sum(n for _, n, _, _ in groups)
    gap = max(_max(getattr(last.state, k).double()
                   - getattr(res_k.state, k).double())
              for k in Fields._fields)
    gap = max(gap, abs(steps - run.intervals[run.sampled - 1]["steps"]),
              _max(last.tau_bottom - res_k.tau_bottom),
              _max(last.tau_top - res_k.tau_top),
              _max(last.v_max - res_k.v_max))
    g["rerun_gap"] = gap

    rng = random.Random(f"{run.seed}:groups")
    m = len(groups)
    chosen = sorted({m - 1} | set(rng.sample(range(m - 1),
                                             min(segments - 1, m - 1))))
    # the start of the window: its first interval's first group
    first_res = None
    if run.sampled != 1 or 0 not in chosen:
        first_res = run.engine.run_interval(
            run.init[0], run.init[1], run.init[2], interval, max_steps=1)
    todo = [(groups[i][0], groups[i][1], groups[i][2], groups[i][3],
             groups[i + 1][0] if i + 1 < m else last.state, i == m - 1)
            for i in chosen]
    if first_res is not None:
        todo.append((run.init[0], int(first_res.n_steps), 0.0, 0.0,
                     first_res.state, False))

    for start, n, t0, tc0, end, is_last in todo:
        remain = float(interval) - (t0 - tc0) if is_last else None
        ref = ref64().run(fields(start), interval=remain,
                          n_steps=None if is_last else n)
        if control:
            out = low().run(fields(start), interval=remain,
                            n_steps=None if is_last else n)
            prog = out.state
            tau = (out.tau_bottom, out.tau_top)
            vmax = out.v_max
        else:
            prog = fields(end)
            tau = (float(last.tau_bottom), float(last.tau_top))
            vmax = float(last.v_max)
        for k, v in state_gaps(ch, prog, ref.state).items():
            g[k] = max(g[k], v)
        if is_last:
            g["tau_gap"] = max(abs(tau[0] - ref.tau_bottom),
                               abs(tau[1] - ref.tau_top)) / ch.tau_target
            g["vmax_gap"] = abs(vmax - ref.v_max) / (1.5 * ch.U_bulk)
            if not all(math.isfinite(v) for v in (*tau, vmax)):
                g["tau_gap"] = g["vmax_gap"] = math.inf

    bad = [i + 1 for i, iv in enumerate(run.intervals) if _output_flags(iv)]
    g["flags"] = float(len(bad) + bool(run.init[3]))
    return dict(gaps=g, dirty_points=bad, groups=m, chosen=chosen)


def verdict(gaps: dict, limits: dict):
    """[(name, value, limit)] in NAMES order, and whether all hold."""
    rows = [(k, gaps[k], float(limits[k])) for k in NAMES]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return rows, ok
