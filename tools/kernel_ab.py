#!/usr/bin/env python3
"""Time the kernels of one tree of this repository on the card (the wall
shear, the expand, the no-op, the step and chunk in the recompute, cache
and rows forms), and dump the shear's per-slot partials and the recompute
and rows forms' step and chunk outputs, so that two trees (a change and its
parent) can be compared in turns on one card.

    python3 tools/kernel_ab.py --root TREE --tag NAME [--cli N] [--cli-a]
        [--out DIR]
    python3 tools/kernel_ab.py --compare A.npz B.npz

``--root`` is the root of a checkout (this one, or a parent unpacked with
``git archive``); its ``sph_poiseuille_flow_torch`` and ``chip_smoke.py``
are imported, so each tree runs its own kernels and wrappers, built from its
own source. The inputs are the (b) grid of ``chip_smoke.py`` (the dp=0.01
channel with the shipping knobs, the seeded jitter, one plain step for the
shear's inputs). Measured, with CUDA events (``probe.event_ms``, best of
three rounds of 200):

* ``shear_call``: ``fused_wall_shear_cores`` as the engine calls it,
  wrapper and sums included;
* ``shear_kernel``: the shear kernel's own device time, the mean over
  200 of those calls in a ``torch.profiler`` capture (the kernels whose
  name holds "shear"; what else a tree's wrapper launches is left out);
* ``shear_wrapper`` (``fused_cell_cuda.wall_shear``, the wrapper and its
  launch), ``sums`` (one ``torch.sum`` and the division) and ``one_op``
  (one small torch op): where a call's time goes;
* ``expand`` and ``repeat``: the one-hot expand at the probe's (9K, nx) x K
  and ``Tensor.repeat``, both queued;
* ``noop`` and ``copy_``: the no-op on the (b) step's buffers and a row
  ``copy_`` of the same x row, five rounds of each in turns, queued;
* at (b), at dp=0.025 (``chip_smoke.DP0025``) and on the K=48 grid
  (``chip_smoke.K48``, where a window row is walked in pieces), in the
  recompute form ("none"), in the form "auto" picks (a cache form;
  ``cache_sweep_wide`` at K=48) and in the rows form, with the seeded
  jitter and a real dt: ``{grid}:{form}:step_bufs`` (the four sweeps on
  persistent buffers, ``StepBuffers``), ``{grid}:{form}:sweep{s}`` (each
  sweep relaunched on them), both queued, and ``{grid}:{form}:chunk16``
  (``fused_chunk_call``, 16 steps, as its caller sees it);
* with ``--cli N``: the (b) run of ``chip_smoke.py`` (0.3 s of flow under
  "auto" through the CLI) N times, their particle-steps/s;
* with ``--cli-a``: config.ini as shipped for 2 s through the CLI, its
  final state dumped to ``NAME_a.npz``.

Writes ``DIR/NAME.json`` (the times, the card's name and power limit;
``DIR`` is ``results/ab`` by default) and ``DIR/NAME.npz``: tb, tt of one
shear launch, and the recompute form's step outputs and 16-step chunk
outputs (state, cores, steps, clock) at (b), at config.ini's grid and at
K=48 (``{grid}:step:*``, ``{grid}:chunk16:*``), the rows form's there too
(``{grid}:rows:*``) and the cache form's at K=48 (``k48:cache:*``); each
of those is launched twice and the JSON's ``repeat_bit_equal`` says
whether the two launches agree bit for bit, ``rows_vs_none_bit_equal``
whether the rows form's outputs equal the recompute form's at each grid.
``--compare`` says whether two dumps are equal bit for bit, array by
array.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "results", "ab")


def _compare(a: str, b: str) -> int:
    import numpy as np
    with np.load(a) as za, np.load(b) as zb:
        same = {k: bool(np.array_equal(za[k].view(np.int32),
                                       zb[k].view(np.int32)))
                for k in za.files}
        nz = {k: int((za[k] != 0).sum()) for k in za.files}
    print(json.dumps({"compare": [a, b], "bit_equal": same,
                      "nonzero": nz}))
    return 0 if all(same.values()) else 1


def _kernel_ms(fn, name: str, n: int) -> float:
    """Mean device time (ms) of the kernels whose name holds ``name`` over
    ``n`` calls of ``fn``, from a torch.profiler capture."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA and name in e.name]
    if len(us) != n:
        raise RuntimeError(f"{len(us)} '{name}' kernels traced in {n} "
                           "calls")
    return sum(us) / n / 1e3


def _grid(cs, name: str, dev):
    """(cfg, spec, lay, the five state cores, scalars, dt) of a grid of
    chip_smoke.py with its seeded jitter."""
    from sph_poiseuille_flow_torch.config import derive_config, load_config
    from sph_poiseuille_flow_torch.ops.integration import verlet_dt
    cfg = (load_config(os.path.join(cs.ROOT, "config.ini")) if name == "a"
           else derive_config(**dict(b=cs.DP001, d025=cs.DP0025,
                                     k48=cs.K48)[name]))
    _, spec, lay, c, (vx, vy) = cs._jittered_case(cfg, dev)
    nf = spec.n_fluid
    dt = verlet_dt(vx[:nf], vy[:nf], cfg.c_f, cfg.h, cfg.nu, cfg.gravity_g,
                   1.0)
    args5 = (c["xH"], c["yH"], c["vxH"], c["vyH"], c["drP"])
    sc = (cfg.rho0, cfg.p0, cfg.c_f, cfg.inv_sigma0, cfg.transport_coeff,
          cfg.gravity_g, cfg.mu, cfg.wall_visc_factor)
    return cfg, spec, lay, args5, sc, dt


# the forms timed and dumped: (label, spec knobs)
FORMS = (("none", dict(geom_cache="none")), ("cache", {}),
         ("rows", dict(fused_rows="1")))


def _forms(cs, dev, dump: dict, ms: dict) -> tuple:
    """The recompute, cache and rows forms' times at (b), dp=0.025 and K=48
    into ``ms``; the recompute and rows forms' step and chunk outputs at
    (b), config.ini's grid and K=48, and the cache form's at K=48, into
    ``dump``. Returns whether two launches of each dumped call agreed bit
    for bit, and {grid: whether the rows form's dump equals the recompute
    form's bit for bit}."""
    import dataclasses
    import torch
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc
    from sph_poiseuille_flow_torch.probe import event_ms

    same, rows_none = True, {}
    for grid in ("b", "d025", "k48", "a"):
        cfg, spec, lay, args5, sc, dt = _grid(cs, grid, dev)
        R = fc.plan(spec)[0]
        for label, knobs in FORMS:
            fspec = dataclasses.replace(spec, **knobs)
            if grid != "a":
                form = fc.step_form(fspec, torch.float32)
                b = fcc.StepBuffers(fspec, R, lay, *args5, dt, sc, *form)
                b.sweeps(0, 4)
                key = f"{grid}:{label}"
                ms[f"{key}:step_bufs"] = event_ms(lambda: b.sweeps(0, 4),
                                                  200, queued=True)
                for s in range(4):
                    ms[f"{key}:sweep{s}"] = event_ms(
                        lambda s=s: b.sweeps(s, 1), 200, queued=True)
                ms[f"{key}:chunk16"] = event_ms(
                    lambda: fc.fused_chunk_call(fspec, lay, *args5, 0.0,
                                                0.0, 1.0, 16, *sc), 20)
            if grid == "d025" or (label == "cache" and grid != "k48"):
                continue
            runs = [(fc.fused_step_cores(fspec, lay, *args5, dt, *sc),
                     fc.fused_chunk_call(fspec, lay, *args5, 0.0, 0.0, 1.0,
                                         16, *sc)) for _ in range(2)]
            torch.cuda.synchronize()
            flat = []
            # the recompute form's keys keep their names of earlier dumps
            g = grid if label == "none" else f"{grid}:{label}"
            for step, (st, cores, *rest) in runs:
                d = {f"{g}:step:{k}": v for k, v in step.items()}
                d.update({f"{g}:chunk16:state:{k}": v
                          for k, v in st.items()})
                d.update({f"{g}:chunk16:aux:{k}": v
                          for k, v in cores.items()})
                d.update({f"{g}:chunk16:rest{i}": v.reshape(1)
                          for i, v in enumerate(rest)})
                flat.append({k: v.cpu().numpy() for k, v in d.items()})
            same &= all(flat[0][k].tobytes() == flat[1][k].tobytes()
                        for k in flat[0])
            dump.update(flat[0])
            if label == "rows":
                rows_none[grid] = all(
                    v.tobytes() == dump[k.replace(f"{grid}:rows:",
                                                  f"{grid}:")].tobytes()
                    for k, v in flat[0].items())
    return same, rows_none


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root")
    ap.add_argument("--tag")
    ap.add_argument("--cli", type=int, default=0, metavar="N")
    ap.add_argument("--cli-a", action="store_true")
    ap.add_argument("--compare", nargs=2, metavar="NPZ")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    if args.compare:
        return _compare(*args.compare)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from sph_poiseuille_flow_torch.config import derive_config
    from sph_poiseuille_flow_torch.ops import fused_cell as fc
    from sph_poiseuille_flow_torch.ops import fused_cell_cuda as fcc
    from sph_poiseuille_flow_torch.ops import probes
    from sph_poiseuille_flow_torch.probe import (_expand_input, card_line,
                                                 event_ms)
    from sph_poiseuille_flow_torch.utils import roofline

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    fcc.build()
    cfg = derive_config(**cs.DP001)
    _, spec, lay, c, (vx, vy) = cs._jittered_case(cfg, dev)
    from sph_poiseuille_flow_torch.ops.integration import verlet_dt
    nf = spec.n_fluid
    dt = verlet_dt(vx[:nf], vy[:nf], cfg.c_f, cfg.h, cfg.nu, cfg.gravity_g,
                   1.0)
    args5 = (c["xH"], c["yH"], c["vxH"], c["vyH"], c["drP"])
    sc = (cfg.rho0, cfg.p0, cfg.c_f, cfg.inv_sigma0, cfg.transport_coeff,
          cfg.gravity_g, cfg.mu, cfg.wall_visc_factor)
    o = fc.fused_step_cores_plain(spec, lay, *args5, dt, *sc)
    sh = (c["xH"], c["yH"], o["vxH"], o["volH"], o["b11H"], o["b12H"],
          o["b21H"], o["b22H"], cfg.mu, cfg.wall_visc_factor)
    R = fc.plan(spec)[0]

    out = fcc.wall_shear(spec, R, lay, *sh)
    tb, tt = out[0], out[1]
    torch.cuda.synchronize()
    dump = dict(tb=tb.cpu().numpy(), tt=tt.cpu().numpy())

    n = roofline.pair_counts(spec, lay, sh[0], sh[1])
    ms = {
        "shear_call": event_ms(
            lambda: fc.fused_wall_shear_cores(spec, lay, *sh), 200),
        "shear_kernel": _kernel_ms(
            lambda: fc.fused_wall_shear_cores(spec, lay, *sh), "shear", 200),
        # where a call's time goes: the wrapper and its launch alone, the
        # sums alone, one small torch op (the host's floor per launch)
        "shear_wrapper": event_ms(
            lambda: fcc.wall_shear(spec, R, lay, *sh), 200),
        "sums": event_ms(lambda: torch.sum(tb) / (-spec.DL), 200),
        "one_op": event_ms(lambda: tb.add(1.0), 200)}
    v = _expand_input(spec, dev)
    ms["expand"] = event_ms(lambda: probes.expand_onehot(v, spec.K), 200,
                            queued=True)
    ms["repeat"] = event_ms(lambda: v.repeat(1, spec.K), 200, queued=True)
    # the no-op on the step's buffers against a row copy_, in turns
    b = fcc.StepBuffers(spec, R, lay, *args5, dt, sc, "none", 0)
    b.sweeps(0, 4)
    src = args5[0][0, 0, :]
    row = torch.zeros_like(src)
    ms["noop"], ms["copy_"] = [], []
    for _ in range(5):
        ms["noop"].append(event_ms(b.noop, 200, queued=True))
        ms["copy_"].append(event_ms(lambda: row.copy_(src), 200,
                                    queued=True))
    same, rows_none = _forms(cs, dev, dump, ms)
    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, f"{args.tag}.npz"), **dump)
    res = dict(tag=args.tag, root=root, card=card_line(), ms=ms,
               repeat_bit_equal=same, rows_vs_none_bit_equal=rows_none,
               shear_bound=roofline.bound("shear", spec, n),
               expand_bound=roofline.expand_bound(9 * spec.K, spec.nx,
                                                  spec.K))
    if args.cli:
        ini = ("[physical]\nDL = 3.0\nDH = 1.0\ndp = 0.01\nrho0 = 1.0\n"
               "mu = 0.1\nU_bulk = 0.666667\nc_f = 15.0\n"
               f"[simulation]\nend_time = {cs.DP001['end_time']}\n"
               f"output_interval = {cs.DP001['output_interval']}\n"
               "sort_interval = 100\nrestart_from_file = 0\n")
        runs = [cs._run_cli(f"ab_{args.tag}", ini,
                            ["--neighbor-skin",
                             str(cs.DP001["neighbor_skin"]),
                             "--rebuild-every", "128", "--cell-capacity",
                             "14", "--lane-pack-nx", "100"])
                for _ in range(args.cli)]
        res["b_run"] = dict(psteps=[r["particle_steps_per_sec"]
                                    for r in runs],
                            steps=runs[-1]["step"],
                            wall=[r["wall_time_in_loop"] for r in runs],
                            tau_bottom=runs[-1]["tau_bottom"])
    if args.cli_a:
        # config.ini as shipped for 2 s (the (a) run cut short): its final
        # state, to hold two trees' trajectories against each other
        ra = cs._run_cli(f"ab_a_{args.tag}", None,
                         ["--set", "simulation.end_time=2", "--set",
                          "simulation.output_interval=1"])
        st = ra["final_state"]
        np.savez(os.path.join(args.out, f"{args.tag}_a.npz"),
                 **{f: getattr(st, f).cpu().numpy() for f in st._fields})
        res["a_run"] = dict(steps=ra["step"], L2=ra["L2_error"],
                            tau_bottom=ra["tau_bottom"])
    with open(os.path.join(args.out, f"{args.tag}.json"), "w") as f:
        json.dump(res, f)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
