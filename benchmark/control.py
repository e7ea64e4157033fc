"""Readings that set a cell's limits, on the card at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 1]

For each seed of ``--seeds``: a run of the cell's driver with a short
window at the cell's load, and the numbers its check compares (the
program's readings: the lower ones). For each seed of
``--control-seeds``: the same run, judged with the lower-precision
control in the program's place (the reference in bfloat16, positions in
float32; the upper readings). One JSON line per seed, then one line with
the largest of each number over the program's seeds and the smallest over
the control's. All seeds run in one process, so the set-up is paid once.
The benchmark's runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def readings(workload, seeds, control_seeds, seconds, device,
             bench_dir=None):
    """{"program": {name: largest}, "control": {name: smallest}} and the
    per-seed rows, from runs of ``workload`` on ``device``."""
    from benchmark import check, harness
    bench_dir = bench_dir or harness.BENCH_DIR
    wl = harness.load_json(harness.find(bench_dir, "workloads", workload))
    conf = harness.load_json(harness.find(bench_dir, "configs",
                                          wl["config"]))
    driver = harness.load_module(bench_dir, "drivers", wl["driver"])
    rows = []
    for seed, ctl in ([(s, False) for s in seeds]
                      + [(s, True) for s in control_seeds]):
        t = time.perf_counter()
        run = driver.run(conf, wl, seed, seconds, False, device, t)
        j = check.judge(run, wl, control=ctl)
        rows.append(dict(seed=seed, control=ctl, gaps=j["gaps"],
                         sampled=run.sampled, groups=j["groups"],
                         seconds=time.perf_counter() - t))
        print(json.dumps(rows[-1]), flush=True)
    prog = [r["gaps"] for r in rows if not r["control"]]
    ctl = [r["gaps"] for r in rows if r["control"]]
    summary = dict(
        program={k: max(g[k] for g in prog) for k in check.NAMES} if prog
        else None,
        control={k: min(g[k] for g in ctl) for k in check.NAMES} if ctl
        else None)
    return summary, rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    a = p.parse_args(argv)
    from benchmark import harness
    harness.set_process_env()
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2

    def ints(s):
        return [int(v) for v in s.split(",") if v.strip()]

    summary, _ = readings(a.workload, ints(a.seeds), ints(a.control_seeds),
                          a.seconds, "cuda:0")
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
