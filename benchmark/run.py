"""The benchmark of the PyTorch and CUDA port of the SPH Poiseuille solver.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the CUDA card of this machine:
set-up, then output intervals for ``--seconds`` of wall time, then the
check of the outputs against the plain reference. Prints the result as
one JSON line, last on standard output, and each number compared beside
its limit as the last lines of standard error. ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a
capture of the device's activity over the window. Exits with a code
other than 0, and prints no result, without enough CUDA cards, on any
failure, or if the JAX package or JAX was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    from benchmark import harness
    sys.exit(harness.main(parse(), T0))
