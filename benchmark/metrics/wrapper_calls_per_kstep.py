"""Calls of the kernel wrappers per 1,000 steps: the sum of
``ops/fused_cell_cuda.LAUNCHES`` over the window."""

LAYER = "form resolution and wrappers: ops/fused_cell_cuda"
UNIT = "calls/kstep"
SOURCE = "program_counter"
MOVES = "particle_steps_per_s"


def read(r):
    return 1000.0 * r["launches"] / r["steps"] if r["steps"] else None
