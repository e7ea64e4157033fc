"""Sub-chunks rolled back by the drift guard per 1,000 steps (wasted
sub-chunks): the sum of ``IntervalResult.n_rollbacks`` over the window."""

LAYER = "rebuild and drift guard: ops/fused_cell build_fused_layout, pair_drift_bounds"
UNIT = "rollbacks/kstep"
SOURCE = "program_counter"
MOVES = "particle_steps_per_s"


def read(r):
    return 1000.0 * r["rollbacks"] / r["steps"] if r["steps"] else None
