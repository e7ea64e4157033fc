"""Host syncs of the interval loop per 1,000 steps: the sum of
``IntervalResult.n_syncs`` over the window's intervals."""

LAYER = "interval loop: stepper.PallasCellEngine.run_interval"
UNIT = "syncs/kstep"
SOURCE = "program_counter"
MOVES = "particle_steps_per_s"


def read(r):
    return 1000.0 * r["syncs"] / r["steps"] if r["steps"] else None
