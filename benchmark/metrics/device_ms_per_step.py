"""Device time per step: the union of device activity in the traced
window over its steps, in milliseconds."""

LAYER = "device: one H100"
UNIT = "ms/step"
SOURCE = "device_trace"
MOVES = "particle_steps_per_s"


def read(r):
    t = r["trace"]
    if t is None or t["busy_s"] <= 0.0 or not r["steps"]:
        return None
    return 1000.0 * t["busy_s"] / r["steps"]
