"""The device's idle share of the traced window, in percent: one minus the
union of device activity over the window's wall time."""

LAYER = "device: one H100"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "particle_steps_per_s"


def read(r):
    t = r["trace"]
    if t is None or t["busy_s"] <= 0.0 or r["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / r["window_s"])
