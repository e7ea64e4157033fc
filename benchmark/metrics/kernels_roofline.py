"""The window's work at the card's peaks over the device's busy time, in
percent: the least time of the scheme's operations and bytes, counted
from the particle state at every output point (``benchmark/work.py``),
over the union of device activity in the traced window."""

LAYER = "kernels: csrc/fused_cell.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "particle_steps_per_s"


def read(r):
    t = r["trace"]
    if t is None or r["least_s"] is None or t["busy_s"] <= 0.0:
        return None
    return 100.0 * r["least_s"] / t["busy_s"]
