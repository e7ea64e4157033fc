"""Device kernels per step: the kernel events of the traced window (copies
and memsets left out) over its steps."""

LAYER = "kernels: csrc/fused_cell.cu"
UNIT = "kernels/step"
SOURCE = "device_trace"
MOVES = "particle_steps_per_s"


def read(r):
    t = r["trace"]
    if t is None or not t["kernels"] or not r["steps"]:
        return None
    return t["kernels"] / r["steps"]
