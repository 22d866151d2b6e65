"""ms of card 0's device time a step in NCCL kernels (the gradient
all-reduce and BatchNorm's moment all-reduces, forward and backward);
layer parallel.comm."""

NCCL_PATTERNS = ("nccl",)


def read(run):
    t, steps = run.trace, run.window.get("steps", 0)
    if t is None or not steps or not t.count(*NCCL_PATTERNS):
        return None
    return 1e3 * t.device_time(*NCCL_PATTERNS) / steps
