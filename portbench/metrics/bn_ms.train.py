"""ms of device time a step in BatchNorm kernels (forward and backward),
found by kernel name as the port's ``profile_train`` classes them;
layer train.steps."""

BN_PATTERNS = ("batch_norm", "batchnorm", "bn_")


def read(run):
    t, steps = run.trace, run.window.get("steps", 0)
    if t is None or not steps or not t.count(*BN_PATTERNS):
        return None
    return 1e3 * t.device_time(*BN_PATTERNS) / steps
