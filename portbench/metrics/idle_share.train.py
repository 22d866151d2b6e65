"""% of the traced window with nothing running on the device."""

from portbench.harness import readers


def read(run):
    return readers.idle_share(run)
