"""ms a step the loop waits on its batch iterator (prefetch_to_device over
the cache's index batches); layer train.loop."""

from portbench.harness import readers


def read(run):
    return readers.span_ms_per(run, "loader", per="steps")
