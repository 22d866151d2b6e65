"""ms a step of the window in the program's range ``train.prepare`` (the
step's generator, batch transform and stripe); layer train.loop."""

from portbench.harness import readers


def read(run):
    return readers.span_ms_per(run, "program:train.prepare", per="steps")
