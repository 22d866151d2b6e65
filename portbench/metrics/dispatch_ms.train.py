"""ms a step of the window in the program's range ``train.step`` (the
host's time in step_fn: the step's launches, and any wait in them);
layer train.steps."""

from portbench.harness import readers


def read(run):
    return readers.span_ms_per(run, "program:train.step", per="steps")
