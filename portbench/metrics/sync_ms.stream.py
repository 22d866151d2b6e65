"""ms a slide of the window in the program's range ``engine.sync`` (the
host's wait for a group's queued forward and postprocess); layer
infer.engine."""

from portbench.harness import readers


def read(run):
    return readers.span_ms_per(run, "program:engine.sync", per="slides")
