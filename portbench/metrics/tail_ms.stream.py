"""ms a slide of the window in the program's range ``engine.tail`` (the
host's unpack, interleave and heat to f32); layer infer.engine."""

from portbench.harness import readers


def read(run):
    return readers.span_ms_per(run, "program:engine.tail", per="slides")
