"""ms a slide of the window in the program's range ``engine.d2h`` (the
packed labels and heat planes copied to the host); layer infer.engine."""

from portbench.harness import readers


def read(run):
    return readers.span_ms_per(run, "program:engine.d2h", per="slides")
