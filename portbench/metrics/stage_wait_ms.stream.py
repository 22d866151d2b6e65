"""ms a slide of the window that the consumer waits in the program's
range ``pipeline.stage_wait`` (the staged group's future); layer
infer.evaluators."""

from portbench.harness import readers


def read(run):
    return readers.span_ms_per(run, "program:pipeline.stage_wait",
                               per="slides")
