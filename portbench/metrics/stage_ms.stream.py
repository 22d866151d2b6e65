"""ms of host wall in stage_slide_fcn (the staging thread: read, pad,
pinned upload) per slide staged; layer infer.engine."""

from portbench.harness import readers


def read(run):
    return readers.span_ms_per(run, "stage")
