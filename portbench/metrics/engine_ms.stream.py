"""ms of host wall in predict_slides_fcn/predict_slide_fcn (the consumer
thread) per slide they returned; layer infer.engine."""

from portbench.harness import readers


def read(run):
    return readers.span_ms_per(run, "engine")
