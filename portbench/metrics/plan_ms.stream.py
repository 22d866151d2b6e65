"""ms of host wall in the program's plan_slide per slide planned (level-2
read, tissue mask, tile grid); layer data.wsi_tiles."""

from portbench.harness import readers


def read(run):
    return readers.span_ms_per(run, "plan")
