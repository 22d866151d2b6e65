"""ms of host wall in the program's range ``plan.mask`` (the cached
tissue mask's PNG decode, or find_nuclei and its save) per slide planned;
layer data.wsi_tiles."""

from portbench.harness import readers


def read(run):
    return readers.span_ms_per(run, "program:plan.mask")
