"""ms of host wall in the program's range ``plan.filter``
(filter_grid_by_mask, the tile grid's foreground gate) per slide planned;
layer data.wsi_tiles."""

from portbench.harness import readers


def read(run):
    return readers.span_ms_per(run, "program:plan.filter")
