"""% of the card's dense bf16 peak: the reference's FLOPs of the slides
done over the traced window; layer models forward."""

from portbench.harness import readers


def read(run):
    return readers.stream_mfu(run)
