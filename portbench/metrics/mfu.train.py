"""% of the card's dense bf16 peak: 3 × the reference's forward FLOPs of
the patches of the window's complete steps, over the window; layer
train.steps."""

from portbench.harness import readers


def read(run):
    return readers.train_mfu(run)
