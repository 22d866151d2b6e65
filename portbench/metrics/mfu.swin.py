"""% of the card's dense bf16 peak: the reference's conv and linear FLOPs
and the window attention's analytic FLOPs of the slides done, over the
traced window; layer models forward."""

from portbench.harness import swin_cost


def read(run):
    return swin_cost.mfu(run)
