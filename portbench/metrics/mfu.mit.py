"""% of the card's dense bf16 peak: the reference's conv and linear FLOPs
and the attention's analytic FLOPs of the slides done, over the traced
window; layer models forward."""

from portbench.harness import mit_cost


def read(run):
    return mit_cost.mfu(run)
