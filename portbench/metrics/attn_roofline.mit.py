"""% of the attention's least time (its analytic FLOPs and bytes) in the
summed time of its kernels; layer ops.attention."""

from portbench.harness import mit_cost


def read(run):
    return mit_cost.attn_roofline(run)
