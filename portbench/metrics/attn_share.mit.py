"""% of the traced window's device-busy time in the attention kernels;
layer ops.attention."""

from portbench.harness import mit_cost


def read(run):
    return mit_cost.attn_share(run)
