"""% of the traced window's device-busy time in the window-attention
kernels; layer ops.attention."""

from portbench.harness import swin_cost


def read(run):
    return swin_cost.wattn_share(run)
