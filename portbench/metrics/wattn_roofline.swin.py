"""% of the window attention's least time (its analytic FLOPs and bytes)
in the summed time of its kernels; layer ops.attention."""

from portbench.harness import swin_cost


def read(run):
    return swin_cost.wattn_roofline(run)
