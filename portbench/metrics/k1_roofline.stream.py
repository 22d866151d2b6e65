"""% of K1's bytes bound in its summed kernel time; layer ops.stem."""

from portbench.harness import readers


def read(run):
    return readers.k1_roofline(run)
