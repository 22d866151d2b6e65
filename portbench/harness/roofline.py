"""The card's peaks and the least time a kernel could take.

Copies, frozen here, of the port's roofline arithmetic
(``wsiseg_tpu_torch/probes.py``: ``stem_cost``, ``bound``) and of its
table of dense bf16 peaks (``wsiseg_tpu_torch/utils/profiling.py``:
``PEAK_TFLOPS``). Figures from NVIDIA's H100 data sheet, dense (no
sparsity), at the form factor's full power limit; the card's
``power.limit`` is recorded beside every run.
"""

from __future__ import annotations

from typing import Optional

#: HBM3 bandwidth of an H100 SXM5, bytes/s
HBM_BYTES_PER_S = 3.35e12
#: dense bf16 tensor-core peak, TFLOP/s, keyed by a piece of
#: ``torch.cuda.get_device_name()`` lower-cased without spaces
PEAK_TFLOPS = {
    "h10080gbhbm3": 989.0,   # H100 SXM5, "NVIDIA H100 80GB HBM3", 700 W
    "h100sxm": 989.0,
    "h100pcie": 756.0,
    "h100nvl": 835.0,
}


def peak_flops(kind: str) -> Optional[float]:
    """The card's dense bf16 peak in FLOP/s, or None for a card the table
    lacks (a share of it is then left out, never guessed)."""
    key_of = kind.lower().replace(" ", "")
    for key in sorted(PEAK_TFLOPS, key=len, reverse=True):
        if key in key_of:
            return PEAK_TFLOPS[key] * 1e12
    return None


def stem_cost(h: int, w: int, pool: bool = True):
    """(operations, bytes) of the stem on one (h, w) u8 image: the 7×7/2
    conv's useful operations (147 taps × 64 channels), the image read
    once, the outputs written once in bf16 (s2d(c1) and the pooled c1, or
    c1), and the weights (bf16) and bias (f32) read once."""
    c1 = (h // 2) * (w // 2) * 64 * 2
    out = c1 + c1 // 4 if pool else c1
    return (2.0 * (h // 2) * (w // 2) * 147 * 64,
            h * w * 3 + out + 147 * 64 * 2 + 64 * 4)


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)
