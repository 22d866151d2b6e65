"""Operations and bytes of a Mix Transformer (SegFormer MiT) forward,
from the configuration and the input's shape alone.

The attention's two products (scores and the weighted sum) are
4·heads·N·M·d operations a block and image, N the stage's tokens and M
its reduced keys (N/R²): what a tensor-core peak measures, whatever
kernel computes them. Softmax, LayerNorm and GELU are not counted, as
:mod:`.flops` counts no element-wise work. The rest of the forward (the
convs and linears of the encoder, the FPN and the head) is
:func:`.flops.forward_flops`'s count on the plain reference, whose
attention is no module and adds nothing there.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.harness import flops, roofline


def attention_shapes(cfg: Dict, h: int, w: int) -> List[Tuple[int, ...]]:
    """(N, M, heads, d) of every attention call of one (h, w) image, in
    order (blocks of stage 1 first)."""
    out = []
    hh, ww = h, w
    for i, dim in enumerate(cfg["embed_dims"]):
        f = cfg["patch_strides"][i]
        hh, ww = -(-hh // f), -(-ww // f)
        r = cfg["sr_ratios"][i]
        heads = cfg["num_heads"][i]
        m = hh * ww if r == 1 else (hh // r) * (ww // r)
        out += [(hh * ww, m, heads, dim // heads)] * cfg["depths"][i]
    return out


def attention_cost(cfg: Dict, h: int, w: int) -> Tuple[float, float]:
    """(operations, bytes) of the attention of one (h, w) image: the two
    products; q, k and v read once and the output written once, 2 bytes
    each (bf16)."""
    ops = nbytes = 0.0
    for n, m, heads, d in attention_shapes(cfg, h, w):
        ops += 4.0 * heads * n * m * d
        nbytes += 2.0 * heads * d * (2 * n + 2 * m)
    return ops, nbytes


def forward_flops(cfg: Dict, h: int, w: int) -> float:
    """Operations of one (h, w) image's segmentation forward: the
    reference's convs and linears, and the attention's products."""
    return flops.forward_flops(cfg, 1, h, w) + attention_cost(cfg, h, w)[0]


# ---- the per-layer readers of a MiT cell (portbench/metrics/*.mit.py) ----

#: pieces of the attention kernels' names: FlashAttention-2's forward and
#: cuDNN's fused attention, as ``F.scaled_dot_product_attention`` launches
#: them on an H100
ATTN_KERNELS = ("flash_fwd", "fmha", "sdpa")
#: the program's range around each attention call
ATTN_RANGE = "program:mit.attention"


def _slide_hw(run) -> Tuple[int, int]:
    return tuple(run.cell.traffic["level2_hw"])


def mfu(run):
    """% of the card's bf16 peak: :func:`forward_flops` of every slide done
    over the traced window."""
    peak = roofline.peak_flops(run.kind)
    slides = run.window.get("slides", 0)
    if peak is None or not slides or run.trace is None:
        return None
    f = forward_flops(run.cell.config, *_slide_hw(run))
    return 100.0 * f * slides / (run.trace.window_s * peak)


def _attn_kernel_s(run):
    """Seconds of attention kernels in the trace, or None unless the
    trace holds one such kernel per call the program recorded."""
    t = run.trace
    calls = run.spans.count(ATTN_RANGE)
    if t is None or not calls or t.count(*ATTN_KERNELS) != calls:
        return None
    s = t.device_time(*ATTN_KERNELS)
    return s if s > 0 else None


def attn_roofline(run):
    """% of the attention's least time in its kernel time: the bound
    (:func:`.roofline.bound_s`) of :func:`attention_cost` × the slides
    done, over the summed attention kernel time."""
    peak = roofline.peak_flops(run.kind)
    slides = run.window.get("slides", 0)
    kernel_s = _attn_kernel_s(run)
    if peak is None or not slides or kernel_s is None:
        return None
    ops, nbytes = attention_cost(run.cell.config, *_slide_hw(run))
    return 100.0 * roofline.bound_s(ops * slides, nbytes * slides,
                                    peak) / kernel_s


def attn_share(run):
    """% of the window's device-busy time in the attention kernels."""
    kernel_s = _attn_kernel_s(run)
    if kernel_s is None or run.trace.busy_s() <= 0:
        return None
    return 100.0 * kernel_s / run.trace.busy_s()
