"""Operations and bytes of a Swin Transformer under UPerNet, from the
configuration and the input's shape alone.

The window attention's two products (scores and the weighted sum) are
4·windows·heads·N²·d operations a block and image, N = window² tokens of
a window and ``windows`` those of the stage's map zero-padded to
multiples of the window: what a tensor-core peak measures, whatever
kernel computes them, counted once a window (an implementation that
computes some windows twice does more than this work). Its bytes: q, k,
v and the output read or written once in bf16 (2 bytes), the (heads, N,
N) relative position bias once a block, and on a shifted block the
(N, N) masks of the windows whose mask is not zero (those of the last
window row and column). Softmax, LayerNorm and GELU are not counted, as
:mod:`.flops` counts no element-wise work. The rest of the forward (the
patch embedding, qkv and proj over the padded windows, the MLPs over the
real tokens, the patch mergings, UPerNet's convs and the head) is
:func:`.flops.forward_flops`'s count on the plain reference, whose
attention products are no module and add nothing there.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.harness import flops, roofline


def stage_maps(cfg: Dict, h: int, w: int) -> List[Tuple[int, int]]:
    """Each stage's token map of one (h, w) image: ⌈h/patch⌉ × ⌈w/patch⌉,
    then halved, rounding up, by each patch merging."""
    p = cfg["patch_size"]
    hh, ww = -(-h // p), -(-w // p)
    out = []
    for _ in cfg["depths"]:
        out.append((hh, ww))
        hh, ww = -(-hh // 2), -(-ww // 2)
    return out


def attention_shapes(cfg: Dict, h: int, w: int) -> List[Tuple[int, ...]]:
    """(windows, heads, N, d, masked windows) of every block of one (h, w)
    image, in order (stage 1's first); masked windows 0 on unshifted
    blocks."""
    ws = cfg["window_size"]
    out = []
    for i, (hh, ww) in enumerate(stage_maps(cfg, h, w)):
        nh, nw = -(-hh // ws), -(-ww // ws)
        heads = cfg["num_heads"][i]
        d = cfg["embed_dim"] * 2 ** i // heads
        for j in range(cfg["depths"][i]):
            out.append((nh * nw, heads, ws * ws, d,
                        nh + nw - 1 if j % 2 else 0))
    return out


def attention_cost(cfg: Dict, h: int, w: int) -> Tuple[float, float]:
    """(operations, bytes) of the window attention of one (h, w) image."""
    ops = nbytes = 0.0
    for windows, heads, n, d, masked in attention_shapes(cfg, h, w):
        ops += 4.0 * windows * heads * n * n * d
        nbytes += 2.0 * (4 * windows * heads * n * d + heads * n * n
                         + masked * n * n)
    return ops, nbytes


def forward_flops(cfg: Dict, h: int, w: int) -> float:
    """Operations of one (h, w) image's segmentation forward: the
    reference's convs and linears, and the window attention's
    products."""
    return flops.forward_flops(cfg, 1, h, w) + attention_cost(cfg, h, w)[0]


# ---- the per-layer readers of a Swin cell (portbench/metrics/*.swin.py) --

#: pieces of the window-attention kernels' names, as
#: ``F.scaled_dot_product_attention`` launches them on an H100 (the
#: memory-efficient backend's ``fmha_cutlassF``, cuDNN's, flash's)
WATTN_KERNELS = ("fmha", "flash_fwd", "sdpa")
#: the program's range around each window-attention launch
WATTN_RANGE = "program:swin.attention"


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


def _wattn_kernel_s(run):
    """Seconds of window-attention kernels in the trace, or None unless
    the trace holds one such kernel per launch the program recorded (one
    range a launch, so the range's count in the window is the window's
    ``WINDOW_LAUNCHES``)."""
    t = run.trace
    launches = run.spans.count(WATTN_RANGE)
    if t is None or not launches or t.count(*WATTN_KERNELS) != launches:
        return None
    s = t.device_time(*WATTN_KERNELS)
    return s if s > 0 else None


def wattn_roofline(run):
    """% of the window attention's least time in its kernel time: the
    bound (:func:`.roofline.bound_s`) of :func:`attention_cost` × the
    slides done, over the summed kernel time."""
    peak = roofline.peak_flops(run.kind)
    slides = run.window.get("slides", 0)
    kernel_s = _wattn_kernel_s(run)
    if peak is None or not slides or kernel_s is None:
        return None
    ops, nbytes = attention_cost(run.cell.config, *_slide_hw(run))
    return 100.0 * roofline.bound_s(ops * slides, nbytes * slides,
                                    peak) / kernel_s


def wattn_share(run):
    """% of the window's device-busy time in the window-attention
    kernels."""
    kernel_s = _wattn_kernel_s(run)
    if kernel_s is None or run.trace.busy_s() <= 0:
        return None
    return 100.0 * kernel_s / run.trace.busy_s()
