"""The port's attention entries: :func:`sr_attention`, the spatial-reduction
attention of SegFormer's Mix Transformer encoder
(:mod:`wsiseg_tpu_torch.models.mit`), and :func:`window_attention`, the
shifted-window attention of the Swin Transformer encoder
(:mod:`wsiseg_tpu_torch.models.swin`).

:func:`sr_attention` computes ``softmax(q kᵀ / √d) v`` for (B, heads, N, d)
queries over (B, heads, M, d) keys and values. In the MiT encoder the
queries are every token of a stage's map and the keys and values come
from that map reduced R×R (M = N/R²), so the score matrix is never held:

- on a card, bf16 and f16 operands go to ``F.scaled_dot_product_attention``
  restricted to its cuDNN backend (a fused ``wgmma`` flash kernel, scores
  never in memory): at the MiT-B5 stage shapes of four 3072×4096 slides
  on an H100 it ran at 472–495 TFLOP/s, the flash backend
  (FlashAttention-2) at 318–325 and the memory-efficient one at 139–143;
  other dtypes take the library's own dispatch;
- on the CPU, the math backend: the explicit product, softmax and
  product, the plain version the tests hold the reference against.

``LAUNCHES`` counts calls and ``FLOPS`` their two products' operations,
4·B·heads·N·M·d a call, since import (or since a caller reset them to
0). Each call runs in range ``mit.attention``.

:func:`window_attention` computes ``softmax(q kᵀ·scale + B + M) v`` in
each window of a Swin stage: many small problems (N = 144 tokens of a
12×12 window, d = 32) with an additive relative position bias ``B``
shared by every window and a shift mask ``M`` that is zero everywhere but
in the windows of the last window row and column of a shifted block (149
of stage 1's 5,504 windows at 3072×4096). A mask over every window and
head would be 3.65 GB in bf16 for a 4-slide group's stage 1, so it is
never made: one launch takes every window with the bias alone (broadcast,
no copy), a second takes the boundary windows again with bias + mask and
their outputs replace the first's there. On a card 16-bit operands take
``WINDOW_BACKEND``, cuDNN's fused kernel with the bias as an additive
mask: at Swin-B's stage shapes of a 4-slide group on an H100 it took
7.30, 3.63, 1.89 and 0.95 ms a call, the memory-efficient kernel 8.57,
4.25, 2.44 and 1.11, and the flash backend refuses a mask; a bias that
needs a gradient (training) takes the memory-efficient kernel, whose
backward gives one. On the CPU the math backend. Each launch runs in range
``swin.attention`` and counts one in ``WINDOW_LAUNCHES``;
``WINDOW_FLOPS`` counts its two products (4·windows·heads·N²·d) and
``WINDOW_BYTES`` its q, k, v and output in the operands' dtype plus the
bias (and mask) it reads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.profiler import record_function

#: sr_attention calls since import (or since a caller reset it to 0)
LAUNCHES = 0
#: operations of those calls' two products, 4·B·heads·N·M·d each
FLOPS = 0
#: window-attention launches since import (or since a caller reset it)
WINDOW_LAUNCHES = 0
#: operations of those launches' two products, 4·windows·heads·N²·d each
WINDOW_FLOPS = 0
#: bytes those launches read and write: q, k, v, output, bias and mask
WINDOW_BYTES = 0

#: the backend of 16-bit operands on a card
CUDA_BACKEND = SDPBackend.CUDNN_ATTENTION
#: the backend of 16-bit window attention on a card (a bias broadcast over
#: the windows as its additive mask)
WINDOW_BACKEND = SDPBackend.CUDNN_ATTENTION


def _backends(q: torch.Tensor):
    if q.device.type != "cuda":
        return [SDPBackend.MATH]
    if q.dtype in (torch.bfloat16, torch.float16):
        return [CUDA_BACKEND]
    return [SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]


def sr_attention(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """(B, h, N, d) queries, (B, h, M, d) keys and values → (B, h, N, d),
    ``softmax(q kᵀ / √d) v`` in the operands' dtype."""
    global LAUNCHES, FLOPS
    b, h, n, d = q.shape
    LAUNCHES += 1
    FLOPS += 4 * b * h * n * k.shape[2] * d
    with record_function("mit.attention"), sdpa_kernel(_backends(q)):
        return F.scaled_dot_product_attention(q, k, v)


def _window_backends(q: torch.Tensor, mask: torch.Tensor):
    if q.device.type != "cuda":
        return [SDPBackend.MATH]
    if q.dtype in (torch.bfloat16, torch.float16) and not (
            torch.is_grad_enabled() and mask.requires_grad):
        return [WINDOW_BACKEND]
    return [SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor, scale: float) -> torch.Tensor:
    """One launch over (W, h, N, d) windows with an additive (1 or W, h,
    N, N) ``mask``."""
    global WINDOW_LAUNCHES, WINDOW_FLOPS, WINDOW_BYTES
    w, h, n, d = q.shape
    WINDOW_LAUNCHES += 1
    WINDOW_FLOPS += 4 * w * h * n * n * d
    WINDOW_BYTES += (4 * w * h * n * d + mask.shape[0] * h * n * n) \
        * q.element_size()
    with record_function("swin.attention"), \
            sdpa_kernel(_window_backends(q, mask)):
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask.expand(w, h, n, n), scale=scale)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor,
                     masked: Optional[Tuple[torch.Tensor, torch.Tensor]]
                     = None, scale: Optional[float] = None
                     ) -> torch.Tensor:
    """(B, nW, h, N, d) queries, keys and values of each image's nW
    windows, the (h, N, N) relative position bias → (B, nW, h, N, d),
    ``softmax(q kᵀ·scale + bias + mask) v`` in the operands' dtype
    (``scale`` defaults to d^-½). ``masked``, for a shifted block: (idx,
    masks), the (nb,) windows of a map whose shift mask is not zero and
    their (nb, N, N) additive masks; every other window's mask is zero."""
    b, nw, h, n, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    bias = bias.to(q.dtype).contiguous()
    flat = [t.reshape(b * nw, h, n, d) for t in (q, k, v)]
    out = _launch(*flat, bias[None], scale).view(b, nw, h, n, d)
    if masked is None:
        return out
    idx, masks = masked
    nb = idx.shape[0]
    sub = [t.index_select(1, idx).reshape(b * nb, h, n, d)
           for t in (q, k, v)]
    m = (bias[None] + masks[:, None].to(q.dtype)).expand(b, nb, h, n, n)
    got = _launch(*sub, m.reshape(b * nb, h, n, n), scale) \
        .view(b, nb, h, n, d)
    # the first launch's output is saved for its backward: no in-place
    # write where autograd records
    if out.requires_grad:
        return out.index_copy(1, idx, got)
    return out.index_copy_(1, idx, got)
