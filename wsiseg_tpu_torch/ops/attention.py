"""Spatial-reduction attention: the port's one attention entry, used by
SegFormer's Mix Transformer encoder (:mod:`wsiseg_tpu_torch.models.mit`).

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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.profiler import record_function

#: sr_attention calls since import (or since a caller reset it to 0)
LAUNCHES = 0
#: operations of those calls' two products, 4·B·heads·N·M·d each
FLOPS = 0

#: the backend of 16-bit operands on a card
CUDA_BACKEND = SDPBackend.CUDNN_ATTENTION


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
