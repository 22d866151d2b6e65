"""Per-class probability gating — counterpart of
``wsiseg_tpu/ops/threshold.py`` (``threshold_probs``,
``threshold_probs_planar``, ``pred_to_mask``), channels-last logits
``(H, W, C)`` in, in f32: ``torch.softmax`` over the class axis (JAX
takes the max-shifted exp over its sum; they agree within 1e-6), floors,
argmax.
:func:`gate` is the engine's every route's decision and :func:`heat_u8`
its heat quantiser; ``pred_to_mask`` draws class perimeters with
:mod:`wsiseg_tpu_torch.ops.morphology`.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from wsiseg_tpu_torch.ops.morphology import bwperim, dilate


@functools.lru_cache(maxsize=None)
def _floors(class_probs: Tuple[float, ...], dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """The class floors as a tensor on ``device``, made once: their copy
    from the host's pageable memory would block the host at every call."""
    return torch.tensor(class_probs, dtype=dtype, device=device)


def gate(x: torch.Tensor, class_probs: Sequence[float],
         dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The engine's one decision per pixel: softmax of ``x`` over ``dim``
    in its dtype, each class below its floor zeroed, argmax. Returns
    (labels u8, probs); ``labels`` lacks ``dim``. It never blocks the
    host: the floors are made on the device once per (floors, dtype,
    device) and kept, where a fresh copy from pageable memory would wait
    for the card at every call, and with it the fused route's launch."""
    probs = torch.softmax(x, dim=dim)
    shape = [1] * x.dim()
    shape[dim] = -1
    floors = _floors(tuple(class_probs), probs.dtype,
                     probs.device).view(shape)
    probs = torch.where(probs < floors, torch.zeros_like(probs), probs)
    return torch.argmax(probs, dim=dim).to(torch.uint8), probs


def heat_u8(heat: torch.Tensor, mask_u8: torch.Tensor) -> torch.Tensor:
    """Heat in [0, 1] zeroed off the tissue (``mask_u8`` 0, broadcast) and
    quantised to u8: ``clamp(round(heat · 255))``."""
    heat = heat * (mask_u8 > 0)
    return torch.clamp(torch.round(heat * 255.0), 0, 255).to(torch.uint8)


def threshold_probs(logits: torch.Tensor, class_probs: Sequence[float]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax over classes, classes below their floor zeroed, argmax.
    (H, W, C) logits → (labels u8 (H, W), probs (H, W, C))."""
    return gate(logits.float(), class_probs, -1)


def threshold_probs_planar(logits: torch.Tensor,
                           class_probs: Sequence[float]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`threshold_probs` computed on the planar (C, H, W) view of the
    (H, W, C) logits. Returns (labels u8 (H, W), probs (C, H, W))."""
    return gate(logits.permute(2, 0, 1).float(), class_probs, 0)


def pred_to_mask(labels: torch.Tensor, num_classes: int,
                 wsi: Optional[torch.Tensor] = None,
                 perim: bool = False) -> torch.Tensor:
    """Class labels rendered onto an RGB canvas, on the labels' device.
    Class c (1-based among non-background) lights channel c-1, for c in
    1 … min(num_classes, 4)-1; later classes overwrite earlier ones.

    labels: (H, W) integer classes (0 = background); wsi: optional
    (H, W, 3) backdrop (zeros when None); perim: draw each class's
    perimeter dilated by a 10×10 element instead of its region.
    Returns (H, W, 3) uint8."""
    h, w = labels.shape
    canvas = (torch.zeros((h, w, 3), dtype=torch.uint8, device=labels.device)
              if wsi is None else wsi.to(labels.device, torch.uint8).clone())
    for cj in range(1, min(num_classes, 4)):
        sel = labels == cj
        if perim:
            sel = dilate(bwperim(sel), 10)
        color = torch.zeros(3, dtype=torch.uint8, device=labels.device)
        color[cj - 1] = 255
        canvas = torch.where(sel[..., None], color, canvas)
    return canvas
