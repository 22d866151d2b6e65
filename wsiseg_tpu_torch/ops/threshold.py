"""Per-class probability gating — counterpart of
``wsiseg_tpu/ops/threshold.py`` (``threshold_probs``,
``threshold_probs_planar``), channels-last logits ``(H, W, C)`` in, the
same f32 arithmetic (max-shifted exp over the class axis, floors, argmax).

``pred_to_mask`` draws class perimeters with ``ops/morphology``, which is
not ported yet, and raises.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _gate(x: torch.Tensor, class_probs: Sequence[float],
          dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    probs = e / e.sum(dim=dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = -1
    floors = torch.tensor(class_probs, dtype=probs.dtype,
                          device=probs.device).view(shape)
    probs = torch.where(probs < floors, torch.zeros_like(probs), probs)
    return torch.argmax(probs, dim=dim).to(torch.uint8), probs


def threshold_probs(logits: torch.Tensor, class_probs: Sequence[float]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax over classes, classes below their floor zeroed, argmax.
    (H, W, C) logits → (labels u8 (H, W), probs (H, W, C))."""
    return _gate(logits.float(), class_probs, -1)


def threshold_probs_planar(logits: torch.Tensor,
                           class_probs: Sequence[float]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`threshold_probs` computed on the planar (C, H, W) view of the
    (H, W, C) logits. Returns (labels u8 (H, W), probs (C, H, W))."""
    return _gate(logits.permute(2, 0, 1).float(), class_probs, 0)


def pred_to_mask(labels, num_classes: int, wsi=None, perim: bool = False):
    """Class labels rendered onto an RGB canvas (JAX ``pred_to_mask``)."""
    raise NotImplementedError(
        "pred_to_mask needs ops/morphology, not ported yet: ROADMAP.md, "
        "queue 1, 'the other eval CLIs'")
