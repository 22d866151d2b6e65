"""Tissue-mask extraction — counterpart of ``wsiseg_tpu/ops/tissue.py``
(``find_nuclei``): HSV saturation threshold, or LAB a-channel threshold."""

from __future__ import annotations

import numpy as np
import torch

from wsiseg_tpu_torch.ops.color import rgb_to_hsv, rgb_to_lab


@torch.no_grad()
def find_nuclei(rgb_uint8, mu_percent: float = 0.1, mode: str = "hsv",
                fill_mask: bool = False) -> torch.Tensor:
    """Tissue mask from an (H, W, 3) uint8 RGB thumbnail (tensor or numpy).
    hsv mode: saturation > mu_percent; lab mode: a > (1+mu_percent)·mean(a).
    Returns (H, W) uint8 in {0, 1}. ``fill_mask`` (fill-holes + 10×10
    close) needs the morphology port and raises."""
    if fill_mask:
        raise NotImplementedError(
            "find_nuclei(fill_mask=True) needs ops/morphology, not ported "
            "yet: ROADMAP.md, queue 1, 'the other eval CLIs'")
    if not isinstance(rgb_uint8, torch.Tensor):
        rgb_uint8 = torch.from_numpy(np.array(rgb_uint8))
    img = rgb_uint8.float() / 255.0
    if mode == "hsv":
        mask = rgb_to_hsv(img)[..., 1] > mu_percent
    elif mode == "lab":
        a = rgb_to_lab(img)[..., 1]
        mask = a > (1.0 + mu_percent) * a.mean()
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return mask.to(torch.uint8)
