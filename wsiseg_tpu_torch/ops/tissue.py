"""Tissue-mask extraction — counterpart of ``wsiseg_tpu/ops/tissue.py``
(``find_nuclei``): HSV saturation threshold, or LAB a-channel threshold,
then optionally fill-holes and a 10×10 close
(:mod:`wsiseg_tpu_torch.ops.morphology`)."""

from __future__ import annotations

import numpy as np
import torch

from wsiseg_tpu_torch.ops.color import rgb_to_hsv, rgb_to_lab
from wsiseg_tpu_torch.ops.morphology import closing, fill_holes


@torch.no_grad()
def find_nuclei(rgb_uint8, mu_percent: float = 0.1, mode: str = "hsv",
                fill_mask: bool = False) -> torch.Tensor:
    """Tissue mask from an (H, W, 3) uint8 RGB thumbnail (tensor or numpy).
    hsv mode: saturation > mu_percent; lab mode: a > (1+mu_percent)·mean(a).
    ``fill_mask``: fill holes, then a 10×10 close. Returns (H, W) uint8 in
    {0, 1}, on the input's device."""
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
    mask = mask.to(torch.uint8)
    if fill_mask:
        mask = closing(fill_holes(mask), 10)
    return mask
