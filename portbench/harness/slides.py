"""Synthetic level-2 slide images, made from the seed on the device.

A vectorised twin of the port's bench slide
(``wsiseg_tpu_torch/data/bench_slide.level2_image``), frozen here: a
244-white background, 40 elliptical purple blobs whose half-axes are
uniform in [h/12, h/4) and [w/12, w/4), blob colours around (120, 40,
150), and integer noise uniform in [-15, 15) on every channel. The
original draws with numpy's ``RandomState`` one blob at a time (about
2.2 s a 4096×3072 image on one CPU core); this one draws every number
for every image in a few calls to one ``torch.Generator`` on the device,
so the same seed on the same device gives the same images.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

BLOBS = 40


def level2_images(n: int, height: int, width: int,
                  generator: torch.Generator, blobs: int = BLOBS,
                  labels: bool = False) -> List:
    """``n`` (height, width, 3) uint8 images, each on the host; with
    ``labels``, (image, label map) pairs, the label of a pixel 1 + b mod 3
    for the last blob b that covers it, 0 on the background."""
    dev = generator.device
    u = torch.rand((n, blobs, 7), generator=generator, device=dev,
                   dtype=torch.float64)
    cy = (u[..., 0] * height).floor()
    cx = (u[..., 1] * width).floor()
    ry = (height // 12 + u[..., 2] * (height // 4 - height // 12)).floor()
    rx = (width // 12 + u[..., 3] * (width // 4 - width // 12)).floor()
    lo = torch.tensor([90.0, 20.0, 120.0], device=dev, dtype=torch.float64)
    span = torch.tensor([60.0, 60.0, 70.0], device=dev, dtype=torch.float64)
    color = (lo + (u[..., 4:7] * span).floor()).clamp(0, 255).to(torch.uint8)
    noise = torch.randint(-15, 15, (n, height, width, 3),
                          generator=generator, device=dev,
                          dtype=torch.int16)
    yy = torch.arange(height, device=dev, dtype=torch.float64)
    xx = torch.arange(width, device=dev, dtype=torch.float64)
    out = []
    for k in range(n):
        img = torch.full((height, width, 3), 244, dtype=torch.uint8,
                         device=dev)
        lab = torch.zeros((height, width), dtype=torch.uint8, device=dev)
        for b in range(blobs):       # later blobs paint over earlier ones
            dy = ((yy - cy[k, b]) / ry[k, b]) ** 2
            dx = ((xx - cx[k, b]) / rx[k, b]) ** 2
            inside = (dy[:, None] + dx[None, :]) <= 1.0
            img[inside] = color[k, b]
            if labels:
                lab[inside] = 1 + b % 3
        img = (img.to(torch.int16) + noise[k]).clamp(0, 255).to(torch.uint8)
        out.append((img.cpu().numpy(), lab.cpu().numpy()) if labels
                   else img.cpu().numpy())
    return out


def tissue_mask(rgb_u8: np.ndarray) -> np.ndarray:
    """(H, W) uint8 {0, 1} tissue mask: HSV saturation over 0.1, as the
    reference's ``find_nuclei`` thresholds it, computed in float32 in the
    same order of operations (max, min, their difference over the max)."""
    img = torch.from_numpy(rgb_u8).float() / 255.0
    maxc = img.max(dim=-1).values
    minc = img.min(dim=-1).values
    delta = maxc - minc
    s = torch.where(maxc == 0, torch.zeros_like(delta),
                    delta / torch.where(maxc == 0, torch.ones_like(maxc),
                                        maxc))
    return (s > 0.1).to(torch.uint8).numpy()
