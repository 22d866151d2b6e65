"""The bench geometry's synthetic level-2 image, shared by
``chip_smoke.py`` and :mod:`wsiseg_tpu_torch.profile_routes`."""

from __future__ import annotations

import numpy as np


def level2_image(height: int, width: int, seed: int) -> np.ndarray:
    """Tissue-like level-2 image with dense foreground (bench.py's
    synthetic slide: 40 purple blobs on 244-white plus ±15 noise)."""
    rng = np.random.RandomState(seed)
    img = np.full((height, width, 3), 244, dtype=np.uint8)
    for _ in range(40):
        cy, cx = rng.randint(0, height), rng.randint(0, width)
        ry = rng.randint(height // 12, height // 4)
        rx = rng.randint(width // 12, width // 4)
        y0, y1 = max(0, cy - ry), min(height, cy + ry + 1)
        x0, x1 = max(0, cx - rx), min(width, cx + rx + 1)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        blob = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0
        color = np.array([120 + rng.randint(-30, 30),
                          40 + rng.randint(-20, 40),
                          150 + rng.randint(-30, 40)])
        img[y0:y1, x0:x1][blob] = np.clip(color, 0, 255).astype(np.uint8)
    noise = rng.randint(-15, 15, size=img.shape).astype(np.int16)
    return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)
