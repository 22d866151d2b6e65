"""Color-space conversions — counterpart of ``wsiseg_tpu/ops/color.py``
(``rgb_to_hsv``, ``rgb_to_lab``, ``normalize``), same f32 element-wise
math. All functions take float32 RGB in [0, 1] with channels last."""

from __future__ import annotations

from typing import Sequence

import torch

# sRGB → XYZ (D65) matrix, rows = X, Y, Z.
_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB→HSV with H, S, V all in [0, 1] (skimage convention)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    safe_delta = torch.where(delta == 0, torch.ones_like(delta), delta)
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(delta == 0, torch.zeros_like(h), h)
    s = torch.where(maxc == 0, torch.zeros_like(delta),
                    delta / torch.where(maxc == 0, torch.ones_like(maxc),
                                        maxc))
    return torch.stack([h, s, maxc], dim=-1)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB→CIELAB (D65), matching skimage.color.rgb2lab."""
    lin = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                      rgb / 12.92)
    r, g, b_ = lin[..., 0], lin[..., 1], lin[..., 2]
    m = torch.tensor(_RGB2XYZ, dtype=torch.float32)
    ref = m.sum(dim=1)          # D65 white = row sums: white → L=100, a=b=0
    xyz = torch.stack([m[i, 0] * r + m[i, 1] * g + m[i, 2] * b_
                       for i in range(3)], dim=-1)
    xyz = xyz / ref.to(xyz.device)
    eps = 0.008856  # (6/29)^3
    kappa = 903.3   # (29/3)^3
    f = torch.where(xyz > eps, torch.pow(xyz, 1.0 / 3.0),
                    (kappa * xyz + 16.0) / 116.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=-1)


def normalize(img: torch.Tensor, mean: Sequence[float],
              std: Sequence[float]) -> torch.Tensor:
    """(img - mean) / std per channel (channels last)."""
    mean = torch.tensor(mean, dtype=img.dtype, device=img.device)
    std = torch.tensor(std, dtype=img.dtype, device=img.device)
    return (img - mean) / std
