"""Color-space conversions and the train-time photometric jitter —
counterpart of ``wsiseg_tpu/ops/color.py``, same element-wise math. All
functions take float RGB in [0, 1] with channels last.

The jitter is split in two: :func:`draw_jitter_factors` draws each
image's four factors from an explicit ``torch.Generator`` (on the batch's
device, never the global RNG), and :func:`apply_color_jitter` is pure
tensor code on given factors, so the JAX package's draws can be fed to
it."""

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


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    planes = {"r": (v, q, p, p, t, v), "g": (t, v, v, q, p, p),
              "b": (p, p, t, v, v, q)}
    out = []
    for c in "rgb":
        x = planes[c][5]
        for k in range(4, -1, -1):
            x = torch.where(i == k, planes[c][k], x)
        out.append(x)
    return torch.stack(out, dim=-1)


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


def draw_jitter_factors(n: int, generator: torch.Generator,
                        dtype=torch.float32, brightness: float = 0.25,
                        contrast: float = 0.75, saturation: float = 0.25,
                        hue: float = 0.04) -> torch.Tensor:
    """(n, 4) factors (brightness, contrast, saturation, hue), one row per
    image, uniform in [max(0, 1-x), 1+x] and [-hue, hue], drawn from
    ``generator`` on its device. The defaults are torchvision ColorJitter
    ranges of the reference augmentor (utils/preprocessing.py:215)."""
    lo = torch.tensor([max(0.0, 1 - brightness), max(0.0, 1 - contrast),
                       max(0.0, 1 - saturation), -hue], dtype=dtype)
    hi = torch.tensor([1 + brightness, 1 + contrast, 1 + saturation, hue],
                      dtype=dtype)
    u = torch.rand((n, 4), generator=generator, dtype=dtype,
                   device=generator.device)
    return lo.to(u.device) + u * (hi - lo).to(u.device)


def apply_color_jitter(rgb: torch.Tensor,
                       factors: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) RGB, (B, 4) factors → jittered RGB, JAX
    ``color_jitter``'s fixed order: brightness, contrast about the mean of
    the image's grayscale, saturation, hue."""
    fb, fc, fs, fh = (factors[:, k].to(rgb.dtype).view(-1, 1, 1)
                      for k in range(4))
    out = torch.clamp(rgb * fb[..., None], 0.0, 1.0)
    gray = (0.299 * out[..., 0] + 0.587 * out[..., 1]
            + 0.114 * out[..., 2])
    mean = gray.mean(dim=(1, 2), keepdim=True)[..., None]
    out = torch.clamp((out - mean) * fc[..., None] + mean, 0.0, 1.0)
    hsv = rgb_to_hsv(out)
    s = torch.clamp(hsv[..., 1] * fs, 0.0, 1.0)
    h = torch.remainder(hsv[..., 0] + fh, 1.0)
    out = hsv_to_rgb(torch.stack([h, s, hsv[..., 2]], dim=-1))
    return torch.clamp(out, 0.0, 1.0)
