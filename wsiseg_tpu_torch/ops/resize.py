"""Resize wrappers — counterpart of ``wsiseg_tpu/ops/resize.py``, on the
port's ``jax.image.resize`` twins in :mod:`wsiseg_tpu_torch.models.decoders`
(``resize_linear``: the antialiased ``"linear"`` method, a different
function from ``F.interpolate(mode="bilinear")`` where it shrinks;
``resize_nearest``: JAX's half-pixel nearest).

Both take ``(..., H, W, C)`` or ``(H, W)``, as the JAX functions do.
"""

from __future__ import annotations

import torch

from wsiseg_tpu_torch.models.decoders import resize_linear, \
    resize_nearest as _nearest_nchw


def _apply(img: torch.Tensor, fn, out_h: int, out_w: int) -> torch.Tensor:
    """Run an NCHW resize on ``(..., H, W, C)`` or ``(H, W)``."""
    if img.dim() == 2:
        return fn(img[None, None], out_h, out_w)[0, 0]
    lead = img.shape[:-3]
    h, w, c = img.shape[-3:]
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = fn(x, out_h, out_w).permute(0, 2, 3, 1)
    return y.reshape(*lead, out_h, out_w, c)


def resize_bilinear(img: torch.Tensor, out_h: int,
                    out_w: int) -> torch.Tensor:
    """Bilinear resize in f32; integer images are rounded and clipped back
    to their dtype."""
    out = _apply(img.float(), resize_linear, out_h, out_w)
    if not img.dtype.is_floating_point:
        info = torch.iinfo(img.dtype)
        out = torch.clamp(torch.round(out), info.min, info.max)
    return out.to(img.dtype)


def resize_nearest(img: torch.Tensor, out_h: int,
                   out_w: int) -> torch.Tensor:
    """Nearest-neighbour resize (labels, masks)."""
    return _apply(img, _nearest_nchw, out_h, out_w)
