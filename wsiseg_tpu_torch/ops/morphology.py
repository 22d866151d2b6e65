"""Binary morphology on tensors of shape ``(..., H, W)`` — counterpart of
``wsiseg_tpu/ops/morphology.py`` (dilate, erode, opening, closing,
fill_holes, bwperim), on the tensor's own device.

The JAX module's windows are ``lax.reduce_window`` with ``"SAME"``
padding: a k-wide window pads ``(k-1)//2`` before and ``k//2`` after, so
for even k output ``o`` reads inputs ``o-(k/2-1) … o+k/2``. The padding
here is explicit and the same (``F.max_pool2d(padding=k//2)`` is
symmetric and would shift even windows by one). An all-ones square
element is separable: a 1×k max, then a k×1 max, exact and 2k reads a
pixel instead of k². The reductions run on ``mask > 0`` as 0/1 values
(``max_pool2d`` takes no ``uint8`` or ``bool`` on CUDA); out-of-bounds
cells are ignored, as JAX's −inf/+inf init values ignore them: 0 for the
max, and an erosion is the complement of the dilation of the complement.
Every op returns the input's dtype, as ``_as_f32``'s rule does there.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

#: fill_holes tests for growth once every this many 4-neighbour steps
#: (each test is a device→host sync); the fill is monotone, so the
#: fixpoint is the same as with a test after every step
FILL_CHECK_EVERY = 32


def _any_window(b: torch.Tensor, size: int) -> torch.Tensor:
    """Any of a (size, size) SAME window of the 0/1 float tensor ``b``
    ``(..., H, W)``, out-of-bounds cells counting as 0. Returns bool."""
    shape = b.shape
    x = b.reshape((-1, 1) + tuple(shape[-2:]))
    lo, hi = (size - 1) // 2, size // 2
    x = F.max_pool2d(F.pad(x, (lo, hi, 0, 0)), (1, size), stride=1)
    x = F.max_pool2d(F.pad(x, (0, 0, lo, hi)), (size, 1), stride=1)
    return (x > 0).reshape(shape)


def _binary(mask: torch.Tensor) -> torch.Tensor:
    return (mask > 0).to(torch.float32)


def dilate(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Binary dilation with an all-ones (size, size) element."""
    return _any_window(_binary(mask), size).to(mask.dtype)


def erode(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Binary erosion with an all-ones (size, size) element: a pixel stays
    set when every in-bounds cell of its window is set."""
    return (~_any_window(1.0 - _binary(mask), size)).to(mask.dtype)


def opening(mask: torch.Tensor, size: int) -> torch.Tensor:
    """cv2.MORPH_OPEN: erode then dilate."""
    return dilate(erode(mask, size), size)


def closing(mask: torch.Tensor, size: int) -> torch.Tensor:
    """cv2.MORPH_CLOSE: dilate then erode."""
    return erode(dilate(mask, size), size)


def _shifts(m: torch.Tensor):
    """The four 4-neighbour shifts of a bool (..., H, W) tensor, zero
    filled: each pixel's neighbour below, above, right and left."""
    up = F.pad(m[..., 1:, :], (0, 0, 0, 1))
    down = F.pad(m[..., :-1, :], (0, 0, 1, 0))
    left = F.pad(m[..., :, 1:], (0, 1))
    right = F.pad(m[..., :, :-1], (1, 0))
    return up, down, left, right


def _dilate4(m: torch.Tensor) -> torch.Tensor:
    """One 4-connected binary dilation step of a bool tensor."""
    up, down, left, right = _shifts(m)
    return m | up | down | left | right


def fill_holes(mask: torch.Tensor,
               max_iters: Optional[int] = None) -> torch.Tensor:
    """Fill holes not connected to the border (scipy binary_fill_holes):
    background is flood-filled from the image border by 4-neighbour steps
    until it stops growing or ``max_iters`` steps (default H·W) ran —
    never more steps than the JAX loop takes, so a capped fill stops at
    the same partial reach. Background not reached is a hole."""
    m = mask > 0
    h, w = m.shape[-2], m.shape[-1]
    if max_iters is None:
        max_iters = h * w
    bg = ~m
    reach = torch.zeros_like(bg)
    for sl in ((..., 0, slice(None)), (..., -1, slice(None)),
               (..., slice(None), 0), (..., slice(None), -1)):
        reach[sl] = bg[sl]
    done = 0
    while done < max_iters:
        before = reach
        for _ in range(min(FILL_CHECK_EVERY, max_iters - done)):
            reach = _dilate4(reach) & bg
            done += 1
        if torch.equal(reach, before):
            break
    return (m | (~reach & bg)).to(mask.dtype)


def bwperim(mask: torch.Tensor) -> torch.Tensor:
    """Perimeter pixels: foreground with at least one 4-neighbour
    background (mahotas.bwperim). Image-edge foreground counts as
    perimeter (zero-filled shifts)."""
    m = mask > 0
    up, down, left, right = _shifts(m)
    return (m & ~(up & down & left & right)).to(mask.dtype)
