"""Overlap-add stitching of tile logits into a slide canvas — counterpart
of ``wsiseg_tpu/ops/stitch.py`` (``gather_tiles``, ``scatter_add_tiles``,
``scatter_add_scalar_tiles``, ``overlap_count``), in JAX's ``(H, W, C)``
layout. A caller may pass permuted views of other layouts: the adds write
through them.

Tile origins are host integers (sequences, numpy arrays or CPU tensors):
each tile is one slice of the device tensor, so no origin is read back
from the card. Out-of-range origins are clamped as ``lax.dynamic_slice``
clamps them.

The adds are **sequential**, one in-place slice add per tile, in tile
order. At tile 512 and stride 128 every pixel is covered by 16 tiles, and
the f32 sum then has one order on every run and every route: the streamed
and the resident grid, the banded and the chunked FCN agree exactly.
``index_put_(accumulate=True)`` and ``index_add_`` would add with atomics
on the card, in an order that changes from run to run; ``F.fold`` needs a
regular grid, and the plan's grid is tissue-filtered.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _origin(v: int, size: int, extent: int) -> int:
    """``lax.dynamic_slice``'s clamp of one start index."""
    return min(max(int(v), 0), max(size - extent, 0))


def _ints(v) -> list:
    return v.tolist() if hasattr(v, "tolist") else [int(a) for a in v]


def gather_tiles(image: torch.Tensor, ys: Sequence[int], xs: Sequence[int],
                 th: int, tw: int) -> torch.Tensor:
    """(B, th, tw, C) windows of an (H, W, C) image at per-tile origins."""
    h, w = image.shape[:2]
    return torch.stack([
        image[_origin(y, h, th):_origin(y, h, th) + th,
              _origin(x, w, tw):_origin(x, w, tw) + tw]
        for y, x in zip(_ints(ys), _ints(xs))])


def scatter_add_tiles(canvas: torch.Tensor, tiles: torch.Tensor,
                      ys: Sequence[int], xs: Sequence[int]) -> torch.Tensor:
    """``canvas[y:y+th, x:x+tw, :] += tiles[b]`` for every b, in order, in
    place; returns ``canvas``."""
    th, tw = tiles.shape[1], tiles.shape[2]
    h, w = canvas.shape[:2]
    for b, (y, x) in enumerate(zip(_ints(ys), _ints(xs))):
        y, x = _origin(y, h, th), _origin(x, w, tw)
        canvas[y:y + th, x:x + tw] += tiles[b]
    return canvas


def scatter_add_scalar_tiles(canvas: torch.Tensor, values: torch.Tensor,
                             ys: Sequence[int], xs: Sequence[int],
                             th: int, tw: int) -> torch.Tensor:
    """Broadcast-add per-tile class vectors (B, C) over (th, tw) windows,
    in order, in place — the reference's classifier-mode painting
    (utils/eval.py:210-215); returns ``canvas``."""
    h, w = canvas.shape[:2]
    for b, (y, x) in enumerate(zip(_ints(ys), _ints(xs))):
        y, x = _origin(y, h, th), _origin(x, w, tw)
        canvas[y:y + th, x:x + tw] += values[b]
    return canvas


def overlap_count(shape_hw: Tuple[int, int], ys, xs, th: int, tw: int,
                  device=None) -> torch.Tensor:
    """(H, W) f32 count of the tiles that cover each pixel."""
    canvas = torch.zeros(tuple(shape_hw) + (1,), dtype=torch.float32,
                         device=device)
    ones = torch.ones((len(_ints(ys)), th, tw, 1), dtype=torch.float32,
                      device=device)
    return scatter_add_tiles(canvas, ones, ys, xs)[..., 0]
