"""Tile-grid enumeration and coordinate mapping (host-side, exact-math).

The stitching pipeline depends on reproducing the reference's grid math
bit-for-bit (SURVEY.md "known quirks": grids start at 1 and step to
``dim - 1 - patch``), so these are plain integer numpy — cheap, and the
arrays they emit drive the on-device gather/scatter kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass(frozen=True)
class TileGrid:
    """Tile origins at the scan level, plus geometry needed for stitching."""
    xs: np.ndarray          # (N,) int32 x origins (scan-level coords)
    ys: np.ndarray          # (N,) int32 y origins
    tile_w: int
    tile_h: int
    image_w: int
    image_h: int

    def __len__(self) -> int:
        return len(self.xs)


def wsi_tile_grid(iw: int, ih: int, pw: int, ph: int,
                  sw: int, sh: int) -> TileGrid:
    """Sliding-window origins over a (iw, ih) level image.

    Exact twin of the reference enumeration (utils/dataset.py:147-166):
    interior grid from 1 stepping (sh, sw) up to ``dim - 1 - patch``
    (exclusive), then an edge-snap column at ``iw-1-pw`` and an edge-snap
    row at ``ih-1-ph``. Foreground gating is applied separately.
    """
    xs: List[int] = []
    ys: List[int] = []
    for ypos in range(1, ih - 1 - ph, sh):
        for xpos in range(1, iw - 1 - pw, sw):
            xs.append(xpos)
            ys.append(ypos)
    xpos = iw - 1 - pw
    for ypos in range(1, ih - 1 - ph, sh):
        xs.append(xpos)
        ys.append(ypos)
    ypos = ih - 1 - ph
    for xpos in range(1, iw - 1 - pw, sw):
        xs.append(xpos)
        ys.append(ypos)
    return TileGrid(np.asarray(xs, np.int32), np.asarray(ys, np.int32),
                    pw, ph, iw, ih)


def tile_image_grid(iw: int, ih: int, pw: int, ph: int,
                    sw: int, sh: int) -> TileGrid:
    """Origins for `tile_image` (reference utils/preprocessing.py:113-153):
    interior grid from 0, then edge-snap column ``iw-1-pw`` repeated down
    the rows and edge-snap row ``ih-1-ph`` across the columns. Degenerate
    images yield the single origin (0, 0)."""
    xs: List[int] = []
    ys: List[int] = []
    if (ih - 1 - ph) <= 0 or (iw - 1 - pw) <= 0:
        return TileGrid(np.zeros(1, np.int32), np.zeros(1, np.int32),
                        pw, ph, iw, ih)
    for ypos in range(0, ih - 1 - ph, sh):
        for xpos in range(0, iw - 1 - pw, sw):
            xs.append(xpos)
            ys.append(ypos)
    xpos = iw - 1 - pw
    for ypos in range(0, ih - 1 - ph, sh):
        xs.append(xpos)
        ys.append(ypos)
    ypos = ih - 1 - ph
    for xpos in range(0, iw - 1 - pw, sw):
        xs.append(xpos)
        ys.append(ypos)
    return TileGrid(np.asarray(xs, np.int32), np.asarray(ys, np.int32),
                    pw, ph, iw, ih)


def filter_grid_by_mask(grid: TileGrid, mask: np.ndarray,
                        mask_scale: float, thresh: float = 0.05) -> TileGrid:
    """Drop tiles whose mask window has < thresh foreground.

    ``mask_scale`` maps scan-level coords to mask coords (the reference's
    ``m = level_downsamples[scan_level]/level_downsamples[2]``,
    utils/dataset.py:144-150). Windows are (ph*m, pw*m) in mask space.
    """
    m = mask_scale
    dy, dx = int(grid.tile_h * m), int(grid.tile_w * m)
    if len(grid.xs) == 0 or dy <= 0 or dx <= 0:
        return grid

    # summed-area table: per-window foreground counts in O(HW + N) instead
    # of a Python loop with an O(window) count per tile
    fg = (np.asarray(mask) > 0).astype(np.int64)
    sat = np.zeros((fg.shape[0] + 1, fg.shape[1] + 1), np.int64)
    sat[1:, 1:] = fg.cumsum(0).cumsum(1)
    mh, mw = fg.shape

    y0 = np.minimum((grid.ys * m).astype(np.int64), mh)
    x0 = np.minimum((grid.xs * m).astype(np.int64), mw)
    y1 = np.minimum(y0 + dy, mh)
    x1 = np.minimum(x0 + dx, mw)
    counts = (sat[y1, x1] - sat[y0, x1] - sat[y1, x0] + sat[y0, x0])
    sizes = (y1 - y0) * (x1 - x0)
    # empty windows are dropped, matching the previous per-window behavior
    keep = (sizes > 0) & (counts >= thresh * sizes)
    return TileGrid(grid.xs[keep], grid.ys[keep], grid.tile_w, grid.tile_h,
                    grid.image_w, grid.image_h)


def map_points(arr: np.ndarray, scan_level: int, tile_w: int, tile_h: int,
               iw: int, ih: int,
               level_spacing: int = 4) -> Tuple[np.ndarray, int]:
    """Level-k keypoints → level-0 tile origins, culling border-clipped tiles.

    Twin of reference utils/regiontools.py:15-37: scale by spacing**level,
    center the tile on the point, drop tiles touching the level-0 borders.
    """
    arr = np.asarray(arr).astype(np.int64).copy()
    arr *= level_spacing ** scan_level
    arr -= [tile_w // 2, tile_h // 2]
    valid = ((arr[:, 0] > 0) & ((arr[:, 0] + tile_w) < iw) &
             (arr[:, 1] > 0) & ((arr[:, 1] + tile_h) < ih))
    arr = arr[valid]
    return arr, arr.shape[0]


def nextpow2(x) -> int:
    """Next power of two ≥ x (reference utils/preprocessing.py:221-223)."""
    x = int(x)
    return 1 << (x - 1).bit_length()
