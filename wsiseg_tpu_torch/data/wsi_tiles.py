"""Sliding-window tile planning over whole slides — counterpart of
``wsiseg_tpu/data/wsi_tiles.py`` (``SlidePlan``, ``plan_slide``,
``SlideCollection``): per slide, the tissue mask from the level-2
thumbnail (PNG-cached when a cache dir is given) and the
foreground-gated reference tile grid (``wsiseg_tpu_torch.ops.geometry``).
PIL is imported only when the mask cache is used.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
from torch.profiler import record_function

from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.ops.geometry import (TileGrid, filter_grid_by_mask,
                                     wsi_tile_grid)
from wsiseg_tpu_torch.slides import SlideReader, open_slide
from wsiseg_tpu_torch.utils.filesystem import make_folder
from wsiseg_tpu_torch.ops.tissue import find_nuclei


@dataclass
class SlidePlan:
    name: str
    slide: SlideReader
    path: Optional[str]
    grid: TileGrid                 # scan-level tile origins (foreground only)
    full_grid_len: int             # before foreground gating
    mask: np.ndarray               # tissue mask at level 2
    mask_path: Optional[str]
    scan_level: int = 2

    @property
    def canvas_hw(self) -> Tuple[int, int]:
        """Heatmap/output canvas dims: level-2 (h, w)."""
        w, h = self.slide.level_dimensions[2]
        return h, w

    @property
    def stitch_hw(self) -> Tuple[int, int]:
        """Stitching canvas dims: scan-level (h, w)."""
        w, h = self.slide.level_dimensions[self.scan_level]
        return h, w


def resize_mask_to(mask: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """A plan's mask at ``hw`` as u8, equal to PIL's
    ``Image.resize(NEAREST)``: source index ``int(s/2 + k·s)`` accumulated
    in double, s = in/out."""
    if mask.shape == tuple(hw):
        return mask.astype(np.uint8)

    def index(n_in: int, n_out: int) -> np.ndarray:
        s = n_in / n_out
        steps = np.full(n_out, s)
        steps[0] = s * 0.5
        return np.cumsum(steps).astype(np.int64)

    m = mask.astype(np.uint8)
    return m[index(m.shape[0], hw[0])][:, index(m.shape[1], hw[1])]


def plan_slide(name: str, slide: SlideReader, cfg: Config,
               path: Optional[str] = None,
               mask_cache_dir: Optional[str] = None) -> Optional[SlidePlan]:
    """Returns None when the slide lacks the requested pyramid level or
    has no foreground tile (the reference skips such slides). Ranges:
    ``plan.slide`` (the call), ``plan.mask`` (the cached mask's decode, or
    ``find_nuclei`` and its save) and ``plan.filter`` (the foreground
    gate)."""
    with record_function("plan.slide"):
        if slide.level_count - 1 < cfg.scan_level or slide.level_count < 3:
            return None
        iw, ih = slide.level_dimensions[cfg.scan_level]

        with record_function("plan.mask"):
            mask = None
            mask_path = None
            if mask_cache_dir:
                from PIL import Image
                make_folder(mask_cache_dir)
                mask_path = os.path.join(mask_cache_dir, f"{name}.png")
                if os.path.exists(mask_path):
                    mask = np.asarray(Image.open(mask_path).convert("L"))
            if mask is None:
                mask = find_nuclei(slide.read_level(2)).numpy()
                if mask_path:
                    Image.fromarray(mask.astype(np.uint8)).save(mask_path)

        # scan-level → level-2 multiplier
        m = (slide.level_downsamples[cfg.scan_level]
             / slide.level_downsamples[2])
        grid = wsi_tile_grid(iw, ih, cfg.tile_w, cfg.tile_h,
                             cfg.tile_stride_w, cfg.tile_stride_h)
        full_len = len(grid)
        with record_function("plan.filter"):
            grid = filter_grid_by_mask(grid, mask, m)
        if len(grid) == 0:
            return None
        return SlidePlan(name=name, slide=slide, path=path, grid=grid,
                         full_grid_len=full_len, mask=mask,
                         mask_path=mask_path, scan_level=cfg.scan_level)


class SlideCollection:
    """All slides of a directory (``Case*/*.<ext>`` plus loose files), or
    an explicit list of (name, SlideReader[, path])."""

    def __init__(self, source, cfg: Config,
                 mask_cache_dir: Optional[str] = None):
        self.cfg = cfg
        self.plans: Dict[str, SlidePlan] = {}
        mask_dir = (mask_cache_dir if mask_cache_dir is not None
                    else cfg.wsi_mask_pth)
        if isinstance(source, str):
            from wsiseg_tpu_torch.slides.reader import glob_slides
            paths = glob_slides(source, case_dirs=True)
            entries = [(os.path.basename(p), open_slide(p), p)
                       for p in paths]
        else:
            entries = [(e[0], e[1], e[2] if len(e) > 2 else None)
                       for e in source]
        for name, slide, path in entries:
            plan = plan_slide(name, slide, cfg, path=path,
                              mask_cache_dir=mask_dir)
            if plan is not None:
                self.plans[name] = plan

    def __len__(self) -> int:
        return len(self.plans)

    def items(self):
        return self.plans.items()
