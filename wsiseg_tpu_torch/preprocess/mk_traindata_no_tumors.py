"""Tumor-free (normal) training tiles — counterpart of
``wsiseg_tpu/preprocess/mk_traindata_no_tumors.py`` (reference
``preprocess/mk_traindata_sunny_no_tumors.py``).

For each tumor-free slide, the tissue mask's connected components become
regions and centered tiles are extracted with an all-zero GT raster
(mk_traindata_sunny_no_tumors.py:66-71). Slides with too few pyramid levels
are skipped (:84-85). The tissue mask (``find_nuclei``) and the k-means
of large regions run on ``device``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from wsiseg_tpu_torch.cli.common import parse_device_flag
from wsiseg_tpu_torch.config import Config, parse_args
from wsiseg_tpu_torch.data import metadata as md
from wsiseg_tpu_torch.infer.engine import resolve_device
from wsiseg_tpu_torch.preprocess.mk_traindata_centered import (
    generate_for_slide)
from wsiseg_tpu_torch.slides.reader import (SlideReader, glob_slides,
                                            open_slide)
from wsiseg_tpu_torch.utils.filesystem import make_folder


def tissue_regions_mask(slide: SlideReader, cfg: Config,
                        device="cuda") -> np.ndarray:
    """Tissue mask at scan level — region source for normal slides."""
    from wsiseg_tpu_torch.ops.tissue import find_nuclei

    thumb = slide.read_level(2)
    mask = find_nuclei(torch.from_numpy(np.ascontiguousarray(thumb)).to(
        resolve_device(device))).cpu().numpy()
    iw, ih = slide.level_dimensions[cfg.scan_level]
    if mask.shape != (ih, iw):
        mask = np.asarray(Image.fromarray(mask.astype(np.uint8)).resize(
            (iw, ih), Image.NEAREST))
    return (mask > 0).astype(np.uint8)


def generate(raw_pth: str, out_pth: str, cfg: Config,
             slide_names: Optional[List[str]] = None,
             device="cuda") -> dict:
    """``slide_names`` optionally restricts to a hand-picked tumor-free list
    (the reference hard-codes 50 names, :53-60)."""
    device = resolve_device(device)
    make_folder(out_pth)
    metadata = md.load_store(out_pth)
    patch_id = 0
    for wsipath in glob_slides(raw_pth):
        if slide_names is not None and \
                os.path.basename(wsipath) not in slide_names:
            continue
        slide = open_slide(wsipath)
        if slide.level_count < 3:
            continue
        # all-zero GT: every extracted tile trains as "normal"; regions come
        # from the tissue mask (mk_traindata_sunny_no_tumors.py:66-71)
        mask = tissue_regions_mask(slide, cfg, device)
        patch_id = generate_for_slide(
            slide, wsipath, np.zeros_like(mask), cfg, out_pth, metadata,
            patch_id, region_support=mask, device=device)
    md.save_store(metadata, out_pth)
    return metadata


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ns, rest = parse_device_flag(argv, "find_nuclei and k-means run")
    cfg = parse_args(rest)
    meta = generate(cfg.raw_train_pth, cfg.train_image_pth, cfg,
                    device=ns.device)
    print(f"wrote {sum(len(v) for v in meta.values())} tiles")
    return meta


if __name__ == "__main__":
    main()
