"""BACH Part-A microscopy photos → training tiles + constant-class GT
rasters + gt.npy — counterpart (a copy) of
``wsiseg_tpu/preprocess/patch_to_gt.py`` (reference
``preprocess/patch_to_gt.py``).

Each class folder (Normal/Benign/InSitu/Invasive) contributes its photos,
resized to the tile size, with a constant class-code raster as the
segmentation label (so segmentation nets can train on photo patches).
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from wsiseg_tpu_torch.config import Config, parse_args
from wsiseg_tpu_torch.data import metadata as md
from wsiseg_tpu_torch.utils.filesystem import make_folder

# reference patch_to_gt.py:29-34
CLS_CODES = {"Normal": 0, "Benign": 1, "InSitu": 2, "Invasive": 3}


def generate(patch_folder: str, out_pth: str, cfg: Config,
             cls_codes: Optional[dict] = None) -> dict:
    cls_codes = cls_codes or CLS_CODES
    make_folder(out_pth)
    metadata = md.load_store(out_pth)

    num_tiles = 0
    for cls_folder in sorted(glob.glob(os.path.join(patch_folder, "*/"))):
        cls_name = os.path.basename(os.path.dirname(cls_folder))
        if cls_name not in cls_codes:
            continue
        cls_code = cls_codes[cls_name]
        gt = Image.fromarray(
            cls_code * np.ones((cfg.tile_h, cfg.tile_w), np.uint8))

        for image_path in sorted(glob.glob(os.path.join(cls_folder, "*.png"))
                                 + glob.glob(os.path.join(cls_folder, "*.tif"))):
            filename = os.path.basename(image_path)
            metadata[filename] = {}
            image = Image.open(image_path).convert("RGB").resize(
                (cfg.tile_w, cfg.tile_h))

            num_tiles += 1
            tile_id = num_tiles
            tilepth_w = os.path.join(out_pth, f"w_{filename}_{tile_id}.png")
            tilepth_g = os.path.join(out_pth, f"g_{filename}_{tile_id}.png")
            metadata[filename][tile_id] = {"wsi": tilepth_w,
                                           "label": tilepth_g}
            image.save(tilepth_w)
            gt.save(tilepth_g)

    md.save_store(metadata, out_pth)
    return metadata


def main(argv: Optional[Sequence[str]] = None) -> None:
    cfg = parse_args(argv)
    if not cfg.patch_folder:
        raise SystemExit("--patch_folder is required")
    meta = generate(cfg.patch_folder, cfg.train_image_pth, cfg)
    print(f"wrote {sum(len(v) for v in meta.values())} tiles")


if __name__ == "__main__":
    main()
