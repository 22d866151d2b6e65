"""Patch collage generator — counterpart (a copy) of
``wsiseg_tpu/preprocess/collage_of_patches.py`` (reference
``preprocess/collage_of_patches.py``).

Tiles class-labeled photos into one large collage image + matching GT
raster, then slides the training tile grid over the collage so segmentation
nets see mixed-class tiles (class boundaries inside a tile).
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from wsiseg_tpu_torch.config import Config, parse_args
from wsiseg_tpu_torch.data import metadata as md
from wsiseg_tpu_torch.ops.geometry import tile_image_grid
from wsiseg_tpu_torch.preprocess.patch_to_gt import CLS_CODES
from wsiseg_tpu_torch.utils.filesystem import make_folder


def gallery(array: np.ndarray, ncols: int) -> np.ndarray:
    """(N, H, W, C) → (H·nrows, W·ncols, C) grid (reference :15-23)."""
    n, h, w, c = array.shape
    nrows = n // ncols
    return (array[: nrows * ncols]
            .reshape(nrows, ncols, h, w, c)
            .swapaxes(1, 2)
            .reshape(h * nrows, w * ncols, c))


def generate(patch_folder: str, out_pth: str, cfg: Config,
             ncols: int = 10, seed: int = 0,
             photo_hw: tuple = (1536, 2048)) -> dict:
    make_folder(out_pth)
    metadata = md.load_store(out_pth)

    factor = cfg.scan_resize * 4 ** cfg.scan_level
    yy, xx = photo_hw[0] // factor, photo_hw[1] // factor

    images, gts = [], []
    for cls_folder in sorted(glob.glob(os.path.join(patch_folder, "*/"))):
        cls_name = os.path.basename(os.path.dirname(cls_folder))
        if cls_name not in CLS_CODES:
            continue
        cls_code = CLS_CODES[cls_name]
        for image_path in sorted(glob.glob(os.path.join(cls_folder, "*.png"))):
            img = Image.open(image_path).convert("RGB").resize((xx, yy))
            images.append(np.asarray(img, np.uint8))
            gts.append(np.full((yy, xx), cls_code, np.uint8))

    if not images:
        return metadata
    images_a = np.stack(images)
    gts_a = np.stack(gts)

    rng = np.random.RandomState(seed)
    indices = rng.permutation(images_a.shape[0])
    collage = gallery(images_a[indices], ncols)
    collage_gt = gallery(gts_a[indices][..., None], ncols)[..., 0]

    # training tile grid over the collage (reference :83-97 via tile_image)
    grid = tile_image_grid(collage.shape[1], collage.shape[0],
                           cfg.tile_w, cfg.tile_h,
                           cfg.tile_stride_w, cfg.tile_stride_h)
    filename = "collage_of_patches"
    metadata[filename] = {}
    zero_mask = Image.fromarray(np.zeros((cfg.tile_h, cfg.tile_w), np.uint8))

    for tile_id, (x, y) in enumerate(zip(grid.xs, grid.ys)):
        tilepth_w = os.path.join(out_pth, f"w_{filename}_{tile_id}.png")
        tilepth_g = os.path.join(out_pth, f"g_{filename}_{tile_id}.png")
        tilepth_m = os.path.join(out_pth, f"m_{filename}_{tile_id}.png")
        metadata[filename][tile_id] = {"wsi": tilepth_w, "label": tilepth_g,
                                       "mask": tilepth_m}
        Image.fromarray(
            collage[y:y + cfg.tile_h, x:x + cfg.tile_w]).save(tilepth_w)
        Image.fromarray(
            collage_gt[y:y + cfg.tile_h, x:x + cfg.tile_w]).save(tilepth_g)
        zero_mask.save(tilepth_m)

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
