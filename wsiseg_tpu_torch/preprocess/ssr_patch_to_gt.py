"""BACH photos → SSR-layout training data — counterpart (a copy) of
``wsiseg_tpu/preprocess/ssr_patch_to_gt.py`` (reference
``preprocess/ssr_patch_to_gt.py``).

Classification option: ``<name>_image.png`` + gt.npy record with
``times: 7`` oversampling hint. Segmentation option: a constant one-hot RGB
GT image per class (:49-53) saved as ``<name>_gt.png``.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from wsiseg_tpu_torch.config import Config, parse_args
from wsiseg_tpu_torch.data import metadata as md
from wsiseg_tpu_torch.preprocess.patch_to_gt import CLS_CODES
from wsiseg_tpu_torch.utils.filesystem import make_folder


def generate(patch_folder: str, out_pth: str, cfg: Config,
             option: str = "classification") -> dict:
    make_folder(out_pth)
    metadata = md.load_store(out_pth) if option == "classification" else {}

    for cls_folder in sorted(glob.glob(os.path.join(patch_folder, "*/"))):
        cls_name = os.path.basename(os.path.dirname(cls_folder))
        if cls_name not in CLS_CODES:
            continue
        cls_code = CLS_CODES[cls_name]

        gt = np.zeros((cfg.tile_h, cfg.tile_w, 3), np.uint8)
        if cls_code > 0:
            gt[..., cls_code - 1] = 255
        gt_img = Image.fromarray(gt)

        for image_path in sorted(glob.glob(os.path.join(cls_folder, "*.png"))
                                 + glob.glob(os.path.join(cls_folder, "*.tif"))):
            filename = os.path.basename(image_path)
            image = Image.open(image_path).convert("RGB").resize(
                (cfg.tile_w, cfg.tile_h))
            tilepth_w = os.path.join(out_pth, f"{filename}_image.png")
            image.save(tilepth_w)
            if option == "segmentation":
                gt_img.save(os.path.join(out_pth, f"{filename}_gt.png"))
            else:
                metadata[filename] = {0: {"image": tilepth_w,
                                          "label": cls_code, "times": 7}}

    if option == "classification":
        md.save_store(metadata, out_pth)
    return metadata


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    p = argparse.ArgumentParser(description="photos → SSR layout")
    p.add_argument("--option", choices=("classification", "segmentation"),
                   default="classification")
    ns, rest = p.parse_known_args(argv)
    cfg = parse_args(rest)
    if not cfg.patch_folder:
        raise SystemExit("--patch_folder is required")
    generate(cfg.patch_folder, cfg.train_image_pth, cfg, option=ns.option)


if __name__ == "__main__":
    main()
