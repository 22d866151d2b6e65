"""BreastPathQ cell-dot annotations → binary segmentation masks —
counterpart of ``wsiseg_tpu/preprocess/breastpathq_cells.py`` (reference
``preprocess/mk_traindata_spie_breastpathq_cells.py``).

Each ``*_crop.tif`` image pairs with a ``*_mask.tif`` dot annotation; dots
are dilated into blobs (:38-41) forming a binary cell segmentation target.
The reference dilates with a 10×10 ellipse; the JAX module, and so this
copy, with a 10×10 square (``_ellipse_dilate``, ROADMAP.md §3). The
dilation and the optional colour quantization run on ``device``.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from wsiseg_tpu_torch.cli.common import parse_device_flag
from wsiseg_tpu_torch.config import Config, parse_args
from wsiseg_tpu_torch.data import metadata as md
from wsiseg_tpu_torch.infer.engine import resolve_device
from wsiseg_tpu_torch.utils.filesystem import make_folder


def _ellipse_dilate(binary: np.ndarray, size: int = 10,
                    device="cuda") -> np.ndarray:
    """Elliptical structuring-element dilation (cv2.MORPH_ELLIPSE twin)."""
    from wsiseg_tpu_torch.ops.morphology import dilate

    # square dilate then circular trim via two passes approximates the
    # ellipse; at size 10 the difference is corner pixels only, and the
    # output feeds a coarse resize — use the separable square kernel.
    return dilate(torch.from_numpy(binary.astype(np.uint8)).to(
        resolve_device(device)), size).cpu().numpy()


def generate(patch_folder: str, out_pth: str, cfg: Config,
             quantize_colors: int = 0, device="cuda") -> dict:
    from wsiseg_tpu_torch.ops.kmeans import quantize_image

    dev = resolve_device(device)
    make_folder(out_pth)
    metadata = md.load_store(out_pth)

    for image_path in sorted(glob.glob(os.path.join(patch_folder,
                                                    "*_crop.tif"))):
        filename = os.path.basename(image_path)
        metadata[filename] = {}

        image = Image.open(image_path).convert("RGB").resize(
            (cfg.tile_h, cfg.tile_w))
        if quantize_colors >= 2:
            image = Image.fromarray(quantize_image(
                torch.from_numpy(np.array(image)).to(dev), quantize_colors,
                iters=10, seed=0).cpu().numpy())

        gt_path = image_path.replace("_crop", "_mask")
        gt_rgb = np.asarray(Image.open(gt_path).convert("RGB"))
        dots = (gt_rgb < 1).astype(np.uint8)            # dark dots = cells
        blobs = _ellipse_dilate(dots.sum(-1) > 0, 10, dev)
        gt = Image.fromarray((blobs > 0).astype(np.uint8)).convert("L")
        gt = gt.resize((cfg.tile_h, cfg.tile_w), Image.NEAREST)

        tilepth_w = os.path.join(out_pth, f"w_{filename}_0.png").replace(" ", "_")
        tilepth_g = os.path.join(out_pth, f"g_{filename}_0.png").replace(" ", "_")
        metadata[filename][0] = {"wsi": tilepth_w, "label": tilepth_g}
        image.save(tilepth_w)
        gt.save(tilepth_g)

    md.save_store(metadata, out_pth)
    return metadata


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ns, rest = parse_device_flag(argv, "the dot dilation runs")
    cfg = parse_args(rest)
    if not cfg.patch_folder:
        raise SystemExit("--patch_folder is required")
    meta = generate(cfg.patch_folder, cfg.train_image_pth, cfg,
                    device=ns.device)
    print(f"wrote {len(meta)} image/mask pairs")
    return meta


if __name__ == "__main__":
    main()
