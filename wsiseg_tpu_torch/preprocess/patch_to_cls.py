"""Photo/patch → classification/regression gt.npy stores — counterpart of
``wsiseg_tpu/preprocess/patch_to_cls.py`` (reference
``preprocess/patch_to_cls_bach.py``, ``patch_to_cls_breakhis.py``,
``patch_to_cls_spie_breastpathq.py``).

Three dataset flavors:
  * ``bach``        — class folders of photos → int label, one resized image
  * ``breakhis``    — walk the BreakHis tree, 40X malignant images →
                      label 2 (ductal carcinoma) / 3 (other malignant)
  * ``breastpathq`` — ``.tif`` patches + label CSV → cellularity label
                      (float for regression, or binary int), with optional
                      k-means color quantization on ``device``
                      (:func:`~wsiseg_tpu_torch.ops.kmeans.quantize_image`,
                      host k-means++ seeds: colours differ from JAX's by
                      design, ROADMAP.md §3); the CLI does not quantize,
                      as JAX's does not, so it takes no ``--device``
"""

from __future__ import annotations

import csv
import glob
import os
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from wsiseg_tpu_torch.config import Config, parse_args
from wsiseg_tpu_torch.data import metadata as md
from wsiseg_tpu_torch.infer.engine import resolve_device
from wsiseg_tpu_torch.preprocess.patch_to_gt import CLS_CODES
from wsiseg_tpu_torch.utils.filesystem import make_folder


def generate_bach(patch_folder: str, out_pth: str, cfg: Config) -> dict:
    """Class-folder photos → single resized image + int label
    (patch_to_cls_bach.py: no raster, label in gt.npy)."""
    make_folder(out_pth)
    metadata = md.load_store(out_pth)
    for cls_folder in sorted(glob.glob(os.path.join(patch_folder, "*/"))):
        cls_name = os.path.basename(os.path.dirname(cls_folder))
        if cls_name not in CLS_CODES:
            continue
        for image_path in sorted(glob.glob(os.path.join(cls_folder, "*.png"))
                                 + glob.glob(os.path.join(cls_folder, "*.tif"))):
            filename = os.path.basename(image_path)
            image = Image.open(image_path).convert("RGB").resize(
                (cfg.tile_w, cfg.tile_h))
            tilepth_w = os.path.join(out_pth, f"w_{filename}_0.png")
            image.save(tilepth_w)
            metadata[filename] = {0: {"wsi": tilepth_w,
                                      "label": int(CLS_CODES[cls_name])}}
    md.save_store(metadata, out_pth)
    return metadata


def generate_breakhis(patch_folder: str, out_pth: str, cfg: Config,
                      magnification: str = "40X") -> dict:
    """BreakHis tree walk (patch_to_cls_breakhis.py:23-52): keep only
    ``<magnification>`` images; ductal carcinoma → class 2, other
    malignant → class 3."""
    make_folder(out_pth)
    metadata = md.load_store(out_pth)
    n = 0
    for root, _, files in os.walk(patch_folder, topdown=False):
        for name in files:
            if ".png" not in name or f"/{magnification}" not in root:
                continue
            image_path = os.path.join(root, name)
            filename = os.path.basename(image_path)
            n += 1
            cls_code = 2 if "/ductal_carcinoma/" in root else 3
            image = Image.open(image_path).convert("RGB").resize(
                (cfg.tile_h, cfg.tile_w))
            tilepth_w = os.path.join(out_pth, f"w_{filename}_0.png")
            image.save(tilepth_w)
            metadata[filename] = {0: {"wsi": tilepth_w, "label": cls_code}}
    md.save_store(metadata, out_pth)
    return metadata


def read_label_csv(label_csv_path: str) -> dict:
    """{(image_id, region_id): cellularity float} from the SPIE CSV."""
    out = {}
    with open(label_csv_path) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            out[(int(row[0]), int(row[1]))] = float(row[2])
    return out


def generate_breastpathq(patch_folder: str, label_csv_path: str,
                         out_pth: str, cfg: Config,
                         regression: bool = True,
                         quantize_colors: int = 0,
                         device="cuda") -> dict:
    """BreastPathQ ``.tif`` patches + CSV → gt.npy
    (patch_to_cls_spie_breastpathq.py:59-88). ``regression=True`` stores the
    float cellularity (task REG); else the binary int (task CLS).
    ``quantize_colors`` ≥ 2 quantizes each image on ``device``."""
    from wsiseg_tpu_torch.ops.kmeans import quantize_image

    dev = resolve_device(device) if quantize_colors >= 2 else None
    make_folder(out_pth)
    metadata = md.load_store(out_pth)
    raw_gt = read_label_csv(label_csv_path)

    for image_path in sorted(glob.glob(os.path.join(patch_folder, "*.tif"))):
        stem = os.path.splitext(os.path.basename(image_path))[0]
        image_id, region_id = (int(v) for v in stem.split("_"))
        cellularity = raw_gt[(image_id, region_id)]
        label = float(cellularity) if regression else int(cellularity > 0)

        image = Image.open(image_path).convert("RGB").resize(
            (cfg.tile_h, cfg.tile_w))
        if dev is not None:
            q = quantize_image(torch.from_numpy(np.array(image)).to(dev),
                               quantize_colors, iters=10, seed=0)
            image = Image.fromarray(q.cpu().numpy())
        tilepth_w = os.path.join(out_pth, f"w_{image_id}_{region_id}.png")
        image.save(tilepth_w)
        metadata.setdefault(image_id, {})[region_id] = {
            "wsi": tilepth_w, "label": label}

    md.save_store(metadata, out_pth)
    return metadata


def main(argv: Optional[Sequence[str]] = None) -> dict:
    import argparse
    p = argparse.ArgumentParser(description="patch → cls/reg gt.npy")
    p.add_argument("--flavor", choices=("bach", "breakhis", "breastpathq"),
                   required=True)
    ns, rest = p.parse_known_args(argv)
    cfg = parse_args(rest)
    if not cfg.patch_folder:
        raise SystemExit("--patch_folder is required")
    if ns.flavor == "bach":
        meta = generate_bach(cfg.patch_folder, cfg.train_image_pth, cfg)
    elif ns.flavor == "breakhis":
        meta = generate_breakhis(cfg.patch_folder, cfg.train_image_pth, cfg)
    else:
        if not cfg.label_csv_path:
            raise SystemExit("--label_csv_path is required for breastpathq")
        meta = generate_breastpathq(cfg.patch_folder, cfg.label_csv_path,
                                    cfg.train_image_pth, cfg)
    print(f"wrote {sum(len(v) for v in meta.values())} records")
    return meta


if __name__ == "__main__":
    main()
