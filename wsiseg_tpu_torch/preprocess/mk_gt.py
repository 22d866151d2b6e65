"""Per-slide ground-truth artifacts for WSI evaluation — counterpart of
``wsiseg_tpu/preprocess/mk_gt.py`` (reference ``preprocess/mk_gt.py``).

For each slide with an annotation XML, writes next to it:
  ``<slide>_tumor_bed.png``   convex-hull tumor bed (malignant classes)
  ``<slide>_mask.png``        class-coded raster at scan level
  ``<slide>_mask_rgb.png``    RGB rendering (classes 1..3 → R/G/B)
  ``<slide>_find_nuclei.png`` level-2 tissue mask, ``find_nuclei`` on
                              ``device``

These are the GT artifacts the eval engine consumes
(wsiseg_tpu_torch.infer.evaluators._load_gt_artifacts; reference
utils/eval.py:64-103). The annotations are rasterized on the host, as in
JAX.
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
from wsiseg_tpu_torch.infer.engine import resolve_device
from wsiseg_tpu_torch.slides.reader import (SlideReader, glob_slides,
                                            open_slide)


def generate_for_slide(slide: SlideReader, wsipath: str, xmlpath: str,
                       cfg: Config, fmt: str = "aperio",
                       out_dir: Optional[str] = None,
                       device="cuda") -> dict:
    """Write the four GT artifacts for one slide. Returns their paths."""
    from wsiseg_tpu_torch.data import annotations as ann
    from wsiseg_tpu_torch.ops.tissue import find_nuclei

    dev = resolve_device(device)
    out_dir = out_dir or os.path.dirname(wsipath)
    base = os.path.join(out_dir, os.path.basename(wsipath))

    if fmt == "sedeen":
        gt = ann.get_gt_sedeen(xmlpath, slide, cfg.scan_level)
        tb = ann.get_tb_sedeen(xmlpath, slide, cfg.scan_level)
    else:
        gt = ann.get_gt_aperio(xmlpath, slide, cfg.scan_level)
        tb = ann.get_tb_aperio(gt, slide, cfg.scan_level)

    paths = {
        "tumor_bed": base + "_tumor_bed.png",
        "mask": base + "_mask.png",
        "mask_rgb": base + "_mask_rgb.png",
        "find_nuclei": base + "_find_nuclei.png",
    }

    Image.fromarray((np.asarray(tb) > 0).astype(np.uint8) * 255).save(
        paths["tumor_bed"])

    gt_img = Image.fromarray(gt.astype(np.uint8))
    if cfg.scan_resize != 1:
        gt_img = gt_img.resize((gt_img.size[0] // cfg.scan_resize,
                                gt_img.size[1] // cfg.scan_resize))
    gt_img.save(paths["mask"])

    rgb = (255 * np.eye(cfg.num_classes)[np.array(gt_img)][..., 1:]).astype(
        np.uint8)
    Image.fromarray(rgb).save(paths["mask_rgb"])

    thumb = slide.read_level(2)
    mask = find_nuclei(torch.from_numpy(np.ascontiguousarray(thumb)).to(dev))
    Image.fromarray(mask.cpu().numpy().astype(np.uint8)).save(
        paths["find_nuclei"])
    return paths


def generate(raw_pth: str, cfg: Config, fmt: str = "aperio",
             device="cuda") -> list:
    device = resolve_device(device)
    out = []
    for wsipath in glob_slides(raw_pth):
        stem = os.path.splitext(wsipath)[0]
        xml = (glob.glob(stem + "*.session.xml") if fmt == "sedeen"
               else [stem + ".xml"])
        xml = [p for p in xml if os.path.exists(p)]
        if not xml:
            continue
        slide = open_slide(wsipath)
        out.append(generate_for_slide(slide, wsipath, xml[0], cfg, fmt=fmt,
                                      device=device))
    return out


def main(argv: Optional[Sequence[str]] = None) -> list:
    ns, rest = parse_device_flag(argv, "find_nuclei runs")
    cfg = parse_args(rest)
    src = cfg.raw_val1_pth or cfg.raw_val_pth
    out = generate(src, cfg, device=ns.device)
    print(f"wrote GT artifacts for {len(out)} slides")
    return out


if __name__ == "__main__":
    main()
