"""Same-sized-region (SSR) extraction from annotated WSIs — counterpart
(a copy) of ``wsiseg_tpu/preprocess/makedata_ssr.py`` (reference
``preprocess/makedata_ssr.py``), host connected components included.

Per GT connected component: crop its (padded) bounding box, resize to the
tile size, and either save an image/GT-mask pair (segmentation option,
:91-99) or an image + mode-class gt.npy record (classification option,
:101-135). A fixed train/val slide split mirrors the reference (:36-39).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from wsiseg_tpu_torch.config import Config, parse_args
from wsiseg_tpu_torch.data import metadata as md
from wsiseg_tpu_torch.ops.cc import connected_components_with_stats
from wsiseg_tpu_torch.slides.reader import SlideReader, glob_slides, open_slide
from wsiseg_tpu_torch.utils.filesystem import make_folder

# reference train/val slide split (makedata_ssr.py:36-39)
DEFAULT_SPLIT = ([2, 3, 4, 5, 6, 7, 9], [0, 1, 8])


def generate_for_slide(slide: SlideReader, wsipath: str, gt: np.ndarray,
                       cfg: Config, out_dir: str, metadata: dict,
                       region_id: int = 0, option: str = "classification",
                       pad: Tuple[int, int] = (0, 0)) -> int:
    """Extract each CC as one same-sized region. Returns next region_id."""
    from scipy import stats as sstats

    filename = os.path.basename(wsipath)
    gt_rgb = np.eye(max(4, cfg.num_classes))[gt][..., 1:4]
    cc = connected_components_with_stats((gt > 0).astype(np.uint8))
    dx, dy = pad
    iw, ih = slide.level_dimensions[cfg.scan_level]
    ds = slide.level_downsamples[cfg.scan_level]

    for tile_id in range(1, cc.num):
        l, u, w, h, area = cc.stats[tile_id]
        if area == 0:
            continue
        l_, u_ = max(l - dx, 1), max(u - dy, 1)
        r_, d_ = min(l + w + 2 * dx, iw), min(u + h + 2 * dy, ih)
        w_, h_ = r_ - l_, d_ - u_
        if w_ <= 0 or h_ <= 0 or w_ * h_ >= 2 ** 29:
            continue

        savepath = os.path.join(out_dir, f"{region_id}_image.png")
        region = slide.read_region((int(l_ * ds), int(u_ * ds)),
                                   cfg.scan_level, (w_, h_))
        Image.fromarray(region).resize((cfg.tile_w, cfg.tile_h)).save(savepath)

        if option == "segmentation":
            gt_region = gt_rgb[u_:u_ + h_, l_:l_ + w_]
            Image.fromarray((255 * gt_region).astype(np.uint8)).resize(
                (cfg.tile_w, cfg.tile_h)).save(
                    os.path.join(out_dir, f"{region_id}_gt.png"))
        else:
            vals = gt[cc.labels == tile_id]
            current_label = int(sstats.mode(vals, keepdims=True)[0][0])
            metadata.setdefault(filename, {})[tile_id] = {
                "image": savepath, "label": current_label, "times": 1}
        region_id += 1
    return region_id


def generate(raw_pth: str, out_dirs: Sequence[str], cfg: Config,
             option: str = "classification",
             split: Optional[Tuple[List[int], List[int]]] = None) -> None:
    from wsiseg_tpu_torch.data import annotations as ann

    split = split or DEFAULT_SPLIT
    wsipaths = glob_slides(raw_pth)
    for ij, out_dir in enumerate(out_dirs):
        make_folder(out_dir, purge=True)
        metadata: dict = {}
        region_id = 0
        idxs = [i for i in split[ij] if i < len(wsipaths)]
        for i in idxs:
            wsipath = wsipaths[i]
            stem = os.path.splitext(wsipath)[0]
            xml = stem + ".xml"
            if not os.path.exists(xml):
                continue
            slide = open_slide(wsipath)
            gt = ann.get_gt_aperio(xml, slide, cfg.scan_level)
            region_id = generate_for_slide(slide, wsipath, gt, cfg, out_dir,
                                           metadata, region_id, option)
        if option == "classification" and metadata:
            md.save_store(metadata, out_dir)


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    p = argparse.ArgumentParser(description="same-sized-region extraction")
    p.add_argument("--option", choices=("classification", "segmentation"),
                   default="classification")
    p.add_argument("--out_train", default="data/ssr/train")
    p.add_argument("--out_val", default="data/ssr/val")
    ns, rest = p.parse_known_args(argv)
    cfg = parse_args(rest)
    generate(cfg.raw_train_pth, [ns.out_train, ns.out_val], cfg,
             option=ns.option)


if __name__ == "__main__":
    main()
