"""Slide-level cancer/no-cancer screening from saved heatmaps — counterpart
of ``wsiseg_tpu/paper_tools/check_for_false_positives.py`` (reference
``paper_tools/check_for_false_positives.py``).

Per slide: heatmap ≥ 0.99·255 → 50×50 opening → any-pixel-above-threshold
cancer call (:61-69); GT = annotation presence minus a benign exclusion
list (:35-45); reports acc/F1/precision/recall/AUC/confusion (:80-93).
The opening runs on ``device``; the metrics on the host.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from wsiseg_tpu_torch.cli.common import add_device_flag
from wsiseg_tpu_torch.infer import metrics as M
from wsiseg_tpu_torch.infer.engine import resolve_device


def screen_heatmap(heatmap_u8: np.ndarray, thresh: float = 0.99,
                   open_size: int = 50, cancer_thresh: float = 0.0,
                   device="cuda") -> int:
    """1 = cancer predicted on this slide (reference :61-69)."""
    from wsiseg_tpu_torch.ops.morphology import opening

    mask = np.uint8(np.asarray(heatmap_u8) >= thresh * 255)
    mask = opening(torch.from_numpy(mask).to(resolve_device(device)),
                   open_size).cpu().numpy()
    return int(np.count_nonzero(mask) / mask.size > cancer_thresh)


def screen_slides(pairs: Sequence[Tuple[int, str]],
                  annotated_ids: Sequence[int],
                  benign_ids: Sequence[int] = (),
                  cancer_thresh: float = 0.0,
                  log=print, device="cuda") -> Dict:
    """``pairs`` = (slide_id, heatmap_path). Returns the metric report."""
    device = resolve_device(device)
    preds: List[int] = []
    gts: List[int] = []
    for slide_id, heatmap_path in pairs:
        gt = int(slide_id in annotated_ids and slide_id not in benign_ids)
        hm = np.asarray(Image.open(heatmap_path).convert("L"))
        preds.append(screen_heatmap(hm, cancer_thresh=cancer_thresh,
                                    device=device))
        gts.append(gt)

    gts_a, preds_a = np.asarray(gts), np.asarray(preds)
    prec, rec = M.precision_recall(gts_a, preds_a)
    out = {
        "acc": M.accuracy(gts_a, preds_a),
        "f1": M.f1_score(gts_a, preds_a),
        "precision": prec,
        "recall": rec,
        "auc": M.roc_auc(gts_a, preds_a.astype(float)),
        "confusion": M.confusion_matrix(gts_a, preds_a, 2).tolist(),
    }
    log(f"acc. {out['acc']:.2f}, f1 {out['f1']:.2f}, "
        f"prc {out['precision']:.2f}, rec {out['recall']:.2f}, "
        f"auc {out['auc']:.2f}, cfs {out['confusion']}")
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    import argparse
    p = argparse.ArgumentParser(description="slide-level FP screening")
    p.add_argument("--raw_val_pth", default="data/test/wsi")
    p.add_argument("--val_save_pth", default="data/val/out")
    p.add_argument("--benign", nargs="*", type=int, default=[])
    add_device_flag(p, "the 50x50 opening runs")
    ns = p.parse_args(argv)
    resolve_device(ns.device)

    ann_list = glob.glob(f"{ns.raw_val_pth}/**/*.xml", recursive=True)
    annotated = []
    for pth in ann_list:
        stem = os.path.basename(pth).replace(".session.xml", "").replace(
            ".xml", "")
        try:
            annotated.append(int(stem))
        except ValueError:
            continue

    pairs = []
    from wsiseg_tpu_torch.slides.reader import glob_slides
    for svs in glob_slides(ns.raw_val_pth, case_dirs=True):
        try:
            slide_id = int(os.path.splitext(os.path.basename(svs))[0])
        except ValueError:
            continue
        from wsiseg_tpu_torch.utils.filesystem import find_heatmaps
        hms = find_heatmaps(ns.val_save_pth, slide_id)
        if hms:
            pairs.append((slide_id, hms[0]))

    if not pairs:
        raise SystemExit("no (slide, heatmap) pairs found")
    return screen_slides(pairs, annotated, ns.benign, device=ns.device)


if __name__ == "__main__":
    main()
