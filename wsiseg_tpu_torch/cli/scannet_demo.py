"""ScanNet-style connected-component proposal demo — counterpart of
``wsiseg_tpu/cli/scannet_demo.py`` (reference ``scannet.py``).

GT-thumbnail connected components → small/large-region proposal split
(k-means on the card) → region-ensemble inference with per-class
probability gating → class mask painted per proposal →
``scannet_out_mask.png`` + ``scannet_out.png`` in the working directory.

    python -m wsiseg_tpu_torch scannet SLIDE [--gt_thumbnail PNG]
        [--eval_model_pth CKPT] [--device cpu]

Runs on the CUDA device unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from wsiseg_tpu_torch.cli.common import (add_device_flag, restore_for_eval,
                                         setup_hr)
from wsiseg_tpu_torch.cli.slic_demo import (SCAN_LEVEL, US, US_KMEANS,
                                            make_hr_forward)
from wsiseg_tpu_torch.config import Config, default_config
from wsiseg_tpu_torch.infer.engine import resolve_device
from wsiseg_tpu_torch.ops.cc import connected_components
from wsiseg_tpu_torch.ops.slic import mark_boundaries
from wsiseg_tpu_torch.ops.tissue import find_nuclei
from wsiseg_tpu_torch.proposals import (cc_proposals, classify_proposals,
                                        paint_mask_rgb)
from wsiseg_tpu_torch.slides.reader import SlideReader, open_slide


def run_scannet_pipeline(slide: SlideReader, wsipath: str,
                         gt_thumb: np.ndarray, cfg: Config,
                         forward_fn: Callable,
                         out_prefix: str = "scannet_out",
                         device="cuda") -> np.ndarray:
    """CC proposals from a GT thumbnail mask (reference scannet.py:41-127),
    ensemble inference with class-probability gating (:145-155); the
    tissue mask and k-means on ``device``."""
    dev = resolve_device(device)
    x, y = slide.level_dimensions[-1]
    wsi = slide.read_level(slide.level_count - 1)
    small = np.asarray(Image.fromarray(wsi).resize((x // US, y // US)))
    tissue = find_nuclei(torch.from_numpy(small.copy()).to(dev)).cpu().numpy()
    tissue = np.asarray(
        Image.fromarray(tissue.astype(np.uint8)).resize((x, y),
                                                        Image.NEAREST))

    mask = np.asarray(
        Image.fromarray(gt_thumb).convert("L").resize((x, y), Image.NEAREST))
    labels, _ = connected_components((mask > 0).astype(np.uint8))

    metadata = cc_proposals(labels, wsipath, tissue_mask=tissue,
                            scan_level=SCAN_LEVEL, us_kmeans=US_KMEANS,
                            device=dev)
    pred_mask = classify_proposals(forward_fn, metadata, labels.shape, cfg,
                                   slide=slide, gate_class_probs=True)

    paint_mask_rgb(pred_mask, cfg.num_classes, downscale=US).save(
        f"{out_prefix}_mask.png")
    image = np.asarray(Image.fromarray(small).resize((x, y)))
    Image.fromarray(mark_boundaries(image, labels, color=(0, 0, 0))).save(
        f"{out_prefix}.png")
    return pred_mask


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    p = argparse.ArgumentParser(description="ScanNet-style CC proposal demo")
    p.add_argument("svspth")
    p.add_argument("--gt_thumbnail", default=None,
                   help="GT thumbnail PNG (defaults to "
                        "gt_thumbnails/<slide>.png next to the slide)")
    p.add_argument("--eval_model_pth", default="data/models/*")
    add_device_flag(p, "the tissue mask, k-means and the ensemble run")
    ns = p.parse_args(argv)

    resolve_device(ns.device)
    gt_pth = ns.gt_thumbnail or os.path.join(
        os.path.dirname(ns.svspth), "gt_thumbnails",
        os.path.basename(ns.svspth).replace(".svs", ".png"))
    gt_thumb = np.asarray(Image.open(gt_pth))

    cfg = default_config(eval_model_pth=ns.eval_model_pth)
    model, _ = restore_for_eval(cfg, setup=setup_hr)
    forward = make_hr_forward(model, cfg, ns.device)
    slide = open_slide(ns.svspth)
    return run_scannet_pipeline(slide, ns.svspth, gt_thumb, cfg, forward,
                                device=ns.device)


if __name__ == "__main__":
    main()
