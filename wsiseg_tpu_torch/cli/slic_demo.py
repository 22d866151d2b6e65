"""SLIC region-proposal demo — counterpart of
``wsiseg_tpu/cli/slic_demo.py`` (reference ``slic.py``).

Slide thumbnail → SLIC superpixels on the card → per-superpixel keypoints
(k-means on the card) → region-ensemble inference → class mask painted
per superpixel → ``slic_out_mask.png`` + ``slic_out.png`` in the working
directory.

    python -m wsiseg_tpu_torch slic SLIDE [--eval_model_pth CKPT]
        [--num_segments 200] [--device cpu]

Runs on the CUDA device unless ``--device cpu`` asks for the CPU; without
a CUDA device the default raises ``RuntimeError``.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from wsiseg_tpu_torch.cli.common import (add_device_flag, make_hr_apply,
                                         restore_for_eval, setup_hr)
from wsiseg_tpu_torch.config import Config, default_config
from wsiseg_tpu_torch.infer.engine import resolve_device
from wsiseg_tpu_torch.ops.slic import mark_boundaries, slic
from wsiseg_tpu_torch.proposals import (classify_proposals, paint_mask_rgb,
                                        slic_proposals)
from wsiseg_tpu_torch.slides.reader import SlideReader, open_slide

# reference slic.py:21-28
SCAN_LEVEL = 2
NUM_SEGMENTS = 200
COMPACTNESS = 20
SIGMA = 5
US_KMEANS = 4
US = 4


def run_slic_pipeline(slide: SlideReader, wsipath: str, cfg: Config,
                      forward_fn: Callable, out_prefix: str = "slic_out",
                      num_segments: int = NUM_SEGMENTS,
                      device="cuda") -> np.ndarray:
    """The full proposal → inference → paint pipeline on an open slide,
    SLIC and k-means on ``device``. Returns the painted class mask at
    level-2 resolution."""
    dev = resolve_device(device)
    x, y = slide.level_dimensions[-1]
    wsi = slide.read_level(slide.level_count - 1)
    small = np.asarray(Image.fromarray(wsi).resize((x // US, y // US)))

    labels = slic(torch.from_numpy(small.copy()).to(dev),
                  n_segments=num_segments, compactness=COMPACTNESS,
                  sigma=SIGMA).cpu().numpy()

    # upscale thumb + labels back to level-2 dims (reference slic.py:45-52)
    image = np.asarray(Image.fromarray(small).resize((x, y)))
    labels_up = np.asarray(
        Image.fromarray(labels.astype(np.uint16)).resize((x, y),
                                                         Image.NEAREST))

    metadata = slic_proposals(labels_up, wsipath, scan_level=SCAN_LEVEL,
                              us_kmeans=US_KMEANS, device=dev)
    pred_mask = classify_proposals(forward_fn, metadata, labels_up.shape,
                                   cfg, slide=slide)

    paint_mask_rgb(pred_mask, cfg.num_classes, downscale=US).save(
        f"{out_prefix}_mask.png")
    boundaries = mark_boundaries(image, labels_up, color=(0, 0, 0))
    Image.fromarray(boundaries).save(f"{out_prefix}.png")
    return pred_mask


def make_hr_forward(model, cfg: Config, device="cuda") -> Callable:
    """(B, P, h, w, 3) uint8 numpy → ensemble logits (B, C) float32 numpy,
    through the ensemble's compute copy on ``device``."""
    apply = make_hr_apply(model, cfg, device)
    return lambda images_u8: apply(images_u8)[1]


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    p = argparse.ArgumentParser(description="SLIC proposal demo")
    p.add_argument("svspth")
    p.add_argument("--eval_model_pth", default="data/models/*")
    p.add_argument("--num_segments", type=int, default=NUM_SEGMENTS)
    add_device_flag(p, "SLIC, k-means and the ensemble run")
    ns = p.parse_args(argv)

    resolve_device(ns.device)
    cfg = default_config(eval_model_pth=ns.eval_model_pth)
    model, _ = restore_for_eval(cfg, setup=setup_hr)
    forward = make_hr_forward(model, cfg, ns.device)
    slide = open_slide(ns.svspth)
    return run_slic_pipeline(slide, ns.svspth, cfg, forward,
                             num_segments=ns.num_segments, device=ns.device)


if __name__ == "__main__":
    main()
