"""Patch batches for the patch evaluators — counterpart of
``wsiseg_tpu/data/patches.py``, so far its :func:`normalize_batch_images`
only; the rest of that module (patch datasets, class weights, s2d labels)
waits for the training port (ROADMAP.md, queue 1, 'training')."""

from __future__ import annotations

import torch

from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.ops.color import normalize


def normalize_batch_images(image_u8: torch.Tensor, cfg: Config,
                           train: bool = False) -> torch.Tensor:
    """(B, H, W, 3) uint8 → normalized float32 (float64 under an f64
    ``compute_dtype``), on the input's device. ``train`` (the train-time
    color jitter) raises: it comes with the training port."""
    if train:
        raise NotImplementedError(
            "train-time color jitter is not ported yet: ROADMAP.md, "
            "queue 1, 'training'")
    dt = torch.float64 if cfg.compute_dtype == "float64" else torch.float32
    return normalize(image_u8.to(dt) / 255.0, cfg.dataset_mean,
                     cfg.dataset_std)
