"""Patch dataset over a gt.npy store → fixed-shape multi-task batches —
counterpart of ``wsiseg_tpu/data/patches.py`` (reference
utils/dataset.py:13-80).

Host batches stay numpy and are built exactly as the JAX package builds
them: PIL decodes each patch (and the mask PNG of a seg patch), a random
90° rotation from ``np.random.RandomState(seed)`` and a resize to the
tile, the same shuffle from the same generator. So for one seed the two
packages feed identical batches. Photometric jitter and normalization run
on the device (:func:`normalize_batch_images`).

Batch dict (numpy):
  image      (B, H, W, 3) uint8
  seg_label  (B, H, W) int32     zeros where not seg
  cls_label  (B,) int32          -1 where not cls
  reg_label  (B,) float32        0 where not reg
  is_cls / is_reg / is_seg (B,) float32

The JAX package's s2d label view (``seg_labels_s2d``) feeds its train
s2d decoder tail, which the port does not have: the port trains through
the native decoder (ROADMAP.md §3).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from PIL import Image

from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.data import metadata as md
from wsiseg_tpu_torch.ops.color import (apply_color_jitter,
                                        draw_jitter_factors, normalize)


class PatchDataset:
    def __init__(self, impth: str, cfg: Config, eval: bool = False,
                 duplicate_dataset: int = 1, seed: int = 0):
        self.cfg = cfg
        self.eval = eval
        store = md.load_store(impth)
        if not store:
            raise FileNotFoundError(f"no gt.npy under {impth}")
        self.records: List[md.PatchRecord] = md.flatten_patches(store)
        if not eval and duplicate_dataset > 1:
            # ×N oversampling (reference utils/dataset.py:30-32)
            self.records = [r for r in self.records
                            for _ in range(duplicate_dataset)]
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.records)

    def _load(self, rec: md.PatchRecord):
        image = Image.open(rec.image_path).convert("RGB")
        if rec.task is md.Task.SEG:
            label = Image.open(str(rec.label))
        else:
            label = Image.fromarray(
                np.zeros((image.size[1], image.size[0]), dtype=np.uint8))
        if not self.eval:
            # random 90° rotation + resize (utils/dataset.py:47-55)
            k = int(self._rng.randint(0, 4))
            if k:
                image = image.rotate(90 * k, expand=True)
                label = label.rotate(90 * k, expand=True)
        image = image.resize((self.cfg.tile_w, self.cfg.tile_h))
        label = label.resize((self.cfg.tile_w, self.cfg.tile_h),
                             Image.NEAREST)
        return np.asarray(image, np.uint8), np.asarray(label).astype(np.int32)

    def batches(self, batch_size: Optional[int] = None,
                shuffle: Optional[bool] = None,
                drop_remainder: bool = False
                ) -> Iterator[Dict[str, np.ndarray]]:
        bs = batch_size or self.cfg.batch_size
        shuffle = (not self.eval) if shuffle is None else shuffle
        order = np.arange(len(self.records))
        if shuffle:
            self._rng.shuffle(order)
        h, w = self.cfg.tile_h, self.cfg.tile_w
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            if drop_remainder and len(idx) < bs:
                return
            n = len(idx)
            batch = {
                "image": np.zeros((n, h, w, 3), np.uint8),
                "seg_label": np.zeros((n, h, w), np.int32),
                "cls_label": np.full((n,), -1, np.int32),
                "reg_label": np.zeros((n,), np.float32),
                "is_cls": np.zeros((n,), np.float32),
                "is_reg": np.zeros((n,), np.float32),
                "is_seg": np.zeros((n,), np.float32),
            }
            for bi, ri in enumerate(idx):
                rec = self.records[ri]
                img, lab = self._load(rec)
                batch["image"][bi] = img
                if rec.task is md.Task.SEG:
                    batch["seg_label"][bi] = lab
                    batch["is_seg"][bi] = 1.0
                elif rec.task is md.Task.CLS:
                    batch["cls_label"][bi] = int(rec.label)
                    batch["is_cls"][bi] = 1.0
                else:
                    batch["reg_label"][bi] = float(rec.label)
                    batch["is_reg"][bi] = 1.0
            yield batch


def cls_weights(impth: str, cfg: Config, ignore_index: Optional[int] = None,
                ignore_cls: bool = False, ignore_seg: bool = False):
    """Inverse-frequency class weights from a store, normalized to max 1
    (reference utils/preprocessing.py:226-276, cls and seg variants)."""
    store = md.load_store(impth)
    n_cls = np.zeros((cfg.num_classes,), np.int64)
    n_seg = np.zeros((cfg.num_classes,), np.int64)
    for rec in md.flatten_patches(store):
        if rec.task is md.Task.CLS and not ignore_cls:
            n_cls[int(rec.label)] += 1
        elif rec.task is md.Task.SEG and not ignore_seg:
            lab = np.asarray(Image.open(str(rec.label)))
            n_seg += np.bincount(lab.reshape(-1).astype(np.int64),
                                 minlength=cfg.num_classes)[:cfg.num_classes]
    if ignore_index is not None:
        n_cls[ignore_index] = 0
        n_seg[ignore_index] = 0

    def inv(n):
        out = np.zeros((cfg.num_classes,), np.float64)
        nz = np.nonzero(n)[0]
        if len(nz):
            r = n[nz] / (cfg.epsilon + n.sum())
            r = 1.0 / r
            r /= (cfg.epsilon + r.max())
            out[nz] = r
        return out

    return inv(n_cls), inv(n_seg)


def normalize_batch_images(image_u8: torch.Tensor, cfg: Config,
                           generator: Optional[torch.Generator] = None,
                           train: bool = False) -> torch.Tensor:
    """(B, H, W, 3) uint8 → normalized float32 (float64 under an f64
    ``compute_dtype``), on the input's device. With ``train`` and a
    ``generator`` (on that device), each image first takes the reference
    augmentor's color jitter (utils/preprocessing.py:206-218) with
    factors drawn from the generator."""
    dt = torch.float64 if cfg.compute_dtype == "float64" else torch.float32
    img = image_u8.to(dt) / 255.0
    if train and generator is not None:
        img = apply_color_jitter(
            img, draw_jitter_factors(img.shape[0], generator, dtype=dt))
    return normalize(img, cfg.dataset_mean, cfg.dataset_std)
