"""Artifact writers with the reference's file naming — counterpart of the
heatmap/overlay writers of ``wsiseg_tpu/infer/writers.py``:
``{val_save_pth}/{ep}/{key}_{stride}_heatmap.png`` and ``..._overlay.png``.

PIL is imported when a PNG is written, not when the module is imported.
"""

from __future__ import annotations

import os

import numpy as np

from wsiseg_tpu.config import Config
from wsiseg_tpu.utils.filesystem import make_folder


def _save_png(pth: str, img: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(img).save(pth)


def _out_dir(cfg: Config, ep) -> str:
    d = os.path.join(cfg.val_save_pth, str(ep))
    make_folder(d)
    return d


def save_heatmap(cfg: Config, ep, key: str, heatmap01: np.ndarray) -> str:
    """uint8 heatmap PNG."""
    pth = os.path.join(_out_dir(cfg, ep),
                       f"{key}_{cfg.tile_stride_w}_heatmap.png")
    _save_png(pth, np.uint8(255 * np.clip(heatmap01, 0, 1)))
    return pth


def save_overlay(cfg: Config, ep, key: str, wsi_rgb: np.ndarray,
                 heatmap01: np.ndarray, thresh: float = 0.99) -> str:
    """0.75·wsi + 0.25·255·(heat>thresh) overlay."""
    hot = (heatmap01 > thresh).astype(np.float32)[..., None]
    out = wsi_rgb.astype(np.float32) * 0.75 + 255.0 * hot * 0.25
    pth = os.path.join(_out_dir(cfg, ep),
                       f"{key}_{cfg.tile_stride_w}_overlay.png")
    _save_png(pth, np.uint8(out))
    return pth
