"""Artifact writers with the reference's file naming — counterpart of
``wsiseg_tpu/infer/writers.py``:
``{val_save_pth}/{ep}/{key}_{stride}_heatmap.png``, ``..._overlay.png``,
the color mask ``{key}_{stride}.png`` and ``Ozan_Results_{ep}.csv``.

PIL is imported when a PNG is written, not when the module is imported.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.utils.filesystem import make_folder


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


def save_color_mask(cfg: Config, ep, key: str, mask_rgb: np.ndarray,
                    half_size: bool = True) -> str:
    """Class-color mask PNG, saved at half resolution (PIL's default
    resample) like the reference (utils/eval.py:139-145)."""
    from PIL import Image
    img = Image.fromarray(mask_rgb.astype(np.uint8))
    if half_size:
        img = img.resize((img.width // 2, img.height // 2))
    pth = os.path.join(_out_dir(cfg, ep), f"{key}_{cfg.tile_stride_w}.png")
    img.save(pth)
    return pth


def write_breastpathq_csv(ep, rows, out_dir: str = ".") -> str:
    """SPIE BreastPathQ submission CSV (utils/eval.py:367-412).

    rows: iterable of (slide_id, region_id, prediction in [0,1])."""
    pth = os.path.join(out_dir, f"Ozan_Results_{ep}.csv")
    with open(pth, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["slide", "rid", "p"])
        w.writeheader()
        for slide_id, rid, p in rows:
            w.writerow({"slide": slide_id, "rid": rid, "p": p})
    return pth
