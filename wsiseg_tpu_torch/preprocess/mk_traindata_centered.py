"""GT-centered training-tile extraction from annotated WSIs — counterpart
of ``wsiseg_tpu/preprocess/mk_traindata_centered.py`` (reference
``preprocess/mk_traindata_bach_centered.py`` (Aperio XML) and
``mk_traindata_sunnybrook_centered.py`` (Sedeen XML)).

Per slide: rasterize the annotation at scan level, take connected
components; a small component yields one tile centered on it (edge-snapped,
mk_traindata_bach_centered.py:80-90); a large component is k-means-split
into ~area/tile² centers, one tile each (:125-136). Tiles and GT-raster
crops are written as ``w_*/g_*.png`` with a gt.npy store.

The k-means runs on ``device`` (:func:`~wsiseg_tpu_torch.ops.kmeans.
kmeans`, whose k-means++ seeds come from ``np.random.RandomState(seed)``
on the host, not JAX's threefry: tile centers differ from JAX's by design,
ROADMAP.md §3); the connected components stay on the host, as in JAX.
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
from wsiseg_tpu_torch.data import metadata as md
from wsiseg_tpu_torch.infer.engine import resolve_device
from wsiseg_tpu_torch.ops.cc import connected_components_with_stats
from wsiseg_tpu_torch.ops.geometry import nextpow2
from wsiseg_tpu_torch.slides.reader import (SlideReader, glob_slides,
                                            open_slide)
from wsiseg_tpu_torch.utils.filesystem import make_folder


def _snap(c, half, pwh, dim):
    """Center → [lo, hi) window of width pwh, snapped inside [1, dim)
    (reference mk_traindata_bach_centered.py:80-90)."""
    lo, hi = max(c - half, 1), min(c + half, dim)
    if lo == 1:
        hi = lo + pwh
    if hi == dim:
        lo = hi - pwh
    return lo, hi


def _save_pair(slide: SlideReader, gt: np.ndarray, left: int, up: int,
               pwh: int, cfg: Config, out_pth: str, filename: str,
               patch_id: int, metadata: dict) -> None:
    tilepth_w = os.path.join(out_pth, f"w_{filename}_{patch_id}.png")
    tilepth_g = os.path.join(out_pth, f"g_{filename}_{patch_id}.png")
    metadata.setdefault(filename, {})[patch_id] = {
        "wsi": tilepth_w, "label": tilepth_g}

    gt_patch = Image.fromarray(
        gt[up:up + pwh, left:left + pwh].astype(np.uint8))
    if cfg.scan_resize != 1:
        gt_patch = gt_patch.resize((cfg.tile_w, cfg.tile_h))
    gt_patch.save(tilepth_g)

    ds = slide.level_downsamples[cfg.scan_level]
    wsi_patch = slide.read_region(
        (int(left * ds), int(up * ds)), cfg.scan_level, (pwh, pwh))
    img = Image.fromarray(wsi_patch)
    if cfg.scan_resize != 1:
        img = img.resize((cfg.tile_w, cfg.tile_h))
    img.save(tilepth_w)


def generate_for_slide(slide: SlideReader, wsipath: str, gt: np.ndarray,
                       cfg: Config, out_pth: str, metadata: dict,
                       patch_id: int = 0, seed: int = 0,
                       region_support: Optional[np.ndarray] = None,
                       device="cuda") -> int:
    """Extract centered tiles for one slide given its GT raster at scan
    level. Returns the next patch_id.

    ``region_support`` optionally provides the binary mask whose connected
    components define regions (defaults to ``gt > 0``); the normals
    generator passes the tissue mask here with an all-zero ``gt``.
    """
    from wsiseg_tpu_torch.ops.kmeans import kmeans

    dev = resolve_device(device)
    filename = os.path.basename(wsipath)
    metadata.setdefault(filename, {})
    support = (gt > 0) if region_support is None else (region_support > 0)
    cc = connected_components_with_stats(support.astype(np.uint8))
    tile_max = cfg.scan_resize * max(cfg.tile_w, cfg.tile_h)

    for tile_id in range(1, cc.num):
        l, u, w, h, area = cc.stats[tile_id]
        if area == 0:
            continue
        cx, cy = cc.centroids[tile_id].astype(np.int64)
        pwh = nextpow2(max(w, h))

        if pwh <= tile_max:
            # small region: one centered, edge-snapped tile
            pwh = tile_max
            up, _ = _snap(cy, pwh // 2, pwh, gt.shape[0])
            left, _ = _snap(cx, pwh // 2, pwh, gt.shape[1])
            _save_pair(slide, gt, left, up, pwh, cfg, out_pth, filename,
                       patch_id, metadata)
            patch_id += 1
        else:
            # large region: k-means centers, one tile each (:125-136)
            us = 1 if gt.size / area <= 0.5 else 16
            region = (cc.labels[u:u + h, l:l + w] == tile_id)
            region = np.asarray(Image.fromarray(
                (255 * region).astype(np.uint8)).resize(
                    (region.shape[1] // us, region.shape[0] // us)))
            coords = np.transpose(np.where(region))[:, ::-1].astype(np.float32)
            if coords.shape[0] < 2:
                continue
            # tile count from the DOWNSAMPLED bbox size, matching the
            # reference (mk_traindata_bach_centered.py:133 computes
            # prod(label_patch.size) AFTER the //us resize)
            k = int(np.ceil(np.prod(region.shape)
                            / (cfg.tile_w * cfg.tile_h)) + 1)
            k = min(k, coords.shape[0])
            centers, _ = kmeans(torch.from_numpy(coords).to(dev), k,
                                seed=seed)
            cnt_pts = (us * centers.cpu().numpy()).astype(np.int64)

            pwh = tile_max
            for _cx, _cy in cnt_pts:
                up, down = _snap(_cy + u, pwh // 2, pwh, gt.shape[0])
                left, right = _snap(_cx + l, pwh // 2, pwh, gt.shape[1])
                if up >= down or left >= right:
                    continue
                _save_pair(slide, gt, left, up, pwh, cfg, out_pth, filename,
                           patch_id, metadata)
                patch_id += 1
    return patch_id


def generate(raw_pth: str, out_pth: str, cfg: Config,
             fmt: str = "aperio", device="cuda") -> dict:
    from wsiseg_tpu_torch.data import annotations as ann

    device = resolve_device(device)
    make_folder(out_pth)
    metadata = md.load_store(out_pth)
    patch_id = 0
    for wsipath in glob_slides(raw_pth):
        stem = os.path.splitext(wsipath)[0]
        slide = open_slide(wsipath)
        if fmt == "sedeen":
            xmls = glob.glob(stem + "*.session.xml")
            if not xmls:
                continue
            gt = ann.get_gt_sedeen(xmls[0], slide, cfg.scan_level)
        else:
            xml = stem + ".xml"
            if not os.path.exists(xml):
                continue
            gt = ann.get_gt_aperio(xml, slide, cfg.scan_level)
        patch_id = generate_for_slide(slide, wsipath, gt, cfg, out_pth,
                                      metadata, patch_id, device=device)
    md.save_store(metadata, out_pth)
    return metadata


def main(argv: Optional[Sequence[str]] = None) -> dict:
    import argparse
    p = argparse.ArgumentParser(description="centered training tiles")
    p.add_argument("--fmt", choices=("aperio", "sedeen"), default="aperio")
    ns, rest = p.parse_known_args(argv)
    dev, rest = parse_device_flag(rest, "k-means runs")
    cfg = parse_args(rest)
    meta = generate(cfg.raw_train_pth, cfg.train_image_pth, cfg, fmt=ns.fmt,
                    device=dev.device)
    print(f"wrote {sum(len(v) for v in meta.values())} tiles")
    return meta


if __name__ == "__main__":
    main()
