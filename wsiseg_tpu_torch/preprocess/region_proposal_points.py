"""Keypoint-proposal generators for HR (multi-patch) training stores —
counterpart of ``wsiseg_tpu/preprocess/region_proposal_points.py``
(reference ``preprocess/region_proposal_points.py`` (connected components),
``region_proposal_points_slic.py`` (SLIC superpixels), and
``region_proposal_points_patch.py`` (plain photos under the ``'P'`` key)).

Per region: 8 k-means centers + 8 perimeter points; CC perimeters are
concave-hull + arclength-uniform resampled (reference :101-107 via
concaveHull + evenly_spaced_points_on_a_contour), SLIC perimeters are
stride-subsampled bwperim. Output is the nested gt.npy HR store consumed by
``wsiseg_tpu_torch.data.regions.HRRegionDataset``.

The tissue mask (``find_nuclei``), SLIC and the keypoints' k-means run on
``device`` (k-means++ seeds from ``np.random.RandomState`` on the host:
centers differ from JAX's by design, ROADMAP.md §3); the connected
components, hulls and contours on the host, as in JAX. The SLIC mode
builds a full-size mask a superpixel, as JAX does (ROADMAP.md §1, item
7).
"""

from __future__ import annotations

import glob

import os
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from wsiseg_tpu_torch.cli.common import add_device_flag
from wsiseg_tpu_torch.config import Config, parse_args
from wsiseg_tpu_torch.data import metadata as md
from wsiseg_tpu_torch.data.regions import (HR_NUM_CNT_SAMPLES,
                                           HR_NUM_PERIM_SAMPLES,
                                           get_key_points)
from wsiseg_tpu_torch.infer.engine import resolve_device
from wsiseg_tpu_torch.ops.cc import connected_components
from wsiseg_tpu_torch.ops.contour import evenly_spaced_points_on_a_contour
from wsiseg_tpu_torch.ops.hull import concave_hull_points
from wsiseg_tpu_torch.proposals import perimeter_keypoints
from wsiseg_tpu_torch.slides.reader import (SlideReader, glob_slides,
                                            open_slide)
from wsiseg_tpu_torch.utils.filesystem import make_folder


def _mode(vals: np.ndarray) -> int:
    from scipy import stats as sstats
    return int(sstats.mode(vals, keepdims=True)[0][0])


def _tissue_mask(slide: SlideReader, scan_level: int,
                 device="cuda") -> np.ndarray:
    from wsiseg_tpu_torch.ops.tissue import find_nuclei

    wsi = slide.read_level(scan_level)
    x, y = wsi.shape[1], wsi.shape[0]
    small = np.array(Image.fromarray(wsi).resize((x // 4, y // 4)))
    m = find_nuclei(torch.from_numpy(small).to(
        resolve_device(device))).cpu().numpy()
    return np.asarray(Image.fromarray(m.astype(np.uint8)).resize(
        (x, y), Image.NEAREST))


def concave_perimeter_points(region: np.ndarray, us: int,
                             num_points: int = HR_NUM_PERIM_SAMPLES) -> np.ndarray:
    """Downsample the region, bwperim, k-NN concave hull, arclength-uniform
    resample, scale back (reference region_proposal_points.py:101-107)."""
    small = np.asarray(Image.fromarray(region.astype(np.uint8)).resize(
        (region.shape[1] // us, region.shape[0] // us)))
    coords = perimeter_keypoints(small, num_points=10 ** 9)  # full perim
    if coords.shape[0] < 4:
        return np.zeros((0, 2))
    hull = concave_hull_points(coords.astype(float), k=3)
    if hull is None or len(hull) < 2:
        hull = coords
    return evenly_spaced_points_on_a_contour(hull, num_points) * us


def generate_cc(raw_pth: str, out_pth: str, cfg: Config,
                us_kmeans: int = 8, scan_level: int = 2,
                device="cuda") -> dict:
    """CC-based proposals (region_proposal_points.py:33-171): one entry per
    GT connected component at ``metadata[slide][cc_id][0]``."""
    from wsiseg_tpu_torch.data import annotations as ann

    device = resolve_device(device)
    make_folder(out_pth, purge=True)
    metadata = md.load_store(out_pth)

    for wsipath in glob_slides(raw_pth):
        stem = os.path.splitext(wsipath)[0]
        xml = stem + ".xml"
        if not os.path.exists(xml):
            continue
        filename = os.path.basename(wsipath)
        slide = open_slide(wsipath)
        gt = ann.get_gt_aperio(xml, slide, cfg.scan_level)
        labels, n = connected_components((gt > 0).astype(np.uint8))

        metadata[filename] = {}
        for tile_id in range(1, int(labels.max()) + 1):
            region = labels == tile_id
            current_label = _mode(gt[region])
            k, center_pts, _, _ = get_key_points(
                region, us_kmeans, HR_NUM_CNT_SAMPLES, HR_NUM_CNT_SAMPLES,
                device=device)
            if k is None:
                continue
            perim_coords = concave_perimeter_points(region, us_kmeans)
            metadata[filename].setdefault(tile_id, {})[0] = {
                "cnt_xy": center_pts,
                "perim_xy": perim_coords,
                "label": current_label,
                "wsipath": wsipath,
                "scan_level": scan_level,
            }
    md.save_store(metadata, out_pth)
    return metadata


def generate_slic(raw_pth: str, out_pth: str, cfg: Config,
                  us_kmeans: int = 4, scan_level: int = 2,
                  num_segments: int = 1000, sigma: float = 5.0,
                  compactness: float = 20.0, device="cuda") -> dict:
    """SLIC-based proposals (region_proposal_points_slic.py:29-107): one
    entry per superpixel at ``metadata[slide][0][tile_id]``; background
    superpixels require ≥90% tissue."""
    from wsiseg_tpu_torch.data import annotations as ann
    from wsiseg_tpu_torch.ops.slic import slic as slic_op

    dev = resolve_device(device)
    make_folder(out_pth, purge=True)
    metadata = md.load_store(out_pth)

    for wsipath in glob_slides(raw_pth):
        stem = os.path.splitext(wsipath)[0]
        xml = stem + ".xml"
        if not os.path.exists(xml):
            continue
        filename = os.path.basename(wsipath)
        slide = open_slide(wsipath)
        gt = ann.get_gt_aperio(xml, slide, cfg.scan_level)
        wsi = slide.read_level(scan_level)
        x, y = wsi.shape[1], wsi.shape[0]
        wsi_small = np.array(Image.fromarray(wsi).resize((x // 4, y // 4)))
        wsi_mask = _tissue_mask(slide, scan_level, dev)

        labels = slic_op(torch.from_numpy(wsi_small).to(dev),
                         n_segments=num_segments, sigma=sigma,
                         compactness=compactness).cpu().numpy()
        labels = np.asarray(Image.fromarray(labels.astype(np.uint16)).resize(
            (x, y), Image.NEAREST))

        metadata[filename] = {0: {}}
        for tile_id in range(1 + int(labels.max())):
            region = labels == tile_id
            if not region.any():
                continue
            k, center_pts, _, fg_idx = get_key_points(
                region, us_kmeans, HR_NUM_CNT_SAMPLES, HR_NUM_CNT_SAMPLES,
                device=dev)
            if k is None:
                continue
            current_label = _mode(gt[region])
            if current_label < 1 and fg_idx[0].shape[0] > 0 and \
                    np.count_nonzero(wsi_mask[fg_idx]) / fg_idx[0].shape[0] < 0.9:
                continue
            metadata[filename][0][tile_id] = {
                "cnt_xy": center_pts,
                "perim_xy": perimeter_keypoints(region),
                "wsipath": wsipath,
                "label": current_label,
                "scan_level": scan_level,
                "tile_id": tile_id,
            }
    md.save_store(metadata, out_pth)
    return metadata


def generate_patch(patch_folder: str, out_pth: str, cfg: Config,
                   cls_codes: Optional[dict] = None) -> dict:
    """Plain-photo proposals under the ``'P'`` key
    (region_proposal_points_patch.py:27-52): dimensions only; synthetic
    keypoints are made at dataset-build time."""
    from wsiseg_tpu_torch.preprocess.patch_to_gt import CLS_CODES

    cls_codes = cls_codes or CLS_CODES
    make_folder(out_pth)
    metadata = md.load_store(out_pth)
    metadata.setdefault("P", {})[0] = {}

    index = 0
    for cls_folder in sorted(glob.glob(os.path.join(patch_folder, "*/"))):
        cls_name = os.path.basename(os.path.dirname(cls_folder))
        if cls_name not in cls_codes:
            continue
        for image_path in sorted(glob.glob(os.path.join(cls_folder, "*.png"))
                                 + glob.glob(os.path.join(cls_folder, "*.tif"))):
            dimensions = Image.open(image_path).size
            metadata["P"][0][index] = {
                "cnt_xy": None,
                "perim_xy": None,
                "label": cls_codes[cls_name],
                "wsipath": image_path,
                "scan_level": None,
                "dimensions": dimensions,
            }
            index += 1
    md.save_store(metadata, out_pth)
    return metadata


def main(argv: Optional[Sequence[str]] = None) -> dict:
    import argparse
    p = argparse.ArgumentParser(description="HR keypoint proposal stores")
    p.add_argument("--mode", choices=("cc", "slic", "patch"), default="cc")
    add_device_flag(p, "the tissue mask, SLIC and k-means run (modes cc "
                       "and slic)")
    ns, rest = p.parse_known_args(argv)
    cfg = parse_args(rest)
    if ns.mode == "cc":
        return generate_cc(cfg.raw_train_pth, cfg.train_hr_image_pth, cfg,
                           device=ns.device)
    if ns.mode == "slic":
        return generate_slic(cfg.raw_train_pth, cfg.train_hr_image_pth, cfg,
                             device=ns.device)
    if not cfg.patch_folder:
        raise SystemExit("--patch_folder is required for patch mode")
    return generate_patch(cfg.patch_folder, cfg.train_hr_image_pth, cfg)


if __name__ == "__main__":
    main()
