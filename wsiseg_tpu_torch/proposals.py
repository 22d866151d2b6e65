"""Region-proposal pipelines: SLIC superpixels / connected components →
keypoint metadata → multi-patch ensemble inference → painted class mask —
counterpart of ``wsiseg_tpu/proposals.py`` (reference ``slic.py`` and
``scannet.py``, SURVEY.md §3.4).

Proposals come from a level-2 label image; each gets 8 k-means center +
8 perimeter keypoints (:func:`~wsiseg_tpu_torch.data.regions.
get_key_points`, k-means on ``device``), the region ensemble classifies
each from 16 64×64 patches at level 1, and the predicted class is
painted over the proposal's pixels. The proposal loops iterate
``range(int(labels.max()))`` and so never visit the last label: the
reference's quirk (slic.py:56), kept as JAX keeps it (ROADMAP.md §3).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
from PIL import Image

from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.data.regions import (HR_NUM_CNT_SAMPLES,
                                           HR_NUM_PERIM_SAMPLES,
                                           HRRegionEvalDataset,
                                           get_key_points)
from wsiseg_tpu_torch.slides.reader import SlideReader


def perimeter_keypoints(region_mask: np.ndarray,
                        num_points: int = HR_NUM_PERIM_SAMPLES) -> np.ndarray:
    """Stride-subsampled bwperim coordinates as (x, y) pairs
    (reference slic.py:62-66)."""
    m = region_mask.astype(bool)
    inner = np.zeros_like(m)
    inner[1:-1, 1:-1] = (m[1:-1, 1:-1] & m[:-2, 1:-1] & m[2:, 1:-1]
                         & m[1:-1, :-2] & m[1:-1, 2:])
    perim = m & ~inner
    coords = np.transpose(np.where(perim))[:, ::-1]
    if coords.shape[0] == 0:
        return np.zeros((0, 2), np.int64)
    skip = max(2, coords.shape[0] // num_points)
    return coords[::skip, :]


def slic_proposals(labels: np.ndarray, wsipath: str, scan_level: int = 2,
                   us_kmeans: int = 4, device="cuda") -> Dict[int, dict]:
    """Per-superpixel keypoint metadata (reference slic.py:54-75).

    ``labels`` is the (H, W) SLIC label image at thumbnail resolution
    (already upscaled to level-2 size like the reference :48-52)."""
    metadata: Dict[int, dict] = {}
    for tile_id in range(int(labels.max())):
        region = labels == tile_id
        n, center_pts, _, fg_idx = get_key_points(
            region, us_kmeans, HR_NUM_CNT_SAMPLES, HR_NUM_CNT_SAMPLES,
            device=device)
        if n is None:
            continue
        metadata[tile_id] = {
            "cnt_xy": center_pts,
            "perim_xy": perimeter_keypoints(region),
            "wsipath": wsipath,
            "scan_level": scan_level,
            "foreground_indices": fg_idx,
            "tile_id": tile_id,
        }
    return metadata


def cc_proposals(labels: np.ndarray, wsipath: str,
                 tissue_mask: Optional[np.ndarray] = None,
                 scan_level: int = 2, us_kmeans: int = 4,
                 large_frac: float = 0.05, device="cuda") -> Dict[int, dict]:
    """Connected-component proposals with small/large-region split
    (reference scannet.py:65-127): small CCs (bbox ≤ 5% of image) become one
    proposal; large CCs are k-means-split into sub-regions, each a proposal.
    Sub-regions of the background CC (id 0) require ≥50% tissue."""
    metadata: Dict[int, dict] = {}
    patch_id = 0
    total = labels.size
    for tile_id in range(int(labels.max())):
        region = labels == tile_id
        area = np.count_nonzero(region)
        if area == 0:
            continue
        num_clusters = 2 + int(area / (0.01 * total))
        n, center_pts, out_image, fg_idx = get_key_points(
            region, us_kmeans, num_clusters, num_clusters, device=device)

        idx = np.where(region)
        h = 1 + idx[0].max() - idx[0].min()
        w = 1 + idx[1].max() - idx[1].min()

        if n is not None and (w * h) / total <= large_frac:
            metadata[patch_id] = {
                "cnt_xy": center_pts,
                "perim_xy": perimeter_keypoints(region),
                "wsipath": wsipath,
                "scan_level": scan_level,
                "foreground_indices": fg_idx,
                "tile_id": patch_id,
            }
            patch_id += 1
        elif n is not None:
            for r_id in range(1, n + 1):
                sub = out_image == r_id
                sub_n, sub_centers, _, sub_fg = get_key_points(
                    sub, us_kmeans, num_clusters, device=device)
                if sub_n is None:
                    continue
                if (tile_id == 0 and tissue_mask is not None
                        and sub_fg[0].shape[0] > 0
                        and np.count_nonzero(tissue_mask[sub_fg])
                        / sub_fg[0].shape[0] < 0.5):
                    continue
                metadata[patch_id] = {
                    "cnt_xy": sub_centers,
                    "perim_xy": perimeter_keypoints(sub),
                    "wsipath": wsipath,
                    "scan_level": scan_level,
                    "foreground_indices": sub_fg,
                    "tile_id": patch_id,
                }
                patch_id += 1
    return metadata


def classify_proposals(forward_fn: Callable, metadata: Dict[int, dict],
                       out_shape: Tuple[int, int], cfg: Config,
                       slide: Optional[SlideReader] = None,
                       gate_class_probs: bool = False) -> np.ndarray:
    """Run the region-ensemble model over every proposal and paint the
    argmax class over each proposal's foreground pixels
    (reference slic.py:89-99, scannet.py:141-155).

    ``forward_fn(images_u8 (B, P, h, w, 3)) -> ensemble logits (B, C)`` as
    numpy. ``gate_class_probs`` applies the per-class probability floor
    before the argmax (scannet.py:149-151)."""
    pred_mask = np.zeros(out_shape, np.int32)
    if not metadata:
        return pred_mask
    ds = HRRegionEvalDataset(metadata, cfg, slide=slide)
    for batch in ds.batches():
        logits = np.asarray(forward_fn(batch["image"]))
        if gate_class_probs:
            e = np.exp(logits - logits.max(axis=1, keepdims=True))
            probs = e / e.sum(axis=1, keepdims=True)
            for cj in range(cfg.num_classes):
                probs[probs[:, cj] < cfg.class_probs[cj], cj] = 0
            preds = np.argmax(probs, axis=1)
        else:
            preds = np.argmax(logits, axis=1)
        for tj, tile_id in enumerate(batch["tile_id"]):
            pred_mask[metadata[int(tile_id)]["foreground_indices"]] = preds[tj]
    return pred_mask


def paint_mask_rgb(pred_mask: np.ndarray, num_classes: int = 4,
                   downscale: int = 4) -> Image.Image:
    """Class mask → RGB PNG like the reference's one-hot painter
    (slic.py:101-104: classes 1..3 map to R/G/B at full intensity)."""
    rgb = np.eye(num_classes)[pred_mask][..., 1:]
    img = Image.fromarray((rgb.astype(np.uint8)) * 255)
    if downscale > 1:
        img = img.resize((pred_mask.shape[1] // downscale,
                          pred_mask.shape[0] // downscale))
    return img
