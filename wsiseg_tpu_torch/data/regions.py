"""Region keypoints and the multi-patch (HR) region datasets — counterpart
of ``wsiseg_tpu/data/regions.py`` (reference ``utils/regiontools.py`` and
``utils/dataset_hr.py``).

A region (connected component, SLIC superpixel or plain patch) is 8
k-means center points + 8 perimeter points; training and eval read one
64×64 patch at pyramid level 1 around each point and stack them to
(P=16, 64, 64, 3) for :class:`~wsiseg_tpu_torch.models.ensemble.
MultiPatchResNet`.

The host work is the JAX package's, line for line: PIL resizes, the
16384-point cap with its ``RandomState(seed)`` subsample, the host
nearest-center labelling past the cap, the datasets' ``RandomState``
draws in the same order. So for one seed the batches are JAX's. The
k-means runs on ``device`` (:func:`~wsiseg_tpu_torch.ops.kmeans.kmeans`:
host k-means++ seeds, Lloyd on the device); its seeds are not JAX's
threefry draws, so cluster ids and centers differ from JAX's, as JAX's
differ from the reference's sklearn (SURVEY.md §7f). JAX pads the points
to a power of two for its compile cache; zero weights add nothing, so the
port does not pad.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from PIL import Image

from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.data import metadata as md
from wsiseg_tpu_torch.ops.geometry import map_points
from wsiseg_tpu_torch.ops.kmeans import kmeans
from wsiseg_tpu_torch.ops.morphology import erode
from wsiseg_tpu_torch.ops.tissue import find_nuclei
from wsiseg_tpu_torch.slides.reader import SlideReader, open_slide
from wsiseg_tpu_torch.utils.filesystem import fix_path

# Reference constants (utils/dataset_hr.py:14-18).
HR_NUM_CNT_SAMPLES = 8
HR_NUM_PERIM_SAMPLES = 8
HR_SCAN_LEVEL = 1
HR_PATCH_W = 64
HR_PATCH_H = 64
HR_NUM_SAMPLES = HR_NUM_CNT_SAMPLES + HR_NUM_PERIM_SAMPLES
#: k-means point cap: a near-slide-sized region would build (N, K)
#: one-hot intermediates of GBs otherwise; centers from a uniform
#: subsample are statistically equivalent
MAX_KMEANS_POINTS = 16384


def get_key_points(image: np.ndarray, us: int, min_clusters: int,
                   max_clusters: int = 9999999, seed: int = 0,
                   device="cuda"):
    """K-means keypoints of a binary/label region mask — reference
    utils/regiontools.py:68-102: the mask downsampled by ``us`` (PIL), its
    foreground (x, y) coordinates k-means'd on ``device`` into
    ``min_clusters`` clusters, the centers scaled back up, and the cluster
    assignments painted into a full-resolution label image.

    Returns ``(num_clusters, cnt_pts (K,2) int xy, label_img, fg_indices)``
    or ``(None, None, None, None)`` when the region is too small
    (reference :86-87)."""
    image = np.asarray(image)
    y, x = image.shape[:2]
    small = np.asarray(
        Image.fromarray(image.astype(np.uint8)).resize((x // us, y // us)))

    fg = np.nonzero(small)
    coords = np.transpose(fg)[:, ::-1].astype(np.float32)  # (x, y) pairs

    k = int(min(max(min_clusters, 1), max_clusters))
    if k <= 1 or coords.shape[0] <= 3 * k:
        return None, None, None, None

    sampled = coords
    if len(coords) > MAX_KMEANS_POINTS:
        idx = np.random.RandomState(seed).choice(
            len(coords), MAX_KMEANS_POINTS, replace=False)
        sampled = coords[idx]

    centers, labels = kmeans(
        torch.from_numpy(np.ascontiguousarray(sampled)).to(device), k,
        seed=seed)
    centers = centers.cpu().numpy()
    if sampled is coords:
        labels = labels.cpu().numpy()
    else:
        # label every foreground pixel by its nearest center (host, chunked)
        labels = np.empty(len(coords), np.int64)
        for i in range(0, len(coords), 1 << 20):
            ch = coords[i:i + (1 << 20)]
            d = ((ch[:, None, :] - centers[None]) ** 2).sum(-1)
            labels[i:i + (1 << 20)] = d.argmin(1)
    cnt_pts = (us * centers).astype(np.int64)

    out = np.zeros(small.shape[:2], np.uint16)
    out[fg] = labels + 1
    out = np.asarray(Image.fromarray(out).resize((x, y), Image.NEAREST))
    fg_indices = np.nonzero(out)
    return k, cnt_pts, out, fg_indices


def get_key_points_for_patch(dimensions, scan_level: int = HR_SCAN_LEVEL,
                             tile_w: int = HR_PATCH_W,
                             tile_h: int = HR_PATCH_H,
                             num_center_points: int = HR_NUM_CNT_SAMPLES,
                             num_perim_points: int = HR_NUM_PERIM_SAMPLES,
                             level_spacing: int = 4,
                             device="cuda") -> dict:
    """Synthetic keypoints for plain patches (no segmentation mask) —
    reference utils/regiontools.py:105-141: a border-inset rectangle
    provides the perimeter; k-means of its eroded interior (on
    ``device``) the centers."""
    y_max = dimensions[1] // level_spacing ** scan_level
    x_max = dimensions[0] // level_spacing ** scan_level

    mask = np.zeros((y_max, x_max), np.uint8)
    y_min, x_min = 32, 32
    mask[y_min:y_max - y_min, x_min:x_max - x_min] = 1

    # bwperim: foreground pixels with a 4-neighbor background
    inner = np.zeros_like(mask)
    inner[1:-1, 1:-1] = (mask[1:-1, 1:-1] & mask[:-2, 1:-1] & mask[2:, 1:-1]
                         & mask[1:-1, :-2] & mask[1:-1, 2:])
    perim = (mask == 1) & (inner == 0)
    perim_coords = np.transpose(np.where(perim))[:, ::-1]
    skip = max(2, perim_coords.shape[0] // num_perim_points)
    perim_coords = perim_coords[::skip, :]

    # 10×10 erosion (reference cv2.erode with ones(10,10))
    eroded = erode(torch.from_numpy(mask).to(device), 10).cpu().numpy()

    _, center_pts, _, _ = get_key_points(eroded, 1, num_center_points,
                                         num_center_points, device=device)
    if center_pts is None:
        center_pts = np.tile(np.array([[x_max // 2, y_max // 2]], np.int64),
                             (num_center_points, 1))

    center_pts = center_pts - [tile_w // 2, tile_h // 2]
    perim_coords = perim_coords - [tile_w // 2, tile_h // 2]
    return {"cnt_xy": center_pts, "perim_xy": perim_coords,
            "scan_level": scan_level}


def remove_white_region(mask: np.ndarray, arr: Optional[np.ndarray],
                        scan_level: int, tile_w: int, tile_h: int,
                        thresh: float = 0.9, level_spacing: int = 4):
    """Cull keypoints whose patch window is (mostly) background —
    reference utils/regiontools.py:40-65. ``mask`` lives at
    ``scan_level`` resolution; ``arr`` holds (x, y) points in the same
    frame."""
    if arr is None or arr.shape[0] < 1:
        return None, 0
    tw = int(tile_w / level_spacing ** scan_level)
    th = int(tile_h / level_spacing ** scan_level)
    keep = np.zeros((arr.shape[0],), bool)
    for ij, (x, y) in enumerate(arr):
        win = mask[y:y + th, x:x + tw]
        keep[ij] = (win.size > 0 and
                    np.count_nonzero(win) / (th * tw) >= thresh)
    arr = arr[keep]
    return arr, arr.shape[0]


def _select_centers(cnt_xy: np.ndarray, perim_xy: np.ndarray) -> np.ndarray:
    """Stride-subsample 8 center + 8 perimeter points and stack to (16, 2)
    (reference utils/dataset_hr.py:150-163: perim first, then centers,
    truncated/backfilled from the perimeter tail)."""
    step = max(1, cnt_xy.shape[0] // HR_NUM_CNT_SAMPLES)
    center_pts = cnt_xy[::step]
    step = max(1, perim_xy.shape[0] // HR_NUM_PERIM_SAMPLES)
    perim_pts = perim_xy[::step]
    centers = np.vstack((perim_pts, center_pts)).astype(np.int64)
    centers = centers[:HR_NUM_SAMPLES, :]
    remaining = HR_NUM_SAMPLES - centers.shape[0]
    if remaining > 0:
        centers = np.vstack((centers, perim_xy[-remaining:, :]))
    return centers


class HRRegionDataset:
    """Training dataset over a nested gt.npy region store (reference
    utils/dataset_hr.py:21-203). The keypoints of plain patches and the
    tissue masks of ``remove_white`` are computed on ``device``.

    Yields fixed-shape numpy batches:
      image     (B, 16, 64, 64, 3) uint8
      cls_label (B,) int32
    """

    def __init__(self, pth: str, cfg: Config, eval: bool = False,
                 remove_white: bool = False, duplicate_dataset: int = 1,
                 seed: int = 0, slide_opener=open_slide, device="cuda"):
        self.cfg = cfg
        self.eval = eval
        self.device = torch.device(device)
        self._rng = np.random.RandomState(seed)
        self._open = slide_opener
        metadata = md.load_store(pth)
        if not metadata:
            raise FileNotFoundError(f"no gt.npy under {pth}")
        metadata = copy.deepcopy(metadata)

        self.datalist: List[dict] = []
        cls = np.zeros((cfg.num_classes,), np.float64)

        # --- plain patches under the 'P' key (utils/dataset_hr.py:49-72) ---
        if "P" in metadata:
            P = metadata.pop("P")[0]
            per_dims: Dict[tuple, dict] = {}
            for key in P:
                d = tuple(P[key]["dimensions"])
                if d not in per_dims:
                    per_dims[d] = get_key_points_for_patch(
                        d, device=self.device)
                item = {**P[key], **per_dims[d]}
                self.datalist.append(item)
                cls[int(item["label"])] += 1

        # --- WSI regions (utils/dataset_hr.py:74-119) ---
        self.wsis: Dict[str, SlideReader] = {}
        for filename in metadata:
            regions = metadata[filename]
            first = regions[next(iter(regions))]
            first_sub = first[next(iter(first))]
            wsipath = fix_path(first_sub["wsipath"])
            if wsipath not in self.wsis:
                self.wsis[wsipath] = self._open(wsipath)
            scan = self.wsis[wsipath]
            iw, ih = scan.level_dimensions[0]

            white_mask = None
            if remove_white:
                white_mask = self._foreground_mask(scan)

            for conncomp in regions:
                for rid in regions[conncomp]:
                    obj = dict(regions[conncomp][rid])
                    obj["wsipath"] = fix_path(obj["wsipath"])
                    lvl = int(obj["scan_level"])
                    if remove_white and white_mask is not None:
                        obj["cnt_xy"], _ = remove_white_region(
                            white_mask, obj["cnt_xy"], lvl,
                            HR_PATCH_W, HR_PATCH_H)
                        obj["perim_xy"], _ = remove_white_region(
                            white_mask, obj["perim_xy"], lvl,
                            HR_PATCH_W, HR_PATCH_H)
                    if obj["cnt_xy"] is None or obj["perim_xy"] is None:
                        continue
                    obj["cnt_xy"], n_cnt = map_points(
                        obj["cnt_xy"], lvl, HR_PATCH_W, HR_PATCH_H, iw, ih)
                    obj["perim_xy"], n_perim = map_points(
                        obj["perim_xy"], lvl, HR_PATCH_W, HR_PATCH_H, iw, ih)
                    if (n_cnt >= HR_NUM_CNT_SAMPLES
                            and n_perim >= HR_NUM_PERIM_SAMPLES):
                        self.datalist.append(obj)
                        cls[int(obj["label"])] += 1

        # class ratios (reference sets args.cls_ratios, dataset_hr.py:130-133)
        total = cls.sum()
        self.cls_ratios = cls / total if total > 0 else cls

        if not eval and duplicate_dataset > 1:
            self.datalist = [d for d in self.datalist
                             for _ in range(duplicate_dataset)]

    def _foreground_mask(self, scan: SlideReader) -> np.ndarray:
        """Low-res tissue mask at the coarsest level (dataset_hr.py:85-92)."""
        top = scan.level_count - 1
        x, y = scan.level_dimensions[top]
        img = scan.read_level(top)
        small = np.asarray(Image.fromarray(img).resize((x // 4, y // 4)))
        m = find_nuclei(torch.from_numpy(small.copy()).to(self.device)).cpu()
        return np.asarray(
            Image.fromarray(m.numpy()).resize((x, y), Image.NEAREST))

    def __len__(self) -> int:
        return len(self.datalist)

    def _read_patches(self, item: dict) -> np.ndarray:
        centers = _select_centers(item["cnt_xy"], item["perim_xy"])
        patches = np.zeros((HR_NUM_SAMPLES, HR_PATCH_H, HR_PATCH_W, 3),
                           np.uint8)
        if "dimensions" in item:
            # plain patch: read image once, crop at level-scaled resolution
            # (dataset_hr.py:178-188)
            img = Image.open(item["wsipath"])
            ratio = 4 ** int(item["scan_level"])
            img = img.resize((img.size[0] // ratio, img.size[1] // ratio))
            arr = np.asarray(img.convert("RGB"))
            for cj, (x, y) in enumerate(centers):
                crop = np.full((HR_PATCH_H, HR_PATCH_W, 3), 255, np.uint8)
                sy0, sy1 = max(0, y), min(arr.shape[0], y + HR_PATCH_H)
                sx0, sx1 = max(0, x), min(arr.shape[1], x + HR_PATCH_W)
                if sy1 > sy0 and sx1 > sx0:
                    crop[sy0 - y:sy1 - y, sx0 - x:sx1 - x] = arr[sy0:sy1,
                                                                 sx0:sx1]
                patches[cj] = crop
        else:
            scan = self.wsis[item["wsipath"]]
            read_tiles = getattr(scan, "read_tiles", None)
            if read_tiles is not None:
                # batched threaded decode (native C++ reader); read_tiles
                # takes level coordinates — centers are level-0 (map_points)
                ds = scan.level_downsamples[HR_SCAN_LEVEL]
                patches[:] = read_tiles(
                    (centers[:, 0] / ds).astype(np.int64),
                    (centers[:, 1] / ds).astype(np.int64),
                    HR_SCAN_LEVEL, HR_PATCH_W, HR_PATCH_H)
            else:
                for cj, (x, y) in enumerate(centers):
                    patches[cj] = scan.read_region(
                        (int(x), int(y)), HR_SCAN_LEVEL,
                        (HR_PATCH_W, HR_PATCH_H))
        if not self.eval:
            # random 90° rotation per patch (dataset_hr.py:194-196)
            for cj in range(HR_NUM_SAMPLES):
                k = int(self._rng.randint(0, 4))
                if k:
                    patches[cj] = np.rot90(patches[cj], k)
        return patches

    def batches(self, batch_size: Optional[int] = None,
                shuffle: Optional[bool] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        bs = batch_size or self.cfg.batch_size
        shuffle = (not self.eval) if shuffle is None else shuffle
        order = np.arange(len(self.datalist))
        if shuffle:
            self._rng.shuffle(order)
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            n = len(idx)
            batch = {
                "image": np.zeros((n, HR_NUM_SAMPLES, HR_PATCH_H,
                                   HR_PATCH_W, 3), np.uint8),
                "cls_label": np.zeros((n,), np.int32),
            }
            for bi, ri in enumerate(idx):
                item = self.datalist[ri]
                batch["image"][bi] = self._read_patches(item)
                batch["cls_label"][bi] = int(item["label"])
            yield batch


class HRRegionEvalDataset:
    """Eval dataset over in-memory proposal metadata — reference
    utils/dataset_hr.py:218-306 (the slic/scannet pipelines).

    ``metadata`` maps region key → {wsipath, cnt_xy, perim_xy, scan_level,
    tile_id}. Batches add ``tile_id (B,) int32`` instead of labels. Each
    keypoint is one ``read_region``, as in the reference (the training
    dataset batches them through ``read_tiles``; ROADMAP.md §3).
    """

    def __init__(self, metadata: dict, cfg: Config,
                 slide_opener=open_slide, slide: Optional[SlideReader] = None):
        self.cfg = cfg
        first = metadata[next(iter(metadata))]
        wsipath = fix_path(first["wsipath"])
        self.scan = slide if slide is not None else slide_opener(wsipath)
        iw, ih = self.scan.level_dimensions[0]

        self.datalist: List[dict] = []
        for key in metadata:
            obj = dict(metadata[key])
            lvl = int(obj["scan_level"])
            obj["cnt_xy"], n_cnt = map_points(
                obj["cnt_xy"], lvl, HR_PATCH_W, HR_PATCH_H, iw, ih)
            obj["perim_xy"], n_perim = map_points(
                obj["perim_xy"], lvl, HR_PATCH_W, HR_PATCH_H, iw, ih)
            if (n_cnt >= HR_NUM_CNT_SAMPLES
                    and n_perim >= HR_NUM_PERIM_SAMPLES):
                self.datalist.append(obj)

    def __len__(self) -> int:
        return len(self.datalist)

    def batches(self, batch_size: Optional[int] = None) -> Iterator[Dict]:
        bs = batch_size or self.cfg.batch_size
        for start in range(0, len(self.datalist), bs):
            items = self.datalist[start:start + bs]
            n = len(items)
            batch = {
                "image": np.zeros((n, HR_NUM_SAMPLES, HR_PATCH_H,
                                   HR_PATCH_W, 3), np.uint8),
                "tile_id": np.zeros((n,), np.int32),
            }
            for bi, item in enumerate(items):
                centers = np.vstack((
                    item["perim_xy"][:HR_NUM_PERIM_SAMPLES],
                    item["cnt_xy"][:HR_NUM_CNT_SAMPLES])).astype(np.int64)
                for cj, (x, y) in enumerate(centers):
                    batch["image"][bi, cj] = self.scan.read_region(
                        (int(x), int(y)), HR_SCAN_LEVEL,
                        (HR_PATCH_W, HR_PATCH_H))
                batch["tile_id"][bi] = int(item.get("tile_id", start + bi))
            yield batch


def validate_hr(forward_fn, dataset, cfg: Config) -> dict:
    """Region-ensemble validation — reference utils/regiontools.py:
    144-204: ensemble argmax accuracy + classwise accuracy from the
    confusion matrix. ``forward_fn(images_u8) -> (per_patch_logits,
    ensemble_logits)`` includes the normalization
    (:func:`wsiseg_tpu_torch.cli.common.make_hr_apply`)."""
    from wsiseg_tpu_torch.infer.metrics import (classwise_accuracy,
                                                confusion_matrix)

    preds: List[int] = []
    gts: List[int] = []
    for batch in dataset.batches():
        _, ens = forward_fn(batch["image"])
        preds.extend(np.argmax(np.asarray(ens), axis=-1).tolist())
        gts.extend(batch["cls_label"].tolist())
    preds_a, gts_a = np.asarray(preds), np.asarray(gts)
    acc = float(np.mean(preds_a == gts_a)) if len(gts_a) else 0.0
    cm = confusion_matrix(gts_a, preds_a, cfg.num_classes)
    return {"acc": acc,
            "classwise_acc": classwise_accuracy(cm).tolist(),
            "confusion_matrix": cm.tolist()}
