"""Same-sized-region (SSR) segmentation data — counterpart of the SSR
parts of ``wsiseg_tpu/data/ssr.py`` (reference ``utils/dataset_ssr.py``):
paired ``*_image.png`` / ``*_gt.png`` regions (an RGB mask → argmax class
labels with an implicit background channel, :50-52), oversampled ×10 for
training, and their class distribution. Batches are numpy and identical
to JAX's for one seed. Beside them the HR region parts: the class
distribution of an HR region store (``cls_ratios_hr``) and the gt.npy
region classification dataset (``SSRClsDataset``).
"""

from __future__ import annotations

import glob
from typing import Dict, Iterator, List, Optional

import numpy as np
from PIL import Image

from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.data import metadata as md
from wsiseg_tpu_torch.data.patches import Rows, draw_rotations, kept_rows
from wsiseg_tpu_torch.utils.filesystem import fix_path

# the reference resizes every region to 512×512 (dataset_ssr.py:47-48)
SSR_SIZE = 512


def _mask_labels(lab: np.ndarray) -> np.ndarray:
    """RGB mask → class index with implicit background channel 0
    (reference dataset_ssr.py:50-52); a single-channel mask as it is."""
    if lab.ndim == 3:
        lab = np.concatenate(
            [np.zeros((*lab.shape[:2], 1), lab.dtype), lab], axis=-1)
        lab = np.argmax(lab, axis=-1)
    return lab


class SSRSegDataset:
    """Paired image/GT region segmentation dataset."""

    def __init__(self, impth: str, cfg: Config, eval: bool = False,
                 duplicate: int = 10, seed: int = 0):
        self.cfg = cfg
        self.eval = eval
        self._rng = np.random.RandomState(seed)
        self.datalist: List[dict] = [
            {"image": pth, "label": pth.replace("_image.png", "_gt.png")}
            for pth in sorted(glob.glob(f"{impth}/*_image.png"))]
        if not self.datalist:
            raise FileNotFoundError(f"no *_image.png under {impth}")
        if not eval and duplicate > 1:
            self.datalist = [d for d in self.datalist
                             for _ in range(duplicate)]

    def __len__(self) -> int:
        return len(self.datalist)

    def _load(self, item: dict, k: int):
        image = Image.open(item["image"]).convert("RGB")
        label = Image.open(item["label"])
        if k:
            image = image.rotate(90 * k, expand=True)
            label = label.rotate(90 * k, expand=True)
        image = image.resize((SSR_SIZE, SSR_SIZE))
        label = label.resize((SSR_SIZE, SSR_SIZE))
        lab = _mask_labels(np.asarray(label))
        return np.asarray(image, np.uint8), lab.astype(np.int32)

    def batches(self, batch_size: Optional[int] = None,
                shuffle: Optional[bool] = None, rows: Rows = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Batches of ``batch_size`` items; with ``rows``, only the rows
        it keeps of each (``data.patches.Rows``)."""
        bs = batch_size or self.cfg.batch_size
        shuffle = (not self.eval) if shuffle is None else shuffle
        order = np.arange(len(self.datalist))
        if shuffle:
            self._rng.shuffle(order)
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            ks = np.asarray(draw_rotations(self._rng, len(idx), self.eval))
            keep = kept_rows(rows, len(idx))
            idx, ks = idx[keep], ks[keep]
            n = len(idx)
            batch = {
                "image": np.zeros((n, SSR_SIZE, SSR_SIZE, 3), np.uint8),
                "seg_label": np.zeros((n, SSR_SIZE, SSR_SIZE), np.int32),
            }
            for bi, (ri, k) in enumerate(zip(idx, ks)):
                img, lab = self._load(self.datalist[ri], int(k))
                batch["image"][bi] = img
                batch["seg_label"][bi] = lab
            yield batch


def cls_ratios_ssr(impth: str, cfg: Config, ignore_index=None,
                   option: str = "segmentation") -> np.ndarray:
    """Class distribution of an SSR dataset (reference
    utils/preprocessing.py:279-309): ``segmentation`` bincounts the
    labels of every ``*_gt.png``; ``classification`` counts gt.npy
    labels."""
    numsamples = np.zeros((cfg.num_classes,), np.float64)
    if option == "classification":
        store = md.load_store(impth)
        for key in store:
            for tile_id in store[key]:
                numsamples[int(store[key][tile_id]["label"])] += 1
    else:
        for pth in sorted(glob.glob(f"{impth}/*_gt.png")):
            lab = _mask_labels(np.asarray(Image.open(pth)))
            numsamples += np.bincount(
                lab.reshape(-1).astype(np.int64),
                minlength=cfg.num_classes)[:cfg.num_classes]
    if ignore_index is not None:
        numsamples[ignore_index] = 0
    total = numsamples.sum()
    return numsamples / total if total > 0 else numsamples


def cls_ratios_hr(impth: str, cfg: Config, ignore_index=None,
                  device="cuda") -> np.ndarray:
    """Class distribution of an HR region store — reference
    utils/preprocessing.py:312-355 (the dataset-side equivalent is
    ``HRRegionDataset.cls_ratios``, computed with the same validity
    filter; ``device`` runs the plain patches' keypoints)."""
    from wsiseg_tpu_torch.data.regions import HRRegionDataset

    ds = HRRegionDataset(impth, cfg, eval=True, device=device)
    ratios = np.asarray(ds.cls_ratios, np.float64)
    if ignore_index is not None:
        ratios = ratios.copy()
        ratios[ignore_index] = 0
        total = ratios.sum()
        ratios = ratios / total if total > 0 else ratios
    return ratios


class SSRClsDataset:
    """gt.npy-backed region classification dataset
    (reference dataset_ssr.py:72-107)."""

    def __init__(self, impth: str, cfg: Config, eval: bool = False,
                 duplicate: int = 10, seed: int = 0):
        self.cfg = cfg
        self.eval = eval
        self._rng = np.random.RandomState(seed)
        store = md.load_store(impth)
        if not store:
            raise FileNotFoundError(f"no gt.npy under {impth}")
        self.datalist: List[dict] = []
        for key in store:
            for tile_id in store[key]:
                rec = store[key][tile_id]
                self.datalist.append({"image": fix_path(rec["image"]),
                                      "label": int(rec["label"])})
        if not eval and duplicate > 1:
            self.datalist = [d for d in self.datalist
                             for _ in range(duplicate)]

    def __len__(self) -> int:
        return len(self.datalist)

    def batches(self, batch_size: Optional[int] = None,
                shuffle: Optional[bool] = None, rows: Rows = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Batches of ``batch_size`` items; with ``rows``, only the rows
        it keeps of each (``data.patches.Rows``)."""
        bs = batch_size or self.cfg.batch_size
        shuffle = (not self.eval) if shuffle is None else shuffle
        order = np.arange(len(self.datalist))
        if shuffle:
            self._rng.shuffle(order)
        h, w = self.cfg.tile_h, self.cfg.tile_w
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            ks = np.asarray(draw_rotations(self._rng, len(idx), self.eval))
            keep = kept_rows(rows, len(idx))
            idx, ks = idx[keep], ks[keep]
            n = len(idx)
            batch = {
                "image": np.zeros((n, h, w, 3), np.uint8),
                "cls_label": np.zeros((n,), np.int32),
            }
            for bi, (ri, k) in enumerate(zip(idx, ks)):
                item = self.datalist[ri]
                img = Image.open(item["image"]).convert("RGB")
                if k:
                    img = img.rotate(90 * k, expand=True)
                img = img.resize((w, h))
                batch["image"][bi] = np.asarray(img, np.uint8)
                batch["cls_label"][bi] = item["label"]
            yield batch
