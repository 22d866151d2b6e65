"""The ``gt.npy`` metadata store.

Interchange format kept bit-compatible with the reference so datasets
generated by either codebase are mutually readable:

* Patch stores (reference preprocess/patch_to_gt.py:94-104, read at
  utils/dataset.py:22-28)::

      {filename: {tile_id: {'wsi': image_path, 'label': path|int|float, ...}}}

  The *type* of ``label`` encodes the task (utils/dataset.py:62-66):
  ``str`` → segmentation-mask path, ``int`` → class code, ``float`` →
  regression target.

* HR (multi-patch region) stores (reference
  preprocess/region_proposal_points.py:113-169, utils/dataset_hr.py:28-42)::

      {filename: {conncomp_id: {region_id:
          {'cnt_xy': (N,2) int, 'perim_xy': (M,2) int,
           'label': int, 'wsipath': str, 'scan_level': int}}}}

  plus an optional ``'P'`` key holding plain patches with only
  ``{'wsipath','label','dimensions'}`` (utils/dataset_hr.py:49-72).
"""

from __future__ import annotations

import enum
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Union

import numpy as np

from wsiseg_tpu_torch.utils.filesystem import fetch_metadata, make_folder

Label = Union[str, int, float]


class Task(enum.Enum):
    CLS = "cls"
    REG = "reg"
    SEG = "seg"


def task_of(label: Label) -> Task:
    """Task dispatch by label type (reference utils/dataset.py:62-66).

    Note: ``bool`` deliberately counts as int, matching Python isinstance
    semantics the reference relies on.
    """
    if isinstance(label, str):
        return Task.SEG
    if isinstance(label, (bool, int, np.integer)):
        return Task.CLS
    if isinstance(label, (float, np.floating)):
        return Task.REG
    raise TypeError(f"unsupported label type: {type(label)}")


@dataclass(frozen=True)
class PatchRecord:
    """One flat training sample from a patch store."""
    image_path: str
    label: Label

    @property
    def task(self) -> Task:
        return task_of(self.label)


def store_path(directory: str) -> str:
    return os.path.join(directory, "gt.npy")


def load_store(directory_or_file: str) -> dict:
    """Load a gt.npy store given its directory or full path."""
    pth = directory_or_file
    if not pth.endswith(".npy"):
        pth = store_path(pth)
    return fetch_metadata(pth)


def save_store(metadata: dict, directory_or_file: str) -> str:
    pth = directory_or_file
    if not pth.endswith(".npy"):
        make_folder(pth)
        pth = store_path(pth)
    else:
        make_folder(os.path.dirname(pth) or ".")
    np.save(pth, metadata)
    return pth


def flatten_patches(metadata: dict) -> List[PatchRecord]:
    """Flatten a patch store into records (reference utils/dataset.py:22-28)."""
    out: List[PatchRecord] = []
    for key in metadata:
        for tile_id in metadata[key]:
            item = metadata[key][tile_id]
            out.append(PatchRecord(image_path=item["wsi"], label=item["label"]))
    return out


def add_patch(metadata: dict, filename: str, tile_id, image_path: str,
              label: Label, **extra) -> None:
    """Insert one patch record, mirroring how the reference generators build
    stores (preprocess/patch_to_gt.py:94-104)."""
    entry = {"wsi": image_path, "label": label}
    entry.update(extra)
    metadata.setdefault(filename, {})[tile_id] = entry


def iter_hr_regions(metadata: dict) -> Iterator[dict]:
    """Yield region dicts from an HR store, skipping the 'P' patch bucket
    (reference utils/dataset_hr.py:77-119)."""
    for filename in metadata:
        if filename == "P":
            continue
        for conncomp in metadata[filename]:
            for region_id in metadata[filename][conncomp]:
                yield metadata[filename][conncomp][region_id]


def class_counts(metadata: dict, num_classes: int) -> np.ndarray:
    """Count classification samples per class in a flat patch store."""
    counts = np.zeros((num_classes,), dtype=np.int64)
    for rec in flatten_patches(metadata):
        if rec.task is Task.CLS:
            counts[int(rec.label)] += 1
    return counts
