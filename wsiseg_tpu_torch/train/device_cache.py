"""Device-resident epoch cache — counterpart of
``wsiseg_tpu/train/device_cache.py``.

Epochs revisit the same patches, so the u8 training set is copied to the
card once and each step gathers its rows there: after the one-time
build, a steady-state epoch moves only a (B,) index array per step from
the host, and no PNG is decoded. Images and seg labels stay u8 on the
device (1 byte per pixel) and are widened, jittered and normalized after
the gather, as the host-fed path does it
(:func:`~wsiseg_tpu_torch.data.patches.normalize_batch_images`).

:meth:`DeviceEpochCache.index_batches` shuffles with the same numpy
permutation as JAX's, and the cached step given a host batch's rows
equals the host-fed step on that batch.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.data.patches import normalize_batch_images

# fields gathered per step
_LABEL_KEYS = ("seg_label", "cls_label", "reg_label", "is_cls", "is_reg",
               "is_seg")


class DeviceEpochCache:
    """The uploaded dataset: a dict of device tensors with a shared leading
    N axis. Build once with :meth:`build`, then drive epochs with
    :meth:`index_batches` and :func:`make_cached_hybrid_train_step`."""

    def __init__(self, arrays: Dict[str, torch.Tensor], n: int):
        self.arrays = arrays
        self.n = n

    @classmethod
    def build(cls, batches: Iterable[Dict[str, np.ndarray]], cfg: Config,
              device, max_bytes: Optional[int] = None,
              log=lambda s: None) -> "DeviceEpochCache":
        """Concatenate host batches (u8 images, as
        ``PatchDataset.batches`` makes them) and copy each field to
        ``device`` once; seg labels narrowed to u8. ``max_bytes`` caps the
        image bytes: batches past it are left out (the cache then holds
        ``.n`` rows), so a set larger than the card's memory degrades to a
        partial cache instead of an allocation failure."""
        fields: Dict[str, list] = {}
        img_bytes = 0
        for b in batches:
            img = np.asarray(b["image"])
            if img.dtype != np.uint8:
                raise ValueError(
                    "DeviceEpochCache wants uint8 host images (normalize "
                    f"runs on the device, after the gather); got {img.dtype}")
            if max_bytes is not None and img_bytes + img.nbytes > max_bytes:
                cached = sum(x.shape[0] for x in fields.get("image", []))
                log(f"device cache capped at {max_bytes / 1e9:.2f} GB — "
                    f"caching {cached} rows")
                break
            img_bytes += img.nbytes
            fields.setdefault("image", []).append(img)
            for k in _LABEL_KEYS:
                if k in b:
                    fields.setdefault(k, []).append(np.asarray(b[k]))
        if "image" not in fields:
            raise ValueError("no batches to cache")
        host = {k: np.concatenate(v, axis=0) for k, v in fields.items()}
        if "seg_label" in host:
            if host["seg_label"].max(initial=0) >= 256:
                raise ValueError("seg labels must fit in uint8")
            host["seg_label"] = host["seg_label"].astype(np.uint8)
        arrays = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        n = host["image"].shape[0]
        total = sum(v.numel() * v.element_size() for v in arrays.values())
        log(f"device epoch cache: {n} rows, {total / 1e9:.2f} GB copied "
            "once")
        return cls(arrays, n)

    def index_batches(self, batch_size: int, seed: int = 0, epoch: int = 0,
                      drop_remainder: bool = True) -> Iterator[np.ndarray]:
        """Per-epoch shuffled (B,) int64 index batches, JAX's permutation
        (``device_cache.py:105-116``)."""
        perm = np.random.RandomState((seed * 100003 + epoch) & 0x7FFFFFFF
                                     ).permutation(self.n).astype(np.int64)
        end = self.n - (self.n % batch_size) if drop_remainder else self.n
        for i in range(0, max(end, 0), batch_size):
            idx = perm[i:i + batch_size]
            if len(idx) == batch_size or not drop_remainder:
                yield idx


def gather_batch(arrays: Dict[str, torch.Tensor], idx: torch.Tensor,
                 cfg: Config, generator: Optional[torch.Generator] = None,
                 train: bool = True) -> Dict[str, torch.Tensor]:
    """The batch rows ``idx`` in the host-fed batch's form: normalized
    float images (jittered with ``generator`` when ``train``), int64
    label maps."""
    b = {k: v.index_select(0, idx) for k, v in arrays.items()}
    b["image"] = normalize_batch_images(b["image"], cfg, generator,
                                        train=train)
    for k in ("seg_label", "cls_label"):
        if k in b:
            b[k] = b[k].long()
    return b


def make_cached_hybrid_train_step(model, cfg: Config, **step_kwargs):
    """Cached twin of ``steps.make_hybrid_train_step``: the returned
    ``step(state, arrays, idx, generator)`` gathers and preprocesses on
    the device (the jitter from ``generator``) and runs the same hybrid
    loss and update."""
    from wsiseg_tpu_torch.train.steps import make_hybrid_train_step

    base = make_hybrid_train_step(model, cfg, **step_kwargs)

    def step(state, arrays, idx, generator=None):
        return base(state, gather_batch(arrays, idx, cfg, generator,
                                        train=True))

    return step
