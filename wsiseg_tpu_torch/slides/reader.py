"""Slide I/O: a uniform pyramidal-slide interface.

The reference calls ``openslide.OpenSlide`` at 12+ sites (e.g.
utils/dataset.py:96,121, utils/eval.py:63) with the contract:

* ``level_dimensions[k] -> (width, height)``
* ``level_downsamples[k] -> float``
* ``level_count``
* ``read_region((x0, y0), level, (w, h))`` where ``(x0, y0)`` are **level-0**
  coordinates; returns an RGBA PIL image, always ``.convert('RGB')``-ed.

Implementations here return ``(h, w, 3) uint8`` numpy arrays directly.
Out-of-bounds reads are padded with white (255) — slide background.

Backends:

* :class:`ArraySlide` — wraps an in-memory level-0 array, builds a 4×-spaced
  pyramid (the reference hard-assumes 4× Aperio spacing, e.g.
  utils/regiontools.py:26). This is the hermetic fake backend for tests.
* :class:`SyntheticSlide` — procedurally generated tissue-like content.
* ``NativeSlide`` (wsiseg_tpu_torch.slides.native) — first-party C++ TIFF/SVS
  reader; registered lazily to keep this module import-light.
"""

from __future__ import annotations

import os
from typing import Protocol, Sequence, Tuple, runtime_checkable

import numpy as np


@runtime_checkable
class SlideReader(Protocol):
    @property
    def level_count(self) -> int: ...

    @property
    def level_dimensions(self) -> Sequence[Tuple[int, int]]: ...

    @property
    def level_downsamples(self) -> Sequence[float]: ...

    def read_region(self, location: Tuple[int, int], level: int,
                    size: Tuple[int, int]) -> np.ndarray: ...

    def read_level(self, level: int) -> np.ndarray: ...


def _box_downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """Downsample (H, W, C) uint8 by integer factor with box averaging."""
    h, w = img.shape[:2]
    ch, cw = (h // factor) * factor, (w // factor) * factor
    img = img[:ch, :cw].astype(np.float32)
    img = img.reshape(ch // factor, factor, cw // factor, factor, -1)
    img = img.mean(axis=(1, 3))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


class ArraySlide:
    """Pyramidal slide over an in-memory level-0 RGB array.

    ``level_spacing`` defaults to 4 to match Aperio SVS pyramids, the
    assumption baked into the reference (preprocess/makedata_ssr.py:93).
    """

    def __init__(self, level0: np.ndarray, num_levels: int = 3,
                 level_spacing: int = 4):
        if level0.ndim != 3 or level0.shape[2] != 3:
            raise ValueError("level0 must be (H, W, 3)")
        if level0.dtype != np.uint8:
            raise ValueError("level0 must be uint8")
        self._levels = [level0]
        for _ in range(1, num_levels):
            self._levels.append(_box_downsample(self._levels[-1], level_spacing))
        self._spacing = level_spacing

    @property
    def level_count(self) -> int:
        return len(self._levels)

    @property
    def level_dimensions(self) -> Tuple[Tuple[int, int], ...]:
        return tuple((lv.shape[1], lv.shape[0]) for lv in self._levels)

    @property
    def level_downsamples(self) -> Tuple[float, ...]:
        return tuple(float(self._spacing ** k) for k in range(len(self._levels)))

    def read_level(self, level: int) -> np.ndarray:
        return self._levels[level]

    def read_region(self, location: Tuple[int, int], level: int,
                    size: Tuple[int, int]) -> np.ndarray:
        x0_l0, y0_l0 = int(location[0]), int(location[1])
        w, h = int(size[0]), int(size[1])
        ds = self.level_downsamples[level]
        x0 = int(x0_l0 / ds)
        y0 = int(y0_l0 / ds)
        lv = self._levels[level]
        out = np.full((h, w, 3), 255, dtype=np.uint8)
        sy0, sy1 = max(0, y0), min(lv.shape[0], y0 + h)
        sx0, sx1 = max(0, x0), min(lv.shape[1], x0 + w)
        if sy1 > sy0 and sx1 > sx0:
            out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = lv[sy0:sy1, sx0:sx1]
        return out

    def close(self) -> None:  # interface parity with file-backed readers
        pass


class SyntheticSlide(ArraySlide):
    """Procedural tissue-like slide for tests and benchmarks.

    White background with purplish ("nuclei", HSV-saturated) blobs so the
    tissue-mask op (`find_nuclei`) finds plausible foreground, plus an
    optional class-region layout returned as a ground-truth raster.
    """

    def __init__(self, width: int = 2048, height: int = 1536,
                 num_levels: int = 3, num_blobs: int = 12, seed: int = 0,
                 num_classes: int = 4):
        rng = np.random.RandomState(seed)
        h0, w0 = height, width
        img = np.full((h0, w0, 3), 244, dtype=np.uint8)
        gt0 = np.zeros((h0, w0), dtype=np.uint8)

        yy, xx = np.mgrid[0:h0, 0:w0]
        for _ in range(num_blobs):
            cy = rng.randint(h0 // 8, 7 * h0 // 8)
            cx = rng.randint(w0 // 8, 7 * w0 // 8)
            ry = rng.randint(h0 // 16, h0 // 5)
            rx = rng.randint(w0 // 16, w0 // 5)
            cls = rng.randint(1, num_classes)
            blob = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0
            # purple-ish tissue: high saturation so HSV threshold fires
            color = np.array([
                120 + rng.randint(-30, 30),
                40 + rng.randint(-20, 40),
                150 + rng.randint(-30, 40),
            ], dtype=np.int32)
            img[blob] = np.clip(color, 0, 255).astype(np.uint8)
            gt0[blob] = cls

        # speckle noise over tissue for texture
        noise = rng.randint(-18, 18, size=img.shape).astype(np.int16)
        tissue = gt0 > 0
        img[tissue] = np.clip(img[tissue].astype(np.int16) + noise[tissue], 0, 255).astype(np.uint8)

        super().__init__(img, num_levels=num_levels)
        self._gt_levels = [gt0]
        for _ in range(1, num_levels):
            g = self._gt_levels[-1]
            self._gt_levels.append(g[::4, ::4])

    def ground_truth(self, level: int) -> np.ndarray:
        """Class-coded GT raster at a pyramid level, aligned with the image."""
        g = self._gt_levels[level]
        wh = self.level_dimensions[level]
        return g[: wh[1], : wh[0]]


class VirtualPyramidSlide:
    """A pyramid where only some levels are materialized.

    Declares full Aperio-style geometry (``level_spacing``× per level) but
    stores arrays only for the levels provided — e.g. benchmark slides that
    are processed entirely at level 2 and would need a multi-GB level 0.
    Reads from absent levels raise.
    """

    def __init__(self, levels: dict, num_levels: int = 3,
                 level_spacing: int = 4):
        if not levels:
            raise ValueError("need at least one materialized level")
        self._levels = dict(levels)
        self._spacing = level_spacing
        k0 = min(self._levels)
        h0, w0 = self._levels[k0].shape[:2]
        self._dims = []
        for k in range(num_levels):
            f = level_spacing ** (k0 - k)
            self._dims.append((int(w0 * f), int(h0 * f)))

    @property
    def level_count(self) -> int:
        return len(self._dims)

    @property
    def level_dimensions(self):
        return tuple(self._dims)

    @property
    def level_downsamples(self):
        return tuple(float(self._spacing ** k) for k in range(len(self._dims)))

    def read_level(self, level: int) -> np.ndarray:
        if level not in self._levels:
            raise KeyError(f"level {level} not materialized")
        return self._levels[level]

    def read_region(self, location, level, size):
        lv = self.read_level(level)
        ds = self.level_downsamples[level]
        x0, y0 = int(location[0] / ds), int(location[1] / ds)
        w, h = int(size[0]), int(size[1])
        out = np.full((h, w, 3), 255, dtype=np.uint8)
        sy0, sy1 = max(0, y0), min(lv.shape[0], y0 + h)
        sx0, sx1 = max(0, x0), min(lv.shape[1], x0 + w)
        if sy1 > sy0 and sx1 > sx0:
            out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = lv[sy0:sy1, sx0:sx1]
        return out

    def close(self) -> None:
        pass


# every extension open_slide can route to a reader (vendor dialects
# included); .npy array slides are opt-in per call site
SLIDE_EXTS = ("svs", "tif", "tiff", "ndpi", "wsiraw")


def glob_slides(directory: str, include_npy: bool = True,
                case_dirs: bool = False) -> list:
    """Sorted slide paths under ``directory`` for every extension
    :func:`open_slide` routes (plus ``.npy`` unless disabled;
    ``case_dirs`` also scans ``Case*/`` subdirectories — the reference's
    eval layout). Single source of truth for directory discovery — the
    preprocess generators, eval collections and converters all use it,
    so a new vendor format lands everywhere at once."""
    import glob as _glob
    exts = SLIDE_EXTS + (("npy",) if include_npy else ())
    pats = []
    for ext in exts:
        if case_dirs:
            pats.append(os.path.join(directory, "Case*", f"*.{ext}"))
        pats.append(os.path.join(directory, f"*.{ext}"))
    return sorted(p for pat in pats for p in _glob.glob(pat))


def open_slide(path: str) -> SlideReader:
    """Open a slide file by extension and vendor sniff.

    ``.svs``/``.tif``/``.tiff`` route to the first-party native reader
    (wsiseg_tpu_torch.slides.native) — except vendor dialects libtiff cannot
    decode, which route to the pure-Python readers (convert once with
    cli/convert_slide for the fast path): Aperio JPEG2000 (compression
    33003/33005 → wsiseg_tpu_torch.slides.j2k), Hamamatsu NDPI (marker tag
    65420 or ``.ndpi`` → vendor.NDPISlide), Philips TIFF (Software tag →
    vendor.PhilipsTiffSlide, sparse-tile + JPEGTables aware). ``.mrxs``
    (MIRAX, multi-file) is rejected with conversion guidance. ``.npy``
    loads an array slide; anything else is decoded with PIL as a
    single-level slide. Capability twin of the reference's OpenSlide
    open (reference utils/dataset.py:121).
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".mrxs":
        raise ValueError(
            f"{path!r}: MIRAX is a multi-file format this stack does not "
            "read natively — export/convert the slide to SVS, tiled TIFF "
            "or .wsiraw first (cli/convert_slide handles any supported "
            "input)")
    if ext in (".svs", ".tif", ".tiff", ".ndpi"):
        from wsiseg_tpu_torch.slides.vendor import (NDPISlide, PhilipsTiffSlide,
                                              classify_tiff)
        kind = classify_tiff(path)   # one inline IFD walk for all routes
        if kind == "ndpi" or ext == ".ndpi":
            return NDPISlide(path)
        if kind == "philips":
            return PhilipsTiffSlide(path)
        if kind == "j2k":
            from wsiseg_tpu_torch.slides.j2k import J2KTiledSlide
            return J2KTiledSlide(path)
    if ext in (".svs", ".tif", ".tiff", ".wsiraw"):
        from wsiseg_tpu_torch.slides.native import NativeSlide
        return NativeSlide(path)
    if ext == ".npy":
        return ArraySlide(np.load(path))
    from PIL import Image
    img = np.asarray(Image.open(path).convert("RGB"))
    return ArraySlide(img, num_levels=1)
