"""Annotation readers: Aperio/ICIAR XML and Sedeen session XML → class
rasters — counterpart (a copy) of ``wsiseg_tpu/data/annotations.py``, on
the host as there; the tumor-bed hull is the port's
:func:`wsiseg_tpu_torch.ops.hull.convex_hull_image`.

Capability twins of reference utils/read_xml.py (BACH/ICIAR2018 polygons,
labels benign=1 / in situ=2 / invasive=3, :49-54) and
utils/read_xml_sunnybrook.py (Sedeen ``*.session.xml`` polylines, free-text
label mapping :47-70, morphological close + fill holes :153-161).

Deliberate divergence: the reference rasterizes at FULL level-0 resolution
then subsamples (utils/read_xml.py:73-78 allocates a dims-sized RGB canvas —
tens of GB for a real slide). Here polygon coordinates are scaled first and
rasterized directly at the target level. Same raster up to 1px rounding,
O(level-size) memory.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Sequence, Tuple

import numpy as np
import scipy.ndimage as ndi
from PIL import Image, ImageDraw


# ---- Aperio / ICIAR2018 (BACH) ----

def find_extension(directory: str, extension: str = ".xml") -> List[str]:
    """Sorted files with extension (reference utils/read_xml.py:15-21)."""
    return sorted(f for f in os.listdir(directory) if f.endswith(extension))


def read_aperio_xml(filename: str):
    """Parse an Aperio ImageScope annotation XML.

    Returns (coords, labels, lengths, areas, microns_per_pixel) where coords
    is a list of (N, 2) [x, y] arrays in level-0 pixels and labels are class
    codes 1/2/3 (benign / in situ / invasive) or the raw text when unmapped
    (reference utils/read_xml.py:29-66).
    """
    tree = ET.parse(filename)
    root = tree.getroot()
    regions = root[0][1].findall("Region")
    pixel_spacing = float(root.get("MicronsPerPixel"))

    labels, coords, lengths, areas = [], [], [], []
    for r in regions:
        # Area/Length attributes are informational; tolerate their absence
        # (some exporters omit them)
        areas.append(float(r.get("AreaMicrons") or 0.0))
        lengths.append(float(r.get("LengthMicrons") or 0.0))
        label = None
        try:
            label = r[0][0].get("Value")
        except (IndexError, AttributeError):
            label = r.get("Text")
        if label is None:
            label = ""
        low = label.lower()
        if "benign" in low:
            label = 1
        elif "in situ" in low:
            label = 2
        elif "invasive" in low:
            label = 3
        labels.append(label)
        vertices = r[1]
        coord = [[int(v.get("X")), int(v.get("Y"))] for v in vertices]
        coords.append(np.asarray(coord, dtype=np.int64))
    return coords, labels, lengths, areas, pixel_spacing


def _rasterize_rgb(coords, labels, level_wh: Tuple[int, int], scale: float,
                   outline_only: bool = False, thickness: int = 1) -> np.ndarray:
    """Paint class polygons into an RGB canvas at the target level: class c
    lights channel c-1 (reference color convention, utils/read_xml.py:71)."""
    w, h = level_wh
    channels = [Image.new("L", (w, h), 0) for _ in range(3)]
    draws = [ImageDraw.Draw(c) for c in channels]
    for c, l in zip(coords, labels):
        if not isinstance(l, (int, np.integer)) or not (1 <= int(l) <= 3):
            continue
        pts = [(float(x) * scale, float(y) * scale) for x, y in np.asarray(c)]
        if len(pts) < 2:
            continue
        d = draws[int(l) - 1]
        if outline_only:
            d.line(pts + [pts[0]], fill=255, width=max(1, thickness))
        else:
            d.polygon(pts, fill=255, outline=255)
    return np.stack([np.asarray(ch) for ch in channels], axis=-1)


def _rgb_to_classes(rgb: np.ndarray) -> np.ndarray:
    """argmax with background channel prepended (utils/read_xml.py:90-91) —
    reproduces the reference's tie behavior (lower class wins)."""
    bg = np.zeros(rgb.shape[:2] + (1,), rgb.dtype)
    return np.argmax(np.concatenate([bg, rgb], axis=-1), axis=-1).astype(np.uint8)


def get_gt_aperio(xmlpath: str, slide, level: int) -> np.ndarray:
    """Class-coded GT raster at a pyramid level (utils/read_xml.py:81-93)."""
    coords, labels, *_ = read_aperio_xml(xmlpath)
    w, h = slide.level_dimensions[level]
    scale = 1.0 / slide.level_downsamples[level]
    rgb = _rasterize_rgb(coords, labels, (w, h), scale)
    return _rgb_to_classes(rgb)


def get_tb_aperio(gt: np.ndarray, slide, level: int) -> np.ndarray:
    """Tumor bed = convex hull of malignant (class >= 2) GT
    (utils/read_xml.py:96-106). Returns a (h, w) uint8 {0,255} raster at
    ``level`` dims. NOTE: mutates ``gt`` like the reference (benign zeroed)."""
    from wsiseg_tpu_torch.ops.hull import convex_hull_image
    gt[gt == 1] = 0
    tb = convex_hull_image((gt > 0).astype(np.uint8))
    img = Image.fromarray((tb * 255).astype(np.uint8)).resize(
        slide.level_dimensions[level])
    return np.asarray(img)


# ---- Sedeen (Sunnybrook) ----

def find_annotated_files(root_dir: str) -> List[str]:
    """All ``*padded.session.xml`` under a tree
    (utils/read_xml_sunnybrook.py:14-21)."""
    out = []
    for path, _, files in os.walk(root_dir):
        for f in files:
            if f.endswith("padded.session.xml"):
                out.append(os.path.join(path, f))
    return out


def sedeen_class(label: str) -> int:
    """Free-text → class code (utils/read_xml_sunnybrook.py:47-70)."""
    label = label.lower().replace(" ", "")
    if "cellularity" in label:
        out = 0
    elif label == "i" or "invasive" in label or "idc" in label or "ilc" in label:
        out = 3
    elif "dcis" in label:
        out = 2
    elif "benign" in label or "udh" in label:
        out = 1
    elif "normal" in label or "tb" in label:
        out = 0
    else:
        out = 0
    if "nodcis" in label and out == 2:
        out = 0
    return out


def read_sedeen_xml(filename: str, tb_only: bool = False):
    """Parse a Sedeen session XML → (coords, labels) of usable polylines
    (utils/read_xml_sunnybrook.py:112-141, readXML_TB :197-223)."""
    tree = ET.parse(filename)
    root = tree.getroot()
    graphics = root[0][3].findall("graphic")
    labels, coords = [], []
    for g in graphics:
        description = g.get("description") or ""
        if tb_only:
            if "tb" not in description.lower().replace(" ", ""):
                continue
        else:
            if (not sedeen_class(description)
                    or g.get("type") in ("point", "ellipse", "text")):
                continue
        pts = []
        for vertex in g[2].findall("point"):
            pts.append(tuple(int(float(i)) for i in vertex.text.split(",")))
        labels.append(description)
        coords.append(np.asarray(pts, dtype=np.int64))
    return coords, labels


def _clip_and_filter_small(coords, shape_wh, min_extent: int = 100):
    """Clip out-of-bounds vertices and reject small cellularity rectangles
    (utils/read_xml_sunnybrook.py:25-43, threshold 100 at level 0)."""
    out = []
    keep = []
    for c in coords:
        c = np.asarray(c).copy()
        c[:, 0] = np.minimum(c[:, 0], shape_wh[0] - 1)
        c[:, 1] = np.minimum(c[:, 1], shape_wh[1] - 1)
        ext_x = c[:, 0].max() - c[:, 0].min()
        ext_y = c[:, 1].max() - c[:, 1].min()
        out.append(c)
        keep.append(ext_x > min_extent and ext_y > min_extent)
    return out, keep


def get_gt_sedeen(xmlpath: str, slide, level: int) -> np.ndarray:
    """Sedeen polylines → class raster: thick outlines, per-channel 10×10
    close + fill-holes, then channel argmax
    (utils/read_xml_sunnybrook.py:145-169)."""
    coords, labels = read_sedeen_xml(xmlpath)
    w0, h0 = slide.level_dimensions[0]
    coords, keep = _clip_and_filter_small(coords, (w0, h0))
    w, h = slide.level_dimensions[level]
    scale = 1.0 / slide.level_downsamples[level]
    cls_labels = [sedeen_class(l) if k else 0
                  for l, k in zip(labels, keep)]
    # thickness 8 at level 0 → scaled
    rgb = _rasterize_rgb(coords, cls_labels, (w, h), scale,
                         outline_only=True,
                         thickness=max(1, int(round(8 * scale))))
    filled = np.zeros_like(rgb)
    for i in range(3):
        ch = rgb[..., i] > 0
        ch = ndi.binary_closing(ch, structure=np.ones((10, 10)))
        ch = ndi.binary_fill_holes(ch)
        filled[..., i] = ch.astype(np.uint8) * 255
    return _rgb_to_classes(filled)


def get_tb_sedeen(xmlpath: str, slide, level: int) -> np.ndarray:
    """Tumor-bed raster from 'tb' polylines
    (utils/read_xml_sunnybrook.py:173-194). Returns (h, w) uint8 {0,255}."""
    coords, labels = read_sedeen_xml(xmlpath, tb_only=True)
    w, h = slide.level_dimensions[level]
    scale = 1.0 / slide.level_downsamples[level]
    ones = [1] * len(labels)
    rgb = _rasterize_rgb(coords, ones, (w, h), scale, outline_only=True,
                         thickness=max(1, int(round(8 * scale))))
    ch = rgb[..., 0] > 0
    ch = ndi.binary_closing(ch, structure=np.ones((10, 10)))
    ch = ndi.binary_fill_holes(ch)
    return (ch.astype(np.uint8)) * 255
