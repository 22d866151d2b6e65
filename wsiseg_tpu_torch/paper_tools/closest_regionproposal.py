"""Region-proposal perimeter experiment — counterpart of
``wsiseg_tpu/paper_tools/closest_regionproposal.py`` (reference
``closest_regionproposal.py``).

For each GT connected component: k-means keypoints, a concave-hull
perimeter resampled to uniform arclength, and nearest-region pairing via a
KD-tree — the exploratory analysis behind the HR keypoint design
(closest_regionproposal.py:34-152). The reference depended on an external,
non-vendored ``concave_hull`` module (its import would fail; SURVEY.md
§2.b); here the k-NN concave hull is first-party (ops/hull).

The keypoints' k-means runs on ``device`` (host k-means++ seeds from
``np.random.RandomState``: centers differ from JAX's by design,
ROADMAP.md §3); components, hulls and the KD-tree stay on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from wsiseg_tpu_torch.cli.common import add_device_flag
from wsiseg_tpu_torch.data.regions import HR_NUM_CNT_SAMPLES, get_key_points
from wsiseg_tpu_torch.infer.engine import resolve_device
from wsiseg_tpu_torch.ops.cc import connected_components
from wsiseg_tpu_torch.ops.contour import evenly_spaced_points_on_a_contour
from wsiseg_tpu_torch.ops.hull import concave_hull_points
from wsiseg_tpu_torch.proposals import perimeter_keypoints


def region_perimeter_points(region_mask: np.ndarray, num_points: int = 32,
                            k: int = 3, us: int = 1) -> np.ndarray:
    """Concave-hull perimeter resampled to ``num_points`` uniform-arclength
    points (closest_regionproposal.py:34 + contour_ordering.esp)."""
    mask = region_mask[::us, ::us] if us > 1 else region_mask
    coords = perimeter_keypoints(mask, num_points=10 ** 9)
    if coords.shape[0] < 4:
        return coords.astype(float) * us
    hull = concave_hull_points(coords.astype(float), k=k)
    if hull is None or len(hull) < 2:
        hull = coords
    return evenly_spaced_points_on_a_contour(hull, num_points) * us


def analyze_regions(gt_mask: np.ndarray, num_perim_points: int = 32,
                    us_kmeans: int = 4, device="cuda") -> Dict[int, dict]:
    """Per-CC keypoints + resampled concave perimeter."""
    device = resolve_device(device)
    labels, _ = connected_components((gt_mask > 0).astype(np.uint8))
    out: Dict[int, dict] = {}
    for rid in range(1, int(labels.max()) + 1):
        region = labels == rid
        n, centers, _, _ = get_key_points(region, us_kmeans,
                                          HR_NUM_CNT_SAMPLES,
                                          HR_NUM_CNT_SAMPLES, device=device)
        if n is None:
            continue
        out[rid] = {
            "cnt_xy": centers,
            "perim_xy": region_perimeter_points(region, num_perim_points),
            "area": int(region.sum()),
        }
    return out


def nearest_region_pairs(regions: Dict[int, dict]) -> List[Tuple[int, int, float]]:
    """For each region, its nearest neighbor by centroid distance
    (the KD-tree query of closest_regionproposal.py:15-25). Returns
    (region_id, nearest_id, distance) triples."""
    ids = sorted(regions)
    if len(ids) < 2:
        return []
    cents = np.array([regions[i]["cnt_xy"].mean(axis=0) for i in ids], float)
    try:
        from scipy.spatial import cKDTree
        tree = cKDTree(cents)
        d, j = tree.query(cents, k=2)
        return [(ids[i], ids[int(j[i, 1])], float(d[i, 1]))
                for i in range(len(ids))]
    except ImportError:
        out = []
        for i in range(len(ids)):
            d = np.hypot(*(cents - cents[i]).T)
            d[i] = np.inf
            j = int(np.argmin(d))
            out.append((ids[i], ids[j], float(d[j])))
        return out


def main(argv: Optional[Sequence[str]] = None) -> list:
    import argparse

    from PIL import Image

    p = argparse.ArgumentParser(description="region-proposal perimeter analysis")
    p.add_argument("gt_mask_png", help="class-coded GT raster (mk_gt output)")
    p.add_argument("--num_perim_points", type=int, default=32)
    add_device_flag(p, "k-means runs")
    ns = p.parse_args(argv)
    resolve_device(ns.device)
    gt = np.asarray(Image.open(ns.gt_mask_png))
    regions = analyze_regions(gt, ns.num_perim_points, device=ns.device)
    pairs = nearest_region_pairs(regions)
    for rid, nearest, dist in pairs:
        print(f"region {rid}: area {regions[rid]['area']}, "
              f"nearest region {nearest} at {dist:.1f}px")
    return pairs


if __name__ == "__main__":
    main()
