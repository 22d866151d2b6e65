"""Convex/concave hulls and polygon rasterization — counterpart (a copy)
of ``wsiseg_tpu/ops/hull.py``: skimage ``convex_hull_image``, cv2 polygon
fill and the ``concave_hull`` module the reference imports but does not
vendor.

Hull vertex math runs on the host; rasterization uses PIL's C scanline
fill (PIL is imported at first use). :func:`convex_hull_image` builds the
hull from each row's outermost foreground pixels instead of every
foreground pixel: the same vertices (see its docstring).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def convex_hull_points(points: np.ndarray) -> np.ndarray:
    """Andrew monotone chain. points: (N, 2) as (x, y). Returns hull vertices
    (M, 2) counter-clockwise, M >= 1."""
    pts = np.unique(np.asarray(points, dtype=np.int64), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: list = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(tuple(p))
    upper: list = []
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(tuple(p))
    return np.asarray(lower[:-1] + upper[:-1], dtype=np.int64)


def fill_polygon(vertices: np.ndarray, shape_hw: Tuple[int, int],
                 value: int = 1) -> np.ndarray:
    """Rasterize a filled polygon. vertices: (M, 2) as (x, y)."""
    from PIL import Image, ImageDraw
    img = Image.new("L", (shape_hw[1], shape_hw[0]), 0)
    v = [tuple(map(int, p)) for p in np.asarray(vertices)]
    if len(v) == 1:
        ImageDraw.Draw(img).point(v, fill=value)
    elif len(v) == 2:
        ImageDraw.Draw(img).line(v, fill=value)
    else:
        ImageDraw.Draw(img).polygon(v, outline=value, fill=value)
    return np.asarray(img, dtype=np.uint8)


def convex_hull_image(mask: np.ndarray) -> np.ndarray:
    """Filled convex hull of a binary mask (skimage convex_hull_image twin).

    Every foreground pixel lies on the segment between its row's leftmost
    and rightmost foreground pixels, so those two per row span the same
    hull, and the monotone chain (collinear points dropped, start at the
    lexicographic minimum) returns the same vertices in the same order as
    from every pixel. The JAX function passes every pixel through the
    Python loop: millions on a tumor bed at level 2, against at most two
    per row here."""
    mask = np.asarray(mask) != 0
    rows = np.flatnonzero(mask.any(axis=1))
    if len(rows) == 0:
        return np.zeros(mask.shape, dtype=np.uint8)
    sub = mask[rows]
    first = np.argmax(sub, axis=1)
    last = mask.shape[1] - 1 - np.argmax(sub[:, ::-1], axis=1)
    pts = np.concatenate([np.stack([first, rows], axis=1),
                          np.stack([last, rows], axis=1)])
    return fill_polygon(convex_hull_points(pts), mask.shape)


def concave_hull_points(points: np.ndarray, k: int = 8) -> np.ndarray:
    """k-nearest-neighbor concave hull (Moreira & Santos 2007 style).

    Walks the boundary choosing, among the k nearest unvisited points, the
    one with the largest right-hand turn that does not self-intersect.
    Falls back to the convex hull when the walk fails to close.
    points: (N, 2) as (x, y); returns ordered hull vertices (M, 2).
    """
    pts = np.unique(np.asarray(points, dtype=np.float64), axis=0)
    n = len(pts)
    if n <= 3:
        return pts.astype(np.int64)
    k = max(3, min(k, n - 1))

    def intersects(p1, p2, q1, q2) -> bool:
        def ccw(a, b, c):
            return (c[1] - a[1]) * (b[0] - a[0]) > (b[1] - a[1]) * (c[0] - a[0])
        if (tuple(p1) in (tuple(q1), tuple(q2)) or
                tuple(p2) in (tuple(q1), tuple(q2))):
            return False
        return (ccw(p1, q1, q2) != ccw(p2, q1, q2)
                and ccw(p1, p2, q1) != ccw(p1, p2, q2))

    while k < n:
        start_idx = int(np.lexsort((pts[:, 0], pts[:, 1]))[0])  # lowest y
        hull = [pts[start_idx]]
        used = np.zeros(n, dtype=bool)
        used[start_idx] = True
        # incoming direction points left so the first turn sweeps the
        # boundary counterclockwise in raster (y-down) coordinates
        prev_angle = np.pi
        current = pts[start_idx]
        ok = False
        for _ in range(3 * n):
            cand = np.where(~used)[0]
            if len(hull) > 3:
                cand = np.concatenate([cand, [start_idx]])
            if len(cand) == 0:
                break
            d = np.hypot(pts[cand, 0] - current[0], pts[cand, 1] - current[1])
            near = cand[np.argsort(d)[:k]]
            ang = np.arctan2(pts[near, 1] - current[1],
                             pts[near, 0] - current[0])
            # smallest counterclockwise rotation from the reversed incoming
            # edge; near-zero would walk straight back, so wrap it to 2π
            rel = (ang - prev_angle) % (2 * np.pi)
            rel = np.where(rel < 1e-9, rel + 2 * np.pi, rel)
            order = near[np.argsort(rel)]
            chosen = None
            for c in order:
                cp = pts[c]
                bad = False
                for i in range(len(hull) - 2):
                    if intersects(current, cp, hull[i], hull[i + 1]):
                        bad = True
                        break
                if not bad:
                    chosen = c
                    break
            if chosen is None:
                break
            if chosen == start_idx and len(hull) > 3:
                ok = True
                break
            prev_angle = np.arctan2(current[1] - pts[chosen][1],
                                    current[0] - pts[chosen][0])
            current = pts[chosen]
            hull.append(current)
            used[chosen] = True
            if used.sum() == n:
                ok = True
                break
        if ok and _contains_most(np.asarray(hull), pts):
            return np.asarray(hull, dtype=np.int64)
        k += 2  # widen the neighborhood and retry
    return convex_hull_points(points.astype(np.int64))


def _contains_most(hull_pts: np.ndarray, pts: np.ndarray,
                   frac: float = 0.98) -> bool:
    """Moreira-Santos acceptance check: (almost) all points lie inside the
    candidate polygon. Rasterized containment with a 1px dilation margin."""
    if len(hull_pts) < 3:
        return False
    mins = pts.min(axis=0)
    span = np.maximum(pts.max(axis=0) - mins, 1)
    scale = 128.0 / span.max()
    poly = ((hull_pts - mins) * scale).astype(np.int64)
    test = ((pts - mins) * scale).astype(np.int64)
    h = w = int(128 + 2)
    mask = fill_polygon(poly, (h, w))
    # 1px margin for rasterization edge effects
    mask = np.maximum.reduce([
        mask,
        np.pad(mask[1:], ((0, 1), (0, 0))), np.pad(mask[:-1], ((1, 0), (0, 0))),
        np.pad(mask[:, 1:], ((0, 0), (0, 1))), np.pad(mask[:, :-1], ((0, 0), (1, 0))),
    ])
    inside = mask[test[:, 1].clip(0, h - 1), test[:, 0].clip(0, w - 1)]
    return inside.mean() >= frac
