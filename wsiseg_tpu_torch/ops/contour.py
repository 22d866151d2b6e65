"""Contour ordering and arclength-uniform resampling — counterpart (a
copy) of ``wsiseg_tpu/ops/contour.py``, twin of reference
``contour_ordering.py``:

* :func:`sort_clockwise`   — order interleaved points clockwise around the
                             point nearest the origin (:12-31)
* :func:`evenly_spaced_points_on_a_contour` — arclength-uniform linear
                             resampling of an open polyline (:33-60)
* :func:`interparc`        — arclength-uniform resampling of a closed
                             contour, MATLAB ``interparc`` semantics
                             (:276-332; the reference is an element-loop
                             port — this is the same math vectorized)

Used by the region-proposal generators to place perimeter keypoints
(preprocess/region_proposal_points.py:113-169).
"""

from __future__ import annotations

import numpy as np


def sort_clockwise(points):
    """Order a flat interleaved point list clockwise.

    Input format follows the reference (contour_ordering.py:12-31): a flat
    sequence laid out as ``(x0, x1, ..., xn, y0, y1, ..., yn)`` — i.e. the
    i-th point is ``(points[i], points[i + n])``. Returns the same flat
    layout, starting from the point closest to the origin, remaining points
    sorted by descending angle about it.
    """
    n = len(points) // 2
    coords = [np.array([points[i], points[i + n]], dtype=float)
              for i in range(n)]
    coords = sorted(coords, key=np.linalg.norm)
    start, rest = coords[0], coords[1:]

    def angle(c):
        v = c - start
        return np.angle(complex(v[0], v[1]))

    rest = sorted(rest, key=angle, reverse=True)
    ordered = [start] + rest
    xs = [c[0] for c in ordered]
    ys = [c[1] for c in ordered]
    return xs + ys


def evenly_spaced_points_on_a_contour(points, num_pts: int) -> np.ndarray:
    """Resample an (N, 2) polyline to ``num_pts`` points uniformly spaced in
    cumulative chord length (contour_ordering.py:44-60)."""
    points = np.asarray(points, dtype=float)
    x, y = points[:, 0], points[:, 1]
    dist = np.hypot(np.diff(x), np.diff(y))
    u = np.concatenate([[0.0], np.cumsum(dist)])
    t = np.linspace(0.0, u[-1], num_pts)
    return np.stack([np.interp(t, u, x), np.interp(t, u, y)], axis=1)


def interparc(points, t) -> np.ndarray:
    """Arclength-uniform resampling of a contour, closing it first if the
    endpoints don't coincide (MATLAB ``interparc``, linear method —
    reference contour_ordering.py:276-332).

    Args:
      points: (N, 2) vertices.
      t: number of output points (int), or an array of parameters in [0, 1].
    Returns (T, 2) resampled points.
    """
    points = np.asarray(points, dtype=float)
    if np.isscalar(t):
        t = np.linspace(0.0, 1.0, int(t))
    t = np.asarray(t, dtype=float)

    # close the curve when endpoints differ meaningfully
    # (reference _evenly_spaced_points_on_a_contour:79-87)
    eps = 10 * np.finfo(float).eps
    if np.linalg.norm(points[0] - points[-1]) > \
            eps * np.linalg.norm(np.max(np.abs(points), axis=0)):
        points = np.vstack([points, points[0]])

    seg = np.diff(points, axis=0)
    chordlen = np.hypot(seg[:, 0], seg[:, 1])
    total = chordlen.sum()
    if total <= 0:
        return np.tile(points[0], (len(t), 1))
    chordlen = chordlen / total
    cumarc = np.concatenate([[0.0], np.cumsum(chordlen)])

    tbins = np.digitize(t, cumarc) - 1
    tbins = np.clip(tbins, 0, len(chordlen) - 1)
    s = (t - cumarc[tbins]) / chordlen[tbins]
    return points[tbins] + (points[tbins + 1] - points[tbins]) * s[:, None]
