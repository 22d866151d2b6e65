"""Lloyd k-means on tensors — counterpart of ``wsiseg_tpu/ops/kmeans.py``
(the reference's sklearn (MiniBatch)KMeans: region keypoints,
utils/regiontools.py:89; colour quantization,
utils/preprocessing.py:365).

Two parts, as JAX's ``kmeans`` has:

* :func:`plusplus_init` — k-means++ seeding (greedy weighted D² sampling)
  on the host, in float64 from a host copy of the points, with draws from
  ``np.random.RandomState(seed)``. So the seeds are the same whichever
  device then runs Lloyd, and the card and the CPU agree. JAX draws from
  threefry (``jax.random.choice``), which no torch or numpy generator
  reproduces: cluster ids, centers and proposals differ from JAX's by
  design, as they already differ from sklearn's (SURVEY.md §7f).
* :func:`lloyd` — fixed-count weighted Lloyd steps on the points' device
  in float32, JAX's arithmetic: the expanded distance without ‖p‖², first
  index ``argmin`` ties, one-hot weighted sums, empty clusters kept where
  they were, zero-weight (padding) points labelled −1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wsiseg_tpu_torch.ops.slic import _full_f32


def _draw(rng: np.random.RandomState, mass: np.ndarray) -> int:
    """An index drawn with probability ∝ ``mass`` (float64, ≥ 0): the
    first whose cumulative mass exceeds a uniform draw of the total, so a
    point of zero mass is never drawn."""
    cum = np.cumsum(mass)
    return int(min(np.searchsorted(cum, rng.random_sample() * cum[-1],
                                   side="right"), len(cum) - 1))


def plusplus_init(points, k: int, weights=None, seed: int = 0) -> np.ndarray:
    """k-means++ seeds (K, D) float32 of ``points`` (N, D), a tensor on
    any device or an array. Zero-weight (padding) points are never chosen;
    when every weighted point sits on a chosen seed, the next seed is drawn
    by weight alone."""
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    p = np.asarray(points, np.float64)
    w = (np.ones(len(p)) if weights is None else np.asarray(
        weights.detach().cpu().numpy() if isinstance(weights, torch.Tensor)
        else weights, np.float64))
    rng = np.random.RandomState(seed)
    centers = np.zeros((k, p.shape[1]), np.float64)
    centers[0] = p[_draw(rng, w)]
    d2 = ((p - centers[0]) ** 2).sum(1)
    for i in range(1, k):
        mass = d2 * w
        centers[i] = p[_draw(rng, mass if mass.sum() > 0 else w)]
        d2 = np.minimum(d2, ((p - centers[i]) ** 2).sum(1))
    return centers.astype(np.float32)


def lloyd(points: torch.Tensor, centers: torch.Tensor, iters: int = 25,
          weights: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` weighted Lloyd steps from ``centers`` (K, D) on the
    device of ``points`` (N, D). Returns (centers (K, D) float32, labels
    (N,) int32, −1 where the weight is 0)."""
    points = points.to(torch.float32)
    dev = points.device
    centers = torch.tensor(np.asarray(centers.cpu() if isinstance(
        centers, torch.Tensor) else centers), dtype=torch.float32,
        device=dev)
    w = (torch.ones(points.shape[0], device=dev) if weights is None
         else torch.as_tensor(weights, dtype=torch.float32, device=dev))
    k = centers.shape[0]

    def assign(c):
        # ||p - c||² = ||p||² - 2 p·c + ||c||²; argmin over c drops ||p||²
        return (-2.0 * points @ c.T + (c ** 2).sum(-1)[None, :]).argmin(1)

    with _full_f32():
        for _ in range(iters):
            onehot = F.one_hot(assign(centers), k).to(torch.float32) \
                * w[:, None]
            counts = onehot.sum(0)
            new = (onehot.T @ points) / torch.clamp(counts,
                                                    min=1e-12)[:, None]
            centers = torch.where(counts[:, None] > 0, new, centers)
        labels = assign(centers).to(torch.int32)
    return centers, torch.where(w > 0, labels, -1)


@torch.no_grad()
def kmeans(points: torch.Tensor, k: int, iters: int = 25,
           weights: Optional[torch.Tensor] = None,
           seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted k-means of ``points`` (N, D) on their device:
    :func:`plusplus_init` seeds, then :func:`lloyd`. ``weights`` 0 marks
    a point to ignore. Returns (centers (K, D), labels (N,) int32)."""
    centers = plusplus_init(points, k, weights, seed)
    return lloyd(points, centers, iters, weights)


def quantize_image(rgb_uint8: torch.Tensor, n_colors: int = 0,
                   iters: int = 10, seed: int = 0) -> torch.Tensor:
    """K-means colour quantization (reference utils/preprocessing.py:
    358-370) of an (H, W, 3) uint8 tensor on its device. ``n_colors`` < 2
    returns the input unchanged."""
    if n_colors < 2:
        return rgb_uint8
    h, w, _ = rgb_uint8.shape
    flat = rgb_uint8.reshape(-1, 3).to(torch.float32)
    centers, labels = kmeans(flat, n_colors, iters=iters, seed=seed)
    q = torch.clamp(torch.round(centers[labels.long()]), 0, 255)
    return q.to(torch.uint8).reshape(h, w, 3)


def mask_keypoints(mask: np.ndarray, us: int, min_clusters: int,
                   max_points: int = 4096, seed: int = 0, device="cuda"):
    """K-means centers of a binary region — `get_key_points` twin
    (reference utils/regiontools.py:68-102): the mask downsampled by
    ``us``, its foreground (x, y) clustered on ``device`` and the centers
    scaled back up. Returns (num_clusters, centers_xy int64 (K, 2)) or
    (None, None) when the region is too small (reference :86-87). JAX pads
    the points to a multiple of 8 with zero weights for its compile cache;
    zero weights change nothing, so here there is no padding."""
    m = np.asarray(mask)[::us, ::us]
    ys, xs = np.nonzero(m)
    coords = np.stack([xs, ys], axis=1).astype(np.float32)
    k = int(min_clusters)
    if k <= 1 or coords.shape[0] <= 3 * k:
        return None, None
    if coords.shape[0] > max_points:
        sel = np.random.RandomState(0).choice(coords.shape[0], max_points,
                                              replace=False)
        coords = coords[sel]
    centers, _ = kmeans(torch.from_numpy(coords).to(device), k, seed=seed)
    return k, (us * centers.cpu().numpy()).astype(np.int64)
