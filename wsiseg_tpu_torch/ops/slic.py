"""SLIC superpixels on tensors — counterpart of ``wsiseg_tpu/ops/slic.py``
(reference slic.py:43: n_segments=200, compactness=20, sigma=5).

Iterative localized k-means in CIELAB×XY space, as in JAX: one dense
(N_pixels × K) distance a step, in the expanded form
‖a‖² − 2a·c + ‖c‖² (a ``torch.cdist`` or a difference of squares rounds
otherwise and moves labels), candidates beyond the 2S window masked out,
an unmasked fallback for pixels 2S from every center, first-index
``argmin`` ties, and the centers from a one-hot (N, K) product. Everything runs on the image's
device in float32. The distance and centre products run in full float32
whatever ``torch.backends.cuda.matmul.allow_tf32`` says (TF32 rounds the
operands to 10 mantissa bits and moves labels).

Cluster ids are not comparable to skimage's; the JAX package's parity is
on derived artifacts too (SURVEY.md §7f).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from wsiseg_tpu_torch.ops.color import rgb_to_lab


@contextlib.contextmanager
def _full_f32():
    """float32 products without TF32 on the card for the block's span."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _blur_rows(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``x`` (H, ...) convolved along dim 0 with the odd, symmetric ``k``,
    edges replicated: one shifted multiply-add a tap, in tap order."""
    r = (k.numel() - 1) // 2
    h = x.shape[0]
    pad = torch.cat([x[:1].expand(r, *x.shape[1:]), x,
                     x[-1:].expand(r, *x.shape[1:])])
    out = torch.zeros_like(x)
    for j in range(k.numel()):
        out = out + k[j] * pad[j:j + h]
    return out


def _gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian over (H, W, C), edge padded — skimage slic's
    pre-smoothing. Elementwise float32 (no convolution library), so the
    card and the CPU round alike."""
    if sigma <= 0:
        return img
    radius = int(3 * sigma + 0.5)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    out = _blur_rows(img, k)
    return _blur_rows(out.transpose(0, 1), k).transpose(0, 1)


def _distances(flat: torch.Tensor, centers: torch.Tensor, ratio: float):
    """(d_color + ratio·d_space, d_space), each (N, K), expanded form."""
    a, p = flat[:, :3], flat[:, 3:]
    ca, cp = centers[:, :3], centers[:, 3:]
    d_color = ((a ** 2).sum(-1)[:, None] - 2.0 * a @ ca.T
               + (ca ** 2).sum(-1)[None, :])
    d_space = ((p ** 2).sum(-1)[:, None] - 2.0 * p @ cp.T
               + (cp ** 2).sum(-1)[None, :])
    return d_color + ratio * d_space, d_space


def _slic_core(lab_img: torch.Tensor, n_segments: int, compactness: float,
               iters: int) -> torch.Tensor:
    h, w = lab_img.shape[:2]
    n = h * w
    dev = lab_img.device

    # grid-initialize K cluster centers
    s = max(1, int(np.sqrt(n / n_segments)))
    gy = np.arange(s // 2, h, s)
    gx = np.arange(s // 2, w, s)
    k = len(gy) * len(gx)
    cy0, cx0 = np.meshgrid(gy, gx, indexing="ij")
    cy0, cx0 = cy0.reshape(-1), cx0.reshape(-1)

    yy, xx = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32),
                            indexing="ij")
    flat = torch.cat([lab_img, yy[..., None], xx[..., None]], -1).reshape(
        n, 5)
    ratio = (compactness / s) ** 2
    far = (2.0 * s) ** 2

    c_lab = lab_img[torch.from_numpy(cy0).to(dev),
                    torch.from_numpy(cx0).to(dev)]
    centers = torch.cat([c_lab, torch.tensor(
        np.stack([cy0, cx0], 1), dtype=torch.float32, device=dev)], -1)

    def masked(d, d_space):
        return torch.where(d_space > far, torch.inf, d)

    for _ in range(iters):
        d, d_space = _distances(flat, centers, ratio)
        labels = masked(d, d_space).argmin(1)
        onehot = F.one_hot(labels, k).to(torch.float32)
        counts = onehot.sum(0)
        sums = onehot.T @ flat
        centers = sums / torch.clamp(counts, min=1.0)[:, None]
    d, d_space = _distances(flat, centers, ratio)
    dm = masked(d, d_space)
    labels = torch.where(torch.isinf(dm).all(1), d.argmin(1), dm.argmin(1))
    return labels.reshape(h, w).to(torch.int32)


@torch.no_grad()
def slic(rgb_uint8: torch.Tensor, n_segments: int = 200,
         compactness: float = 20.0, sigma: float = 5.0,
         iters: int = 10) -> torch.Tensor:
    """SLIC labels (H, W) int32 in [0, K) of an (H, W, 3) uint8 RGB tensor,
    on its device."""
    img = rgb_uint8.to(torch.float32) / 255.0
    lab = _gaussian_blur(rgb_to_lab(img), sigma)
    with _full_f32():
        return _slic_core(lab, n_segments, compactness, iters)


def mark_boundaries(rgb_uint8: np.ndarray, labels: np.ndarray,
                    color=(255, 255, 0)) -> np.ndarray:
    """Overlay superpixel boundaries (skimage.mark_boundaries twin)."""
    labels = np.asarray(labels)
    edge = np.zeros(labels.shape, bool)
    edge[:-1, :] |= labels[:-1, :] != labels[1:, :]
    edge[:, :-1] |= labels[:, :-1] != labels[:, 1:]
    out = np.asarray(rgb_uint8).copy()
    out[edge] = color
    return out
