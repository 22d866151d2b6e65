"""Connected components — counterpart of ``wsiseg_tpu/ops/cc.py``.

The reference uses ``cv2.connectedComponentsWithStats`` on level-2
thumbnails (scannet.py:55, preprocess/mk_traindata_*:66). Two paths:

* :func:`connected_components` / :func:`connected_components_with_stats` —
  host path over scipy.ndimage.label (a copy of the JAX module's);
* :func:`label_propagation` — on the mask's device, iterative min-label
  flood, one tensor min a neighbour a step. JAX tests for change after
  every step inside its ``while_loop``; here each test is a device→host
  sync, so it runs every :data:`CHECK_EVERY` steps. Once converged a step
  changes nothing, and never more steps run than JAX's cap, so the labels
  are JAX's exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import scipy.ndimage as ndi
import torch

#: label_propagation tests for change once every this many steps
CHECK_EVERY = 32


class CCStats(NamedTuple):
    labels: np.ndarray      # (H, W) int32, 0 = background
    num: int                # number of components incl. background
    stats: np.ndarray       # (num, 5): x, y, w, h, area  (cv2 layout)
    centroids: np.ndarray   # (num, 2): x, y


_STRUCT8 = np.ones((3, 3), dtype=bool)
_STRUCT4 = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)


def connected_components(mask: np.ndarray,
                         connectivity: int = 8) -> Tuple[np.ndarray, int]:
    """labels (0=bg) and count incl. background — cv2.connectedComponents
    semantics."""
    structure = _STRUCT8 if connectivity == 8 else _STRUCT4
    labels, n = ndi.label(np.asarray(mask) > 0, structure=structure)
    return labels.astype(np.int32), n + 1


def connected_components_with_stats(mask: np.ndarray,
                                    connectivity: int = 8) -> CCStats:
    labels, num = connected_components(mask, connectivity)
    stats = np.zeros((num, 5), np.int64)
    cents = np.zeros((num, 2), np.float64)
    for k in range(num):
        sel = labels == k
        area = int(sel.sum())
        if area == 0:
            continue
        ys, xs = np.nonzero(sel)
        stats[k] = [xs.min(), ys.min(), xs.max() - xs.min() + 1,
                    ys.max() - ys.min() + 1, area]
        cents[k] = [xs.mean(), ys.mean()]
    return CCStats(labels, num, stats, cents)


def _shift(x: torch.Tensor, dy: int, dx: int, fill: int) -> torch.Tensor:
    """out[i, j] = x[i + dy, j + dx], ``fill`` outside the image."""
    h, w = x.shape
    out = torch.full_like(x, fill)
    out[max(0, -dy):h - max(0, dy), max(0, -dx):w - max(0, dx)] = \
        x[max(0, dy):h - max(0, -dy), max(0, dx):w - max(0, -dx)]
    return out


_NEIGHBOURS = {4: ((1, 0), (-1, 0), (0, 1), (0, -1)),
               8: ((1, 0), (-1, 0), (0, 1), (0, -1),
                   (1, 1), (1, -1), (-1, 1), (-1, -1))}


@torch.no_grad()
def label_propagation_steps(mask: torch.Tensor,
                            max_iters: Optional[int] = None,
                            connectivity: int = 4
                            ) -> Tuple[torch.Tensor, int]:
    """:func:`label_propagation` and the number of steps it ran (a
    multiple of :data:`CHECK_EVERY` or the cap)."""
    m = mask > 0
    h, w = m.shape
    if max_iters is None:
        max_iters = h * w
    big = h * w + 2
    ids = torch.arange(1, h * w + 1, dtype=torch.int32,
                       device=m.device).reshape(h, w)
    cur = torch.where(m, ids, big)
    done = 0
    while done < max_iters:
        before = cur
        for _ in range(min(CHECK_EVERY, max_iters - done)):
            nxt = cur
            for dy, dx in _NEIGHBOURS[connectivity]:
                nxt = torch.minimum(nxt, _shift(cur, dy, dx, big))
            cur = torch.where(m, nxt, big)
            done += 1
        if torch.equal(cur, before):
            break
    return torch.where(m, cur, 0).to(torch.int32), done


def label_propagation(mask: torch.Tensor, max_iters: Optional[int] = None,
                      connectivity: int = 4) -> torch.Tensor:
    """CC labeling of an (H, W) mask on its device by iterative min-label
    propagation: each foreground pixel starts with a unique id (its flat
    index + 1) and every step takes the min over its 4- or 8-neighbourhood
    (image borders read as background). It converges to the per-component
    minima in O(geodesic diameter) steps, which can reach O(H·W) for
    serpentine components, so the default cap is H·W. Returns int32
    labels (0 = background; ids distinct per component)."""
    return label_propagation_steps(mask, max_iters, connectivity)[0]
