"""Labels and heat of one slide from its logits, as the program's output
is defined (reference ``utils/eval.py``, the port's planar postprocess):
softmax over the classes in float32, probabilities under the class
floors set to 0, the label the first class of the largest probability,
the heat P(2) + P(3) where the tissue mask holds, quantised to u8 as
``round(255·heat)``. The tissue mask applies per 4×4 cell of the output,
each cell taking the mask's pixel (4i + 2, 4j + 2): a nearest resize of
the level-2 mask to a quarter of its size (PIL's NEAREST picks index
``int(s/2 + k·s)``, s = 4), as the program applies it.

Then the two numbers that judge the program's labels and heat against
these.
Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def probabilities(logits: torch.Tensor,
                  floors: Sequence[float]) -> torch.Tensor:
    """(nc, H, W) logits → floored (nc, H, W) float32 probabilities."""
    p = torch.softmax(logits.float(), dim=0)
    fl = torch.tensor(list(floors), dtype=p.dtype,
                      device=p.device).view(-1, 1, 1)
    return torch.where(p < fl, torch.zeros_like(p), p)


def cell_mask(mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The level-2 tissue mask as the heat sees it: (h, w) bool, constant
    on 4×4 cells."""
    m = mask[2::4, 2::4] > 0
    m = m.repeat_interleave(4, 0).repeat_interleave(4, 1)
    return m[:h, :w]


def labels_heat(probs: torch.Tensor, mask: torch.Tensor):
    """(labels u8, heat u8), each (H, W), from floored probabilities and
    the level-2 tissue mask."""
    labels = torch.argmax(probs, dim=0).to(torch.uint8)
    heat = (probs[2] + probs[3]) * cell_mask(mask, *probs.shape[1:])
    heat = torch.clamp(torch.round(heat * 255.0), 0, 255).to(torch.uint8)
    return labels, heat


def judge(probs: torch.Tensor, mask: torch.Tensor, labels: np.ndarray,
          heat_u8: np.ndarray) -> Dict[str, float]:
    """The program's labels and heat against the reference's floored
    probabilities: ``heat_err``, the largest heat difference in u8 steps,
    and ``label_miss``, the share (parts per million) of pixels whose
    program label the reference puts more than one u8 heat step (1/255)
    below its own best class: a label the reference decides at the
    output's own resolution, and the program gets wrong."""
    ref_labels, ref_heat = labels_heat(probs, mask)
    lab = torch.from_numpy(np.ascontiguousarray(labels)).to(probs.device)
    ht = torch.from_numpy(np.ascontiguousarray(heat_u8)).to(probs.device)
    if lab.shape != ref_labels.shape or ht.shape != ref_heat.shape:
        raise ValueError(f"output shapes {tuple(lab.shape)}, "
                         f"{tuple(ht.shape)} differ from the reference's "
                         f"{tuple(ref_labels.shape)}")
    best = probs.gather(0, ref_labels.long()[None])[0]
    got = probs.gather(0, lab.long().clamp(0, probs.shape[0] - 1)[None])[0]
    bad = lab.long() >= probs.shape[0]
    miss = bad | (best - got > 1.0 / 255.0)
    diff = (ht.int() - ref_heat.int()).abs()
    return {"heat_err": float(diff.max()),
            "label_miss": 1e6 * float(miss.sum()) / miss.numel()}


def worst(readings: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """The largest of each number over several slides."""
    return {k: max(r[k] for r in readings) for k in readings[0]}
