"""The reference's slide forward: normalised float32 input, the plain
Y-Net's segmentation logits, then the floored probabilities. TF32 is
switched off while it runs, so every product is a float32 one."""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import numpy as np
import torch

from portbench.reference import postprocess
from portbench.reference.ynet import YNet, build


@contextlib.contextmanager
def exact_f32():
    """No TF32 in matmuls or convolutions within the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def model_from_state(cfg: Dict, state: Dict[str, torch.Tensor],
                     device) -> YNet:
    """The reference model in float32 on ``device``, eval mode, with the
    benchmark's weights."""
    model = build(cfg)
    model.load_state_dict({k: v.float() if v.is_floating_point() else v
                           for k, v in state.items()})
    return model.to(device).eval()


def normalise(image_u8: np.ndarray, mean: Sequence[float],
              std: Sequence[float], device) -> torch.Tensor:
    """(H, W, 3) u8 → (1, 3, H, W) float32, (x/255 − mean)/std."""
    x = torch.from_numpy(np.ascontiguousarray(image_u8)).to(device).float()
    x = x / 255.0
    m = torch.tensor(mean, device=device).view(1, 1, 3)
    s = torch.tensor(std, device=device).view(1, 1, 3)
    return ((x - m) / s).permute(2, 0, 1)[None]


@torch.no_grad()
def slide_probs(model: YNet, cfg: Dict, image_u8: np.ndarray,
                device) -> torch.Tensor:
    """Floored (nc, H, W) probabilities of one level-2 image. Its sides
    must be multiples of 32 (the program pads others with white; this
    reference does not)."""
    h, w = image_u8.shape[:2]
    if h % 32 or w % 32:
        raise ValueError(f"reference slides need sides that are multiples "
                         f"of 32, got {h}×{w}")
    with exact_f32():
        logits = model.segment(normalise(image_u8, cfg["dataset_mean"],
                                         cfg["dataset_std"], device))[0]
    return postprocess.probabilities(logits, cfg["class_probs"])
