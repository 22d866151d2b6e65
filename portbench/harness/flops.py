"""Operations of a forward pass, counted on the plain reference.

2 × the multiply-adds of every conv and linear of the reference model at
the given input shape, counted by hooks while the model runs on the
``meta`` device (no memory, no arithmetic). Element-wise work
(BatchNorm, ReLU, resizes, softmax) is not counted: it is not what a
tensor-core peak measures. A function of the configuration and the
shapes only, so a share of the peak reads the same work whatever
implements it.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from portbench.reference.ynet import build


def forward_flops(cfg: Dict, n: int, h: int, w: int,
                  heads: bool = False) -> float:
    """FLOPs of one forward of ``n`` (h, w) images: the segmentation path
    (encoder, decoder, head), and with ``heads`` the classifier and the
    regressor too (the training forward)."""
    with torch.device("meta"):
        model = build(cfg)
    macs = [0]

    def conv_hook(m: nn.Conv2d, _args, out):
        k = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
        macs[0] += out.numel() * k

    def linear_hook(m: nn.Linear, _args, out):
        macs[0] += out.numel() * m.in_features

    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.register_forward_hook(conv_hook)
        elif isinstance(m, nn.Linear):
            m.register_forward_hook(linear_hook)
    x = torch.empty((n, 3, h, w), device="meta")
    with torch.no_grad():
        model(x) if heads else model.segment(x)
    return 2.0 * macs[0]
