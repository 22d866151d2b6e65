"""U-Net decoder (smp-style) — counterpart of ``wsiseg_tpu/models/unet.py``.

Five blocks with decoder channels (256, 128, 64, 32, 16), each a nearest
2× upsample → concat encoder skip → two 3×3 conv+BN+ReLU. The final 3×3
seg head (with bias) lives on the Y-Net as ``segmentation_head.0``, where
smp keeps it. Block names follow smp (``blocks.{i}.conv{k}.{0,1}``).
The port trains through this decoder: the JAX package's train-mode s2d
tail (``_S2dTailBlock``) is not ported (ROADMAP.md §3).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wsiseg_tpu_torch.models.resnet import BatchNorm2d


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cskip: int, cout: int):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.Conv2d(cin + cskip, cout, 3, 1, 1, bias=False),
            BatchNorm2d(cout), nn.ReLU())
        self.conv2 = nn.Sequential(
            nn.Conv2d(cout, cout, 3, 1, 1, bias=False),
            BatchNorm2d(cout), nn.ReLU())

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
        return self.conv2(self.conv1(x))


class UNetDecoder(nn.Module):
    """features: deepest-first pyramid [c5, c4, c3, c2, c1]. Returns the
    last block's (B, 16, H, W) activation; the Y-Net's seg head maps it
    to logits."""

    def __init__(self, encoder_channels: Sequence[int] = (512, 256, 128, 64,
                                                          64),
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__()
        ins = [encoder_channels[0]] + list(decoder_channels[:-1])
        skips = list(encoder_channels[1:]) + [0]
        self.blocks = nn.ModuleList(
            DecoderBlock(i, s, o)
            for i, s, o in zip(ins, skips, decoder_channels))

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        x = features[0]
        skips = list(features[1:]) + [None]
        for block, skip in zip(self.blocks, skips):
            x = block(x, skip)
        return x
