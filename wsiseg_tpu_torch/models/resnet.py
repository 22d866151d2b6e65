"""ResNet encoders — counterpart of ``wsiseg_tpu/models/resnet.py``.

Architecture of the torchvision ResNets the reference uses as smp encoders:
7×7/2 stem, 3×3/2 max-pool, four stages of BasicBlocks. Returns the
feature pyramid deepest-first, [c5, c4, c3, c2, c1], like the flax encoder.
Parameter names are torchvision's (``conv1``, ``bn1``,
``layer{i}.{j}.conv{k}``, ``layer{i}.0.downsample.{0,1}``), so a reference
smp checkpoint loads directly and :mod:`.flax_import` maps the flax tree.

BasicBlock archs only (resnet18/34); the Bottleneck archs are still to be
ported (ROADMAP.md, queue 1: "Linknet/FPN/PSPNet and Bottleneck families").
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


# encoder name → (block class, stage sizes); channels follow torchvision.
ENCODER_SPECS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
}

NOT_PORTED = ("not ported yet: ROADMAP.md, queue 1, "
              "'Linknet/FPN/PSPNet and Bottleneck families'")


def check_arch(arch: str) -> None:
    if arch not in ENCODER_SPECS:
        raise NotImplementedError(f"encoder {arch!r} is {NOT_PORTED}")


def encoder_out_channels(arch: str) -> Tuple[int, ...]:
    """Deepest-first channel counts of the returned pyramid."""
    check_arch(arch)
    return (512, 256, 128, 64, 64)


class ResNetEncoder(nn.Module):
    """Returns [c5, c4, c3, c2, c1]: strides /32, /16, /8, /4, /2."""

    def __init__(self, arch: str = "resnet18"):
        super().__init__()
        check_arch(arch)
        block_cls, stages = ENCODER_SPECS[arch]
        self.arch = arch
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for i, (n_blocks, f) in enumerate(zip(stages, (64, 128, 256, 512))):
            blocks = []
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                blocks.append(block_cls(cin, f, stride))
                cin = f
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        c1 = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(c1, 3, 2, 1)
        feats = []
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            feats.append(x)
        c2, c3, c4, c5 = feats
        return [c5, c4, c3, c2, c1]
