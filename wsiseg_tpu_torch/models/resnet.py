"""ResNet encoders — counterpart of ``wsiseg_tpu/models/resnet.py``.

Architecture of the torchvision ResNets the reference uses as smp encoders:
7×7/2 stem, 3×3/2 max-pool, four stages of BasicBlocks (resnet18/34) or
Bottlenecks (resnet50/101/152). Returns the feature pyramid
deepest-first, [c5, c4, c3, c2, c1], like the flax encoder. Parameter
names are torchvision's (``conv1``, ``bn1``, ``layer{i}.{j}.conv{k}``,
``layer{i}.0.downsample.{0,1}``), so a reference smp checkpoint loads
directly and :mod:`.flax_import` maps the flax tree.
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


class Bottleneck(nn.Module):
    """torchvision's Bottleneck: 1×1 reduce, 3×3 with the stride, 1×1
    expand ×4, each BN'd; a projection shortcut wherever the shape changes
    (the first block of every stage, layer1's included: 64 → 256 at
    stride 1)."""
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


# encoder name → (block class, stage sizes); channels follow torchvision.
ENCODER_SPECS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
    "resnet152": (Bottleneck, (3, 8, 36, 3)),
}


def check_arch(arch: str) -> None:
    if arch not in ENCODER_SPECS:
        raise ValueError(f"unknown encoder {arch!r}; expected one of "
                         f"{tuple(ENCODER_SPECS)}")


def is_bottleneck(arch: str) -> bool:
    check_arch(arch)
    return ENCODER_SPECS[arch][0] is Bottleneck


def encoder_out_channels(arch: str) -> Tuple[int, ...]:
    """Deepest-first channel counts of the returned pyramid."""
    check_arch(arch)
    e = ENCODER_SPECS[arch][0].expansion
    return (512 * e, 256 * e, 128 * e, 64 * e, 64)


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
                cin = f * block_cls.expansion
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
