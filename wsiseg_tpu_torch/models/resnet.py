"""ResNet encoders — counterpart of ``wsiseg_tpu/models/resnet.py``.

Architecture of the torchvision ResNets the reference uses as smp encoders:
7×7/2 stem, 3×3/2 max-pool, four stages of BasicBlocks (resnet18/34) or
Bottlenecks (resnet50/101/152). Returns the feature pyramid
deepest-first, [c5, c4, c3, c2, c1], like the flax encoder. Parameter
names are torchvision's (``conv1``, ``bn1``, ``layer{i}.{j}.conv{k}``,
``layer{i}.0.downsample.{0,1}``), so a reference smp checkpoint loads
directly and :mod:`.flax_import` maps the flax tree.

Every BatchNorm of the port is :class:`BatchNorm2d`: torch's, with flax's
train-mode update of the running variance.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that trains as flax's ``nn.BatchNorm`` (momentum
    0.9 = torch's 0.1, the default): the batch is normalized with its
    biased variance, as torch does, but the running variance also takes
    the biased one, E[x²] − E[x]², where torch takes n/(n−1) of it. At
    the deepest layer of a small batch (8 values per channel) the two
    differ by 8/7. Eval mode is torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        n = x.numel() // x.shape[1]
        if n == 1:
            return self._single(x)
        # torch's update goes to a scratch copy (the graph keeps it), then
        # kept + m·n/(n−1)·var becomes flax's kept + m·var
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        with torch.no_grad():
            kept = (1.0 - self.momentum) * self.running_var
            self.running_var.copy_((var - kept) * ((n - 1) / n) + kept)
        return y

    def _single(self, x: torch.Tensor) -> torch.Tensor:
        """One value per channel, where torch refuses to train: x equals
        its batch mean and the variance is 0, so each output is the
        channel's bias, and x and the scale get zero gradients (flax)."""
        mean = x.detach().reshape(-1).to(self.running_mean.dtype)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(
                self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum)
        return (x * self.weight.view(1, -1, 1, 1) * 0
                + self.bias.view(1, -1, 1, 1)).to(x.dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                BatchNorm2d(cout))

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
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                BatchNorm2d(cout))

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
        self.bn1 = BatchNorm2d(64)
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
