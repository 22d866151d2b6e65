"""ResNet encoders — counterpart of ``wsiseg_tpu/models/resnet.py``.

Architecture of the torchvision ResNets the reference uses as smp encoders:
7×7/2 stem, 3×3/2 max-pool, four stages of BasicBlocks (resnet18/34) or
Bottlenecks (resnet50/101/152). Returns the feature pyramid
deepest-first, [c5, c4, c3, c2, c1], like the flax encoder. Parameter
names are torchvision's (``conv1``, ``bn1``, ``layer{i}.{j}.conv{k}``,
``layer{i}.0.downsample.{0,1}``), so a reference smp checkpoint loads
directly and :mod:`.flax_import` maps the flax tree.

Every BatchNorm of the port is :class:`BatchNorm2d`: torch's, with flax's
train-mode update of the running variance, and global batch statistics
under data-parallel training.

Every conv is :class:`~wsiseg_tpu_torch.parallel.spatial.Conv2d`, an
``nn.Conv2d`` that runs on row stripes under spatial training, and the
encoder follows ``parallel.spatial``'s plan there: each stage's input is
gathered over the space group where its level does not run on stripes.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from wsiseg_tpu_torch.models.mit import MIT_SPECS, mit_out_channels
from wsiseg_tpu_torch.models.swin import SWIN_SPECS, swin_out_channels
from wsiseg_tpu_torch.parallel import comm, spatial
from wsiseg_tpu_torch.parallel.spatial import Conv2d


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that trains as flax's ``nn.BatchNorm`` (momentum
    0.9 = torch's 0.1, the default): the batch is normalized with its
    biased variance, as torch does, but the running variance also takes
    the biased one, E[x²] − E[x]², where torch takes n/(n−1) of it. At
    the deepest layer of a small batch (8 values per channel) the two
    differ by 8/7. Eval mode is torch's.

    Inside :func:`~wsiseg_tpu_torch.parallel.comm.data_parallel` over
    several ranks, the batch's moments are global, as under JAX's mesh:
    mean and variance from the all-reduced Σx, Σx² and count, as flax's
    ``use_fast_variance`` computes them (E[x²] − E[x]², at least 0)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        if comm.world() > 1:
            return self._global(x)
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

    def _global(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the data group's ranks: the global batch's
        moments (:class:`_GlobalBatchNorm`), flax's running update. Every
        rank holds a row, so the global count is at least 2."""
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias,
                                              self.eps, comm.data_group())
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(
                m * mean.to(self.running_mean.dtype))
            self.running_var.mul_(1.0 - m).add_(
                m * var.to(self.running_var.dtype))
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


class _GlobalBatchNorm(torch.autograd.Function):
    """Batch normalization with the moments of the global batch: mean and
    variance from the all-reduced Σx, Σx² and count, as flax's
    ``use_fast_variance`` computes them (E[x²] − E[x]², at least 0), in
    at least float32. It keeps only x and the per-channel statistics for
    the backward, which takes the global Σdy and Σdy·x̂ in one all-reduce
    (the backward of the moments' all-reduce), as autograd through
    ``comm.global_sum`` would; the affine gradients stay this rank's (the
    step all-reduces every parameter's). Returns (y in x's dtype, mean,
    variance), the last two without gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        dt = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(dt)
        dims = [d for d in range(x.ndim) if d != 1]
        count = torch.full((1,), x.numel() // c, dtype=dt, device=x.device)
        stats = torch.cat([xf.sum(dims), (xf * xf).sum(dims), count])
        comm.all_reduce(stats, group)
        n = stats[-1]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        shape = (1, c) + (1,) * (x.ndim - 2)
        y = (xf - mean.view(shape)) * invstd.view(shape)
        y = (y * weight.view(shape) + bias.view(shape)).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        dt = mean.dtype
        shape = (1, c) + (1,) * (x.ndim - 2)
        dims = [d for d in range(x.ndim) if d != 1]
        xhat = (x.to(dt) - mean.view(shape)) * invstd.view(shape)
        g = dy.to(dt)
        local = torch.cat([g.sum(dims), (g * xhat).sum(dims)])
        sums = local.clone()
        comm.all_reduce(sums, ctx.group)
        dx = (g - (sums[:c] / n).view(shape)
              - xhat * (sums[c:] / n).view(shape)) \
            * (invstd * weight.to(dt)).view(shape)
        return (dx.to(x.dtype), local[c:].to(weight.dtype),
                local[:c].to(weight.dtype), None, None)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride, bias=False),
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
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, cout, 1, bias=False)
        self.bn3 = BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride, bias=False),
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
    """Raise ``ValueError`` for an encoder the port lacks (the ResNets, the
    Mix Transformers of :mod:`.mit` and the Swin Transformers of
    :mod:`.swin`)."""
    known = tuple(ENCODER_SPECS) + tuple(MIT_SPECS) + tuple(SWIN_SPECS)
    if arch not in known:
        raise ValueError(f"unknown encoder {arch!r}; expected one of "
                         f"{known}")


def is_bottleneck(arch: str) -> bool:
    check_arch(arch)
    return arch in ENCODER_SPECS and ENCODER_SPECS[arch][0] is Bottleneck


def encoder_out_channels(arch: str) -> Tuple[int, ...]:
    """Deepest-first channel counts of the returned pyramid."""
    check_arch(arch)
    if arch in MIT_SPECS:
        return mit_out_channels(arch)
    if arch in SWIN_SPECS:
        return swin_out_channels(arch)
    e = ENCODER_SPECS[arch][0].expansion
    return (512 * e, 256 * e, 128 * e, 64 * e, 64)


class ResNetEncoder(nn.Module):
    """Returns [c5, c4, c3, c2, c1]: strides /32, /16, /8, /4, /2."""

    def __init__(self, arch: str = "resnet18"):
        super().__init__()
        check_arch(arch)
        block_cls, stages = ENCODER_SPECS[arch]
        self.arch = arch
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
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
        """On stripes (``parallel.spatial``) each stage runs as the plan
        holds its level: its input gathered first where that level runs
        on whole maps; the plan comes back with the features (a
        ``spatial.Pyramid``)."""
        stages = [lambda x: F.relu(self.bn1(self.conv1(x))),
                  lambda x: self.layer1(spatial.max_pool2d(x, 3, 2, 1)),
                  self.layer2, self.layer3, self.layer4]
        feats = []
        if comm.space() is None:
            for stage in stages:
                x = stage(x)
                feats.append(x)
            return feats[::-1]
        levels = spatial.plan(x.shape[2])
        for level, stage in enumerate(stages, 1):
            x = spatial.settle(x, levels, level - 1, level)
            with spatial.at(levels, level):
                x = stage(x)
            feats.append(x)
        return spatial.Pyramid(feats[::-1], levels)
