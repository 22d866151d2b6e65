"""Multi-patch region-ensemble ResNet — counterpart of
``wsiseg_tpu/models/ensemble.py`` (the reference's vendored
``resnets_shift.ResNet``, resnets_shift.py:111-217).

Input is (B, P, H, W, 3) normalized patches, channels last like JAX's: P
patches sampled from one region. The patches fold into the batch, one
(B·P, 3, H, W) trunk forward (an NCHW view of the channels-last bytes),
where the reference loops over P. Each patch is classified alone
(``fc0``) and the region from the concatenation of all P patches' GAP
features (``fc_1`` → ReLU → ``fc_2``). Returns (per_patch (B, P, C),
ensemble (B, C)), at least float32; per-patch logits come as (B, P, C)
where the reference concatenates them patch-major as (P·B, C)
(resnets_shift.py:217).

Under spatial training each space rank holds P/M of every region's
patches, whole (JAX shards the patch axis): the trunk, its GAP and
``fc0`` run on them as they are, and ``fc_1`` takes the features of all
P, gathered over the space group in patch order; ``per_patch`` then holds
this rank's patches.

:func:`compute_copy` gives the model for serving in a compute dtype,
rounded where the flax model applied in ``cfg.compute_dtype`` rounds.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.models.heads import at_least_f32
from wsiseg_tpu_torch.models.resnet import (ResNetEncoder,
                                            encoder_out_channels)
from wsiseg_tpu_torch.models.ynet import FlaxBatchNorm, lecun_init
from wsiseg_tpu_torch.parallel import comm, spatial

#: patches a region: HR_NUM_CNT_SAMPLES + HR_NUM_PERIM_SAMPLES
NUM_PATCHES = 16


def _dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax's Dense: the product in the weight's dtype, then the bias
    added in that dtype (two roundings in bf16, as flax's)."""
    return F.linear(x, lin.weight) + lin.bias


class MultiPatchResNet(nn.Module):
    def __init__(self, arch: str = "resnet18", num_classes: int = 4,
                 num_patches: int = NUM_PATCHES):
        super().__init__()
        self.arch = arch
        self.num_classes = num_classes
        self.num_patches = num_patches
        feat = encoder_out_channels(arch)[0]
        n = num_patches * feat
        self.trunk = ResNetEncoder(arch)
        self.fc0 = nn.Linear(feat, num_classes)
        # reference fc: Linear(n, n//2) → ReLU → Linear(n//2, C)
        # (resnets_shift.py:133-139)
        self.fc_1 = nn.Linear(n, n // 2)
        self.fc_2 = nn.Linear(n // 2, num_classes)

    def forward(self, xs: torch.Tensor):
        """xs: (B, P, H, W, 3) normalized patches → (per_patch (B, P, C),
        ensemble (B, C))."""
        b, p = xs.shape[:2]
        sp = comm.space()
        if p * (1 if sp is None else sp.size) != self.num_patches:
            raise ValueError(f"expected {self.num_patches} patches, got {p}"
                             + ("" if sp is None else
                                f" on each of {sp.size} space ranks"))
        x = xs.reshape(b * p, *xs.shape[2:]).permute(0, 3, 1, 2)
        with spatial.whole():
            c5 = self.trunk(x)[0]
        # GAP over the deepest stage in the dense layers' dtype, summed in
        # at least float32 (jnp.mean's accumulation) → (B·P, F)
        dt = self.fc0.weight.dtype
        acc = torch.promote_types(dt, torch.float32)
        f = c5.to(dt).mean(dim=(2, 3), dtype=acc).to(dt)
        per_patch = _dense(self.fc0, f).reshape(b, p, self.num_classes)
        every = spatial.gather_patches(f.reshape(b, p, -1), sp)
        y = F.relu(_dense(self.fc_1, every.reshape(b, -1)))
        return at_least_f32(per_patch), at_least_f32(_dense(self.fc_2, y))


class _CastIn(nn.Module):
    """A conv fed in its weight's dtype (flax's Conv promotes its input to
    the compute dtype)."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        self.conv = conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.to(self.conv.weight.dtype))


@torch.no_grad()
def compute_copy(model: MultiPatchResNet,
                 dtype: torch.dtype) -> MultiPatchResNet:
    """A frozen copy of ``model`` for serving in ``dtype``, as the JAX
    package applies ``MultiPatchResNet(dtype=cfg.compute_dtype)``: every
    conv and dense layer in ``dtype``, each conv fed its input rounded to
    ``dtype``, each BatchNorm a :class:`FlaxBatchNorm` with float32 output
    (``setup_hr`` passes no ``norm_dtype``, so flax's default float32
    stands), the GAP rounded to ``dtype``, conv weights ``channels_last``.
    Feed it float32 patches."""
    m = copy.deepcopy(model)
    for mod in list(m.modules()):
        for name, child in list(mod.named_children()):
            if isinstance(child, nn.BatchNorm2d):
                setattr(mod, name, FlaxBatchNorm(child, torch.float32))
            elif isinstance(child, nn.Conv2d):
                setattr(mod, name, _CastIn(child.to(dtype)))
    for lin in (m.fc0, m.fc_1, m.fc_2):
        lin.to(dtype)
    m = m.to(memory_format=torch.channels_last).eval()
    return m.requires_grad_(False)


def build_ensemble(cfg: Config) -> MultiPatchResNet:
    return MultiPatchResNet(arch=cfg.arch_encoder,
                            num_classes=cfg.num_classes)


@torch.no_grad()
def init_ensemble(cfg: Config,
                  generator: torch.Generator) -> MultiPatchResNet:
    """The ensemble with random weights drawn from ``generator`` only
    (flax's defaults, as :func:`~wsiseg_tpu_torch.models.ynet.init_ynet`
    draws them), in eval mode."""
    return lecun_init(build_ensemble(cfg), generator)
