"""Y-Net: shared ResNet encoder + decoder (Unet, Linknet, FPN or PSPNet)
+ classifier/regressor heads — counterpart of ``wsiseg_tpu/models/ynet.py``.

Submodule names are smp's (``encoder``, ``decoder``,
``segmentation_head``) plus the reference's monkey-patched heads
(``classifier``, ``regressor``), so the state_dict uses exactly the keys
``wsiseg_tpu.models.torch_import.convert_ynet_state_dict`` reads. The
head is the flax decoder's ``seg_head``: a 3×3 conv for Unet (16 → nc)
and Linknet (32 → nc), a 1×1 conv for FPN (128 → nc) and PSPNet
(512 → nc), whose logits are then resized bilinearly (JAX
``jax.image.resize`` semantics) by 4 and by 32 to the input size.

:meth:`YNet.segment` is the plain eager forward — the CPU oracle the fast
path (:mod:`.infer_fast`) is held against. :meth:`YNet.encode` and
:meth:`YNet.classify` are the encoder-only entries of the grid and cls
modes (reference utils/eval.py:196-200), :meth:`YNet.regress` the patch
regressor's (the TTA evaluators). :func:`compute_copy` gives the
same model in a compute dtype for tile batches, rounded where the flax
modules applied in that dtype round.
"""

from __future__ import annotations

import copy
from typing import Dict, List

import torch
from torch import nn

from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.models.decoders import (FPNDecoder, LinknetDecoder,
                                              PSPDecoder, resize_linear)
from wsiseg_tpu_torch.models.heads import Classifier, Regressor
from wsiseg_tpu_torch.models.resnet import ResNetEncoder, \
    encoder_out_channels
from wsiseg_tpu_torch.models.unet import UNetDecoder

#: decoder family → (head input channels, head kernel size, bilinear
#: upsample of the head's logits)
HEADS = {"Unet": (16, 3, 1), "Linknet": (32, 3, 1), "FPN": (128, 1, 4),
         "PSPNet": (512, 1, 32)}


class YNet(nn.Module):
    def __init__(self, arch: str = "resnet18", num_classes: int = 4,
                 num_reg_outputs: int = 1, model_name: str = "Unet"):
        super().__init__()
        if model_name not in HEADS:
            raise ValueError(f"unknown decoder {model_name!r}; expected one "
                             f"of {tuple(HEADS)}")
        self.arch = arch
        self.model_name = model_name
        self.num_classes = num_classes
        enc_ch = encoder_out_channels(arch)
        self.encoder = ResNetEncoder(arch)
        self.decoder = {"Unet": UNetDecoder, "Linknet": LinknetDecoder,
                        "FPN": FPNDecoder, "PSPNet": PSPDecoder}[model_name](
                            enc_ch)
        cin, k, self.head_upsample = HEADS[model_name]
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(cin, num_classes, k, 1, k // 2))
        self.classifier = Classifier(enc_ch[0], num_classes)
        self.regressor = Regressor(enc_ch[0], num_reg_outputs)

    def _seg(self, feats) -> torch.Tensor:
        y = self.segmentation_head(self.decoder(feats))
        f = self.head_upsample
        if f > 1:
            y = resize_linear(y, f * y.shape[2], f * y.shape[3])
        return y.float()

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Full three-head forward. x: (B, 3, H, W) normalized float."""
        feats = self.encoder(x)
        return {"seg": self._seg(feats), "cls": self.classifier(feats[0]),
                "reg": self.regressor(feats[0])}

    def encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The encoder's pyramid [c5, c4, c3, c2, c1]."""
        return self.encoder(x)

    def segment(self, x: torch.Tensor) -> torch.Tensor:
        """encoder → decoder → seg head: (B, num_classes, H, W) float32."""
        return self._seg(self.encoder(x))

    def classify(self, x: torch.Tensor) -> torch.Tensor:
        """encoder → classifier: (B, num_classes) float32 logits."""
        return self.classifier(self.encoder(x)[0])

    def regress(self, x: torch.Tensor) -> torch.Tensor:
        """encoder → regressor: (B, num_reg_outputs) float32."""
        return self.regressor(self.encoder(x)[0])


class FlaxBatchNorm(nn.Module):
    """Inference BatchNorm as flax applies it to an input in a low
    precision: ``(x - mean) · scale/sqrt(var + eps) + bias`` in f32 (the
    statistics are f32, so flax's arithmetic promotes), the result rounded
    to the input's dtype."""

    def __init__(self, bn: nn.BatchNorm2d):
        super().__init__()
        with torch.no_grad():
            self.register_buffer("mean", bn.running_mean.float().view(
                1, -1, 1, 1).clone())
            self.register_buffer("mul", (torch.rsqrt(
                bn.running_var.float() + bn.eps)
                * bn.weight.float()).view(1, -1, 1, 1))
            self.register_buffer("bias", bn.bias.float().view(
                1, -1, 1, 1).clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ((x.float() - self.mean) * self.mul + self.bias).to(x.dtype)


@torch.no_grad()
def compute_copy(model: YNet, dtype: torch.dtype) -> YNet:
    """A frozen copy of ``model`` for tile batches in ``dtype`` — the JAX
    grid path runs the flax Y-Net in ``cfg.compute_dtype``: conv and dense
    weights in ``dtype`` (each conv's output rounded to ``dtype``, as
    flax's), each BatchNorm a :class:`FlaxBatchNorm`, conv weights in
    ``channels_last``. Feed it inputs in ``dtype``."""
    m = copy.deepcopy(model)
    for mod in list(m.modules()):
        for name, child in list(mod.named_children()):
            if isinstance(child, nn.BatchNorm2d):
                setattr(mod, name, FlaxBatchNorm(child))
    for mod in m.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            mod.to(dtype)
    m = m.to(memory_format=torch.channels_last).eval()
    return m.requires_grad_(False)


def build_ynet(cfg: Config) -> YNet:
    return YNet(arch=cfg.arch_encoder, num_classes=cfg.num_classes,
                model_name=cfg.model_name)


@torch.no_grad()
def init_ynet(cfg: Config, generator: torch.Generator) -> YNet:
    """A Y-Net with random weights drawn from ``generator`` only (flax's
    defaults: LeCun-normal kernels, zero biases, identity BatchNorm), in
    eval mode."""
    model = build_ynet(cfg)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            # variance 1/fan_in after truncation at ±2σ (the constant is
            # the std of a unit normal truncated there)
            std = (1.0 / m.weight[0].numel()) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
    return model.eval()
