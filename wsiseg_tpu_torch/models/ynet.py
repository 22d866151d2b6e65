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
path (:mod:`.infer_fast`) is held against.
"""

from __future__ import annotations

from typing import Dict

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

    def segment(self, x: torch.Tensor) -> torch.Tensor:
        """encoder → decoder → seg head: (B, num_classes, H, W) float32."""
        return self._seg(self.encoder(x))


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
