"""Y-Net: shared ResNet encoder + U-Net decoder + classifier/regressor
heads — counterpart of ``wsiseg_tpu/models/ynet.py``.

Submodule names are smp's (``encoder``, ``decoder``,
``segmentation_head``) plus the reference's monkey-patched heads
(``classifier``, ``regressor``), so the state_dict uses exactly the keys
``wsiseg_tpu.models.torch_import.convert_ynet_state_dict`` reads.

:meth:`YNet.segment` is the plain eager forward — the CPU oracle the fast
path (:mod:`.infer_fast`) is held against.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from wsiseg_tpu.config import Config
from wsiseg_tpu_torch.models.heads import Classifier, Regressor
from wsiseg_tpu_torch.models.resnet import (NOT_PORTED, ResNetEncoder,
                                            encoder_out_channels)
from wsiseg_tpu_torch.models.unet import UNetDecoder


class YNet(nn.Module):
    def __init__(self, arch: str = "resnet18", num_classes: int = 4,
                 num_reg_outputs: int = 1, model_name: str = "Unet"):
        super().__init__()
        if model_name != "Unet":
            raise NotImplementedError(f"decoder {model_name!r} is "
                                      f"{NOT_PORTED}")
        self.arch = arch
        self.model_name = model_name
        self.num_classes = num_classes
        enc_ch = encoder_out_channels(arch)
        self.encoder = ResNetEncoder(arch)
        self.decoder = UNetDecoder(enc_ch)
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(16, num_classes, 3, 1, 1))
        self.classifier = Classifier(enc_ch[0], num_classes)
        self.regressor = Regressor(enc_ch[0], num_reg_outputs)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Full three-head forward. x: (B, 3, H, W) normalized float."""
        feats = self.encoder(x)
        seg = self.segmentation_head(self.decoder(feats)).float()
        return {"seg": seg, "cls": self.classifier(feats[0]),
                "reg": self.regressor(feats[0])}

    def segment(self, x: torch.Tensor) -> torch.Tensor:
        """encoder → decoder → seg head: (B, num_classes, H, W) float32."""
        return self.segmentation_head(
            self.decoder(self.encoder(x))).float()


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
