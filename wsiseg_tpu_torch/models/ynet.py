"""Y-Net: shared ResNet encoder + decoder (Unet, Linknet, FPN or PSPNet)
+ classifier/regressor heads — counterpart of ``wsiseg_tpu/models/ynet.py``.
SegFormer's Mix Transformer encoder (:mod:`.mit`, ``mit_b5``) serves under
FPN only, as smp pairs them, and the Swin Transformer (:mod:`.swin`,
``swin_b``) under UPerNet only, as the Swin paper pairs them; the JAX
package has no counterpart of either.

Submodule names are smp's (``encoder``, ``decoder``,
``segmentation_head``) plus the reference's monkey-patched heads
(``classifier``, ``regressor``), so the state_dict uses exactly the keys
``wsiseg_tpu.models.torch_import.convert_ynet_state_dict`` reads. The
head is the flax decoder's ``seg_head``: a 3×3 conv for Unet (16 → nc)
and Linknet (32 → nc), a 1×1 conv for FPN (128 → nc), PSPNet (512 → nc)
and UPerNet (512 → nc, mmsegmentation's ``conv_seg``), whose logits are
then resized bilinearly (JAX ``jax.image.resize`` semantics) by 4, 32 and
4 to the input size.

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
                                              PSPDecoder, UPerNetDecoder)
from wsiseg_tpu_torch.models.heads import Classifier, Regressor, at_least_f32
from wsiseg_tpu_torch.models.mit import MiTEncoder, is_mit
from wsiseg_tpu_torch.models.resnet import ResNetEncoder, \
    encoder_out_channels
from wsiseg_tpu_torch.models.swin import SwinEncoder, is_swin
from wsiseg_tpu_torch.models.unet import UNetDecoder
from wsiseg_tpu_torch.parallel import spatial
from wsiseg_tpu_torch.parallel.spatial import Conv2d

#: decoder family → (head input channels, head kernel size, bilinear
#: upsample of the head's logits)
HEADS = {"Unet": (16, 3, 1), "Linknet": (32, 3, 1), "FPN": (128, 1, 4),
         "PSPNet": (512, 1, 32), "UPerNet": (512, 1, 4)}


class YNet(nn.Module):
    def __init__(self, arch: str = "resnet18", num_classes: int = 4,
                 num_reg_outputs: int = 1, model_name: str = "Unet"):
        super().__init__()
        if model_name not in HEADS:
            raise ValueError(f"unknown decoder {model_name!r}; expected one "
                             f"of {tuple(HEADS)}")
        if is_mit(arch) and model_name != "FPN":
            raise ValueError(f"{arch} serves under FPN only (smp's pairing; "
                             f"it has no stride-2 level), not {model_name}")
        if is_swin(arch) != (model_name == "UPerNet"):
            raise ValueError(f"swin_b serves under UPerNet and UPerNet on "
                             f"swin_b only (the Swin paper's pairing), not "
                             f"{model_name} on {arch}")
        self.arch = arch
        self.model_name = model_name
        self.num_classes = num_classes
        enc_ch = encoder_out_channels(arch)
        self.encoder = (MiTEncoder(arch) if is_mit(arch) else
                        SwinEncoder(arch) if is_swin(arch) else
                        ResNetEncoder(arch))
        self.decoder = {"Unet": UNetDecoder, "Linknet": LinknetDecoder,
                        "FPN": FPNDecoder, "PSPNet": PSPDecoder,
                        "UPerNet": UPerNetDecoder}[model_name](enc_ch)
        cin, k, self.head_upsample = HEADS[model_name]
        self.segmentation_head = nn.Sequential(
            Conv2d(cin, num_classes, k, 1, k // 2))
        self.classifier = Classifier(enc_ch[0], num_classes)
        self.regressor = Regressor(enc_ch[0], num_reg_outputs)

    def _seg(self, feats) -> torch.Tensor:
        """The seg logits; on stripes under spatial training (the head
        and its upsample run where the decoder's output is held)."""
        x = self.decoder(feats)
        level, levels = self.decoder.out_level, spatial.levels_of(feats)
        with spatial.at(levels, level):
            y = self.segmentation_head(x)
            if self.head_upsample > 1:
                y = spatial.upsample_linear(y, self.head_upsample)
        return at_least_f32(spatial.settle(y, levels, level, 0))

    def _heads(self, feats, *names: str):
        """The named heads on the pyramid's c5, held as its level is (a
        stripe's GAP is the space group's mean)."""
        with spatial.at(spatial.levels_of(feats), 5):
            return [getattr(self, n)(feats[0]) for n in names]

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Full three-head forward. x: (B, 3, H, W) normalized float. In
        train mode (``model.train()``) every BatchNorm normalizes with the
        batch's statistics and updates its running ones as flax does
        (:class:`~wsiseg_tpu_torch.models.resnet.BatchNorm2d`); every
        decoder family trains through this native forward."""
        feats = self.encoder(x)
        cls, reg = self._heads(feats, "classifier", "regressor")
        return {"seg": self._seg(feats), "cls": cls, "reg": reg}

    def encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The encoder's pyramid [c5, c4, c3, c2, c1]."""
        return self.encoder(x)

    def segment(self, x: torch.Tensor) -> torch.Tensor:
        """encoder → decoder → seg head: (B, num_classes, H, W) float32
        (float64 for an f64 model)."""
        return self._seg(self.encoder(x))

    def classify(self, x: torch.Tensor) -> torch.Tensor:
        """encoder → classifier: (B, num_classes) float32 logits."""
        return self._heads(self.encoder(x), "classifier")[0]

    def regress(self, x: torch.Tensor) -> torch.Tensor:
        """encoder → regressor: (B, num_reg_outputs) float32."""
        return self._heads(self.encoder(x), "regressor")[0]


class FlaxBatchNorm(nn.Module):
    """Inference BatchNorm as flax applies it to an input in a low
    precision: ``(x - mean) · scale/sqrt(var + eps) + bias`` in f32 (the
    statistics are f32, so flax's arithmetic promotes), the result rounded
    to ``dtype`` (flax's ``norm_dtype``; default: the input's dtype)."""

    def __init__(self, bn: nn.BatchNorm2d, dtype=None):
        super().__init__()
        self.dtype = dtype
        with torch.no_grad():
            self.register_buffer("mean", bn.running_mean.float().view(
                1, -1, 1, 1).clone())
            self.register_buffer("mul", (torch.rsqrt(
                bn.running_var.float() + bn.eps)
                * bn.weight.float()).view(1, -1, 1, 1))
            self.register_buffer("bias", bn.bias.float().view(
                1, -1, 1, 1).clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ((x.float() - self.mean) * self.mul + self.bias).to(
            self.dtype or x.dtype)


@torch.no_grad()
def compute_copy(model: YNet, dtype: torch.dtype) -> YNet:
    """A frozen copy of ``model`` for tile batches in ``dtype`` — the JAX
    grid path runs the flax Y-Net in ``cfg.compute_dtype``: conv and dense
    weights in ``dtype`` (each conv's output rounded to ``dtype``, as
    flax's), each BatchNorm a :class:`FlaxBatchNorm`, conv weights in
    ``channels_last``; a MiT or Swin encoder's LayerNorms in ``dtype`` too (their
    statistics are float32 whatever the operands). Feed it inputs in
    ``dtype``."""
    m = copy.deepcopy(model)
    for mod in list(m.modules()):
        for name, child in list(mod.named_children()):
            if isinstance(child, nn.BatchNorm2d):
                setattr(mod, name, FlaxBatchNorm(child))
    for mod in m.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear, nn.LayerNorm)):
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
    return lecun_init(build_ynet(cfg), generator)


@torch.no_grad()
def lecun_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default init of every conv and linear of ``model`` in
    place, drawn from ``generator`` (truncated LeCun-normal kernels, zero
    biases; BatchNorm keeps torch's identity init). Returns the model in
    eval mode."""
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
