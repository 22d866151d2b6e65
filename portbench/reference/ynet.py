"""The plain reference Y-Net: a ResNet encoder (torchvision's
ResNet-18/50, He et al., arXiv:1512.03385), a Unet (smp) or FPN
(Kirillov et al., arXiv:1901.02446) decoder, a segmentation head, and the
classifier and regressor heads of acproject/wsi-segmentation-pipeline.

Plain ``torch.nn`` modules in float32, no kernels, no layout tricks. The
parameter names are smp's and torchvision's, so one state dict loads into
this model and into the program's. Departures from smp, as the program
defines the model (and written down in PERF.md):

- FPN: each segmentation-block conv is followed by BatchNorm, not
  GroupNorm; the top-down path and the segmentation blocks upsample by
  nearest 2×; the 1×1 head's logits are upsampled ×4 bilinearly with
  half-pixel centres (``align_corners=False``).
- Unet: the decoder upsamples by nearest 2× and concatenates the skip, as
  smp does; the head is a 3×3 conv with bias.

Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

STAGES = {"resnet18": ("basic", (2, 2, 2, 2)),
          "resnet34": ("basic", (3, 4, 6, 3)),
          "resnet50": ("bottleneck", (3, 4, 6, 3))}


def conv(cin: int, cout: int, k: int, stride: int = 1,
         bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=bias)


class Basic(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = conv(cin, planes, 3, stride)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = (nn.Sequential(conv(cin, planes, 1, stride),
                                         nn.BatchNorm2d(planes))
                           if stride != 1 or cin != planes else None)
        self.out = planes

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        s = x if self.downsample is None else self.downsample(x)
        return F.relu(y + s)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        out = 4 * planes
        self.conv1 = conv(cin, planes, 1)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3, stride)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = conv(planes, out, 1)
        self.bn3 = nn.BatchNorm2d(out)
        self.downsample = (nn.Sequential(conv(cin, out, 1, stride),
                                         nn.BatchNorm2d(out))
                           if stride != 1 or cin != out else None)
        self.out = out

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        s = x if self.downsample is None else self.downsample(x)
        return F.relu(y + s)


class Encoder(nn.Module):
    """Returns [c5, c4, c3, c2, c1] (strides 32, 16, 8, 4, 2)."""

    def __init__(self, arch: str):
        super().__init__()
        kind, stages = STAGES[arch]
        block = Basic if kind == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for i, n in enumerate(stages):
            blocks = []
            for j in range(n):
                b = block(cin, 64 * 2 ** i, 2 if i > 0 and j == 0 else 1)
                blocks.append(b)
                cin = b.out
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.channels = [cin, cin // 2, cin // 4, cin // 8, 64]

    def forward(self, x) -> List[torch.Tensor]:
        c1 = F.relu(self.bn1(self.conv1(x)))
        c2 = self.layer1(F.max_pool2d(c1, 3, 2, 1))
        c3 = self.layer2(c2)
        c4 = self.layer3(c3)
        c5 = self.layer4(c4)
        return [c5, c4, c3, c2, c1]


def conv_bn_relu(cin: int, cout: int, k: int = 3) -> nn.Sequential:
    return nn.Sequential(conv(cin, cout, k), nn.BatchNorm2d(cout),
                         nn.ReLU())


class UnetBlock(nn.Module):
    def __init__(self, cin: int, cskip: int, cout: int):
        super().__init__()
        self.conv1 = conv_bn_relu(cin + cskip, cout)
        self.conv2 = conv_bn_relu(cout, cout)

    def forward(self, x, skip=None):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class UnetDecoder(nn.Module):
    def __init__(self, enc: Sequence[int],
                 channels: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__()
        ins = [enc[0]] + list(channels[:-1])
        skips = list(enc[1:]) + [0]
        self.blocks = nn.ModuleList(UnetBlock(i, s, o) for i, s, o in
                                    zip(ins, skips, channels))
        self.out = channels[-1]

    def forward(self, feats):
        x = feats[0]
        for block, skip in zip(self.blocks, list(feats[1:]) + [None]):
            x = block(x, skip)
        return x


class FPNSeg(nn.Module):
    def __init__(self, cin: int, n_up: int, ch: int = 128):
        super().__init__()
        self.n_up = n_up
        for k in range(max(n_up, 1)):
            setattr(self, f"conv{k}", nn.Sequential(
                conv(cin if k == 0 else ch, ch, 3), nn.BatchNorm2d(ch)))

    def forward(self, x):
        for k in range(max(self.n_up, 1)):
            x = F.relu(getattr(self, f"conv{k}")(x))
            if k < self.n_up:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
        return x


class FPNDecoder(nn.Module):
    def __init__(self, enc: Sequence[int], pyramid: int = 256,
                 seg: int = 128):
        super().__init__()
        for n, c in zip((5, 4, 3, 2), enc[:4]):
            setattr(self, f"lat{n}", nn.Conv2d(c, pyramid, 1))
            setattr(self, f"seg{n}", FPNSeg(pyramid, n - 2, seg))
        self.out = seg

    def forward(self, feats):
        p = out = None
        for n, c in zip((5, 4, 3, 2), feats[:4]):
            lat = getattr(self, f"lat{n}")(c)
            p = lat if p is None else lat + F.interpolate(
                p, scale_factor=2, mode="nearest")
            s = getattr(self, f"seg{n}")(p)
            out = s if out is None else out + s
        return out


class Head(nn.Module):
    """Segmentation head: a k×k conv to the classes, then a bilinear
    upsample by ``up`` (FPN: 4)."""

    def __init__(self, cin: int, nc: int, k: int, up: int):
        super().__init__()
        self.add_module("0", nn.Conv2d(cin, nc, k, 1, k // 2))
        self.up = up

    def forward(self, x):
        y = getattr(self, "0")(x)
        if self.up > 1:
            y = F.interpolate(y, scale_factor=self.up, mode="bilinear",
                              align_corners=False)
        return y


class YNet(nn.Module):
    def __init__(self, arch: str, decoder: str, num_classes: int = 4,
                 num_reg: int = 1):
        super().__init__()
        self.encoder = Encoder(arch)
        enc = self.encoder.channels
        if decoder == "Unet":
            self.decoder = UnetDecoder(enc)
            self.segmentation_head = Head(self.decoder.out, num_classes, 3, 1)
        elif decoder == "FPN":
            self.decoder = FPNDecoder(enc)
            self.segmentation_head = Head(self.decoder.out, num_classes, 1, 4)
        else:
            raise ValueError(f"no reference for decoder {decoder!r}")
        self.classifier = nn.Module()
        self.classifier.fc = nn.Sequential(nn.Linear(enc[0], num_classes))
        self.regressor = nn.Module()
        self.regressor.fc = nn.Sequential(
            nn.Linear(enc[0], enc[0] // 4), nn.ReLU(),
            nn.Linear(enc[0] // 4, num_reg))

    def segment(self, x) -> torch.Tensor:
        return self.segmentation_head(self.decoder(self.encoder(x)))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        feats = self.encoder(x)
        pooled = feats[0].mean(dim=(2, 3))
        return {"seg": self.segmentation_head(self.decoder(feats)),
                "cls": self.classifier.fc(pooled),
                "reg": self.regressor.fc(pooled)}


def build(cfg: Dict) -> nn.Module:
    """The reference model of a configuration file's dict. A configuration
    whose family this module lacks names its own reference module under
    ``"reference"`` (a module with a ``build(cfg)``), added as a new
    file."""
    other = cfg.get("reference", __name__)
    if other != __name__:
        import importlib
        return importlib.import_module(other).build(cfg)
    return YNet(cfg["arch_encoder"], cfg["model_name"], cfg["num_classes"])
