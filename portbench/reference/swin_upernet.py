"""The plain reference Swin-UPerNet Y-Net: the Swin Transformer Swin-B
(Liu et al., ICCV 2021, arXiv:2103.14030; microsoft/Swin-Transformer, as
SwinTransformer/Swin-Transformer-Semantic-Segmentation
``mmseg/models/backbones/swin_transformer.py`` runs it, config
``upernet_swin_base_patch4_window12_512x512_160k_ade20k_pretrain_384x384_22K``)
under UPerNet's head (Xiao et al., ECCV 2018, arXiv:1807.10221;
mmsegmentation's ``UPerHead``), with the Y-Net classifier and regressor.

Plain ``torch.nn`` modules in float32, written as the published codes
write them:

- patch embedding: a 4×4/4 conv 3 → 128 (sides zero-padded to multiples
  of 4), LayerNorm;
- four stages of 2, 2, 18, 2 blocks at 128, 256, 512, 1024 channels with
  4, 8, 16, 32 heads of 32; each block ``x += proj(WMSA(LN(x)))``,
  ``x += fc2(GELU(fc1(LN(x))))`` (MLP ratio 4, exact GELU, LayerNorm eps
  1e-5);
- WMSA: after ``norm1`` the map is zero-padded at the bottom and right to
  multiples of 12 (the padded tokens stay keys, unmasked), rolled by
  (−6, −6) on odd blocks, cut into 12×12 windows; in each window
  ``softmax(q kᵀ·32^-½ + B + M) v`` with ``qkv`` biased, ``B`` the
  relative position bias gathered from a 23² × heads table and ``M`` the
  shift mask (−100 between tokens of different regions of the rolled
  map, built over the whole padded map as ``BasicLayer`` builds it, for
  every window); then the windows are put back, rolled back and cropped;
- patch merging between stages: [x0::2,0::2; x1::2,0::2; x0::2,1::2;
  x1::2,1::2] concatenated (zero-padded to even sides), LayerNorm(4C),
  Linear(4C → 2C) without bias;
- a LayerNorm on each stage's output (``norm0..3``);
- UPerHead at 512 channels: a pyramid pooling module on c5
  (``nn.AdaptiveAvgPool2d`` to 1, 2, 3 and 6 bins, 1×1 conv + BN + ReLU,
  bilinear back with ``align_corners=False``), its concat with c5 through
  a 3×3 conv + BN + ReLU (``bottleneck``); 1×1 lateral convs on c2-c4,
  top-down bilinear adds; 3×3 FPN convs; every level resized to c2's size
  and concatenated (2048 channels), a 3×3 ``fpn_bottleneck``, the 1×1
  ``conv_seg``; the logits ×4 bilinear to the input (``align_corners=
  False``).

The attention is computed a block of windows at a time so that a whole
slide fits: stage 1 of a 3072×4096 slide has 5,504 windows of 4 heads,
whose float32 scores alone are 1.83 GB.

Departures from the published description:

- BatchNorm in place of SyncBN (in eval mode the same function);
- the Y-Net's classifier and regressor read c5 (1024 channels), as on
  every family; no auxiliary FCN head (it is training-only in the
  published config, and the program trains without it too);
- 4 classes, not ADE20K's 150; no dropout before ``conv_seg``, no
  stochastic depth (inference);
- weights are random from the seed, not an ImageNet-22K or ADE20K
  checkpoint.

Parameter names are Microsoft's under ``encoder.`` and mmsegmentation's
``UPerHead`` names under ``decoder.`` (each conv + BN a ``Sequential``),
the head ``segmentation_head.0``, so one state dict loads into this model
and into the program's. Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.ynet import Head

#: published widths, by encoder name
SPECS = {"swin_b": {"dim": 128, "depths": (2, 2, 18, 2),
                    "heads": (4, 8, 16, 32), "window": 12, "patch": 4,
                    "mlp_ratio": 4}}
#: bytes of float32 scores the attention holds at once
SCORE_BYTES = 1 << 30


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, ws, ws, C), Microsoft's order."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int,
                   w: int) -> torch.Tensor:
    """(B·nW, ws, ws, C) → (B, H, W, C)."""
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def relative_position_index(ws: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                        indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0)
    rel = rel.contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shift_mask(hp: int, wp: int, ws: int, shift: int,
               device) -> torch.Tensor:
    """(nW, N, N): −100 between tokens of different regions of the rolled
    padded map, 0 elsewhere (``BasicLayer.forward``)."""
    img = torch.zeros((1, hp, wp, 1), device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = window_partition(img, ws).view(-1, ws * ws)
    m = mw.unsqueeze(1) - mw.unsqueeze(2)
    return m.masked_fill(m != 0, -100.0).masked_fill(m == 0, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """(B·nW, N, C) windows; ``mask`` (nW, N, N) or None."""
        bw, n, c = x.shape
        qkv = self.qkv(x).reshape(bw, n, 3, self.heads, c // self.heads) \
            .permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        idx = relative_position_index(self.ws).to(x.device)
        bias = self.relative_position_bias_table[idx.view(-1)].view(
            n, n, -1).permute(2, 0, 1)
        out = torch.empty_like(q)
        step = max(1, SCORE_BYTES // (4 * self.heads * n * n))
        nw = 1 if mask is None else mask.shape[0]
        step = max(nw, step - step % nw)
        for s in range(0, bw, step):
            attn = q[s:s + step] @ k[s:s + step].transpose(-2, -1)
            attn = attn + bias[None]
            if mask is not None:
                m = attn.shape[0]
                attn = attn.view(m // nw, nw, self.heads, n, n) \
                    + mask[None, :, None]
                attn = attn.view(-1, self.heads, n, n)
            out[s:s + step] = torch.softmax(attn, dim=-1) @ v[s:s + step]
            del attn
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int, shift: int,
                 ratio: int):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, ws)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, dim * ratio)

    def forward(self, x, h: int, w: int, mask):
        b, _, c = x.shape
        shortcut = x
        x = self.norm1(x).view(b, h, w, c)
        pad_r, pad_b = (self.ws - w % self.ws) % self.ws, \
            (self.ws - h % self.ws) % self.ws
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = x.shape[1:3]
        if self.shift > 0:
            x = torch.roll(x, shifts=(-self.shift, -self.shift), dims=(1, 2))
            attn_mask = mask
        else:
            attn_mask = None
        win = window_partition(x, self.ws).view(-1, self.ws * self.ws, c)
        win = self.attn(win, attn_mask).view(-1, self.ws, self.ws, c)
        x = window_reverse(win, self.ws, hp, wp)
        if self.shift > 0:
            x = torch.roll(x, shifts=(self.shift, self.shift), dims=(1, 2))
        x = x[:, :h, :w, :].contiguous().view(b, h * w, c)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, h: int, w: int):
        b, _, c = x.shape
        x = x.view(b, h, w, c)
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x.view(b, -1, 4 * c)))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, ws: int,
                 ratio: int, downsample: bool):
        super().__init__()
        self.ws = ws
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, ws, 0 if i % 2 == 0 else ws // 2, ratio)
            for i in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x, h: int, w: int):
        hp = -(-h // self.ws) * self.ws
        wp = -(-w // self.ws) * self.ws
        mask = shift_mask(hp, wp, self.ws, self.ws // 2, x.device)
        for blk in self.blocks:
            x = blk(x, h, w, mask)
        if self.downsample is None:
            return x, x, h, w
        return x, self.downsample(x, h, w), (h + 1) // 2, (w + 1) // 2


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(3, dim, patch, patch)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x):
        _, _, h, w = x.shape
        if w % self.patch:
            x = F.pad(x, (0, self.patch - w % self.patch))
        if h % self.patch:
            x = F.pad(x, (0, 0, 0, self.patch - h % self.patch))
        x = self.proj(x)
        wh, ww = x.shape[2:]
        return self.norm(x.flatten(2).transpose(1, 2)), wh, ww


class SwinTransformer(nn.Module):
    """Returns [c5, c4, c3, c2] (strides 32, 16, 8, 4)."""

    def __init__(self, arch: str):
        super().__init__()
        spec = SPECS[arch]
        d = spec["dim"]
        self.patch_embed = PatchEmbed(spec["patch"], d)
        self.layers = nn.ModuleList(
            BasicLayer(d * 2 ** i, spec["depths"][i], spec["heads"][i],
                       spec["window"], spec["mlp_ratio"], i < 3)
            for i in range(4))
        for i in range(4):
            setattr(self, f"norm{i}", nn.LayerNorm(d * 2 ** i))
        self.channels = [d * 8, d * 4, d * 2, d]

    def forward(self, x) -> List[torch.Tensor]:
        x, h, w = self.patch_embed(x)
        outs = []
        for i, layer in enumerate(self.layers):
            out, x, h2, w2 = layer(x, h, w)
            out = getattr(self, f"norm{i}")(out)
            outs.append(out.view(-1, h, w, out.shape[-1])
                        .permute(0, 3, 1, 2).contiguous())
            h, w = h2, w2
        return outs[::-1]


def conv_module(cin: int, cout: int, k: int) -> nn.Sequential:
    """mmcv's ``ConvModule`` with a norm: conv without bias, BN (ReLU
    applied by the caller)."""
    return nn.Sequential(nn.Conv2d(cin, cout, k, 1, k // 2, bias=False),
                         nn.BatchNorm2d(cout))


def resize(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


class UPerHead(nn.Module):
    """mmsegmentation's ``UPerHead`` up to ``conv_seg``."""

    def __init__(self, in_channels: List[int], channels: int = 512,
                 pool_scales=(1, 2, 3, 6)):
        super().__init__()
        self.pool_scales = pool_scales
        self.psp_modules = nn.ModuleList(
            conv_module(in_channels[-1], channels, 1) for _ in pool_scales)
        self.bottleneck = conv_module(
            in_channels[-1] + len(pool_scales) * channels, channels, 3)
        self.lateral_convs = nn.ModuleList(
            conv_module(c, channels, 1) for c in in_channels[:-1])
        self.fpn_convs = nn.ModuleList(
            conv_module(channels, channels, 3) for _ in in_channels[:-1])
        self.fpn_bottleneck = conv_module(len(in_channels) * channels,
                                          channels, 3)
        self.out = channels

    def psp_forward(self, x):
        outs = [x]
        for scale, m in zip(self.pool_scales, self.psp_modules):
            y = F.relu(m(nn.AdaptiveAvgPool2d(scale)(x)))
            outs.append(resize(y, x.shape[2:]))
        return F.relu(self.bottleneck(torch.cat(outs, dim=1)))

    def forward(self, inputs: List[torch.Tensor]):
        """``inputs`` shallowest first: [c2, c3, c4, c5]."""
        laterals = [F.relu(conv(inputs[i]))
                    for i, conv in enumerate(self.lateral_convs)]
        laterals.append(self.psp_forward(inputs[-1]))
        n = len(laterals)
        for i in range(n - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize(
                laterals[i], laterals[i - 1].shape[2:])
        outs = [F.relu(self.fpn_convs[i](laterals[i])) for i in range(n - 1)]
        outs.append(laterals[-1])
        for i in range(n - 1, 0, -1):
            outs[i] = resize(outs[i], outs[0].shape[2:])
        return F.relu(self.fpn_bottleneck(torch.cat(outs, dim=1)))


class SwinUPerNetYNet(nn.Module):
    def __init__(self, arch: str, num_classes: int = 4, num_reg: int = 1):
        super().__init__()
        self.encoder = SwinTransformer(arch)
        enc = self.encoder.channels
        self.decoder = UPerHead(enc[::-1])
        self.segmentation_head = Head(self.decoder.out, num_classes, 1, 4)
        self.classifier = nn.Module()
        self.classifier.fc = nn.Sequential(nn.Linear(enc[0], num_classes))
        self.regressor = nn.Module()
        self.regressor.fc = nn.Sequential(
            nn.Linear(enc[0], enc[0] // 4), nn.ReLU(),
            nn.Linear(enc[0] // 4, num_reg))

    def segment(self, x) -> torch.Tensor:
        return self.segmentation_head(self.decoder(self.encoder(x)[::-1]))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        feats = self.encoder(x)
        pooled = feats[0].mean(dim=(2, 3))
        return {"seg": self.segmentation_head(self.decoder(feats[::-1])),
                "cls": self.classifier.fc(pooled),
                "reg": self.regressor.fc(pooled)}


def build(cfg: Dict) -> nn.Module:
    """The reference model of a configuration file's dict (its
    ``"reference"`` names this module), in eval mode: the pyramid pooling's
    1×1 bin has one value a channel and image, on which BatchNorm takes
    no batch statistics."""
    if cfg["model_name"] != "UPerNet":
        raise ValueError(f"no Swin reference for decoder "
                         f"{cfg['model_name']!r}")
    return SwinUPerNetYNet(cfg["arch_encoder"], cfg["num_classes"]).eval()
