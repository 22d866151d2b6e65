"""FPN / PSPNet / Linknet decoders (eval forwards) and the resize helpers
they share — counterpart of ``wsiseg_tpu/models/decoders.py`` — and
UPerNet's head, which the JAX package lacks (:class:`UPerNetDecoder`).

Each decoder consumes the deepest-first pyramid [c5, c4, c3, c2, c1] and
returns the activation its segmentation head reads; the head (and the
final bilinear upsample of FPN and PSPNet) sits on the Y-Net as
``segmentation_head``, where smp keeps it (:mod:`.ynet`). Parameter names
follow ``wsiseg_tpu.models.torch_import.convert_ynet_state_dict``:
``lat{n}``, ``seg{n}.conv{k}.{0,1}``, ``psp{b}.{0,1}``, ``fuse.{0,1}`` and
``blocks.{i}.conv{1,2,3}.{0,1}``; UPerNet's are mmsegmentation's
``UPerHead`` names (``psp_modules.{b}``, ``bottleneck``,
``lateral_convs.{i}``, ``fpn_convs.{i}``, ``fpn_bottleneck``), each a
``Sequential(conv, BatchNorm)``.

Resizes follow ``jax.image.resize``, not smp:

- :func:`resize_nearest`: exactly 2× is pixel repetition; any other size
  takes JAX's half-pixel source index ``floor((k + 0.5)·in/out)``
  (torch's ``nearest-exact``, not ``nearest``), computed in f32 as JAX
  does;
- :func:`resize_linear`: JAX ``method="linear"`` (``antialias=True``, its
  default): a triangle kernel in half-pixel coordinates, widened by
  in/out when downsampling, its weights normalised over the in-range
  taps, as per-axis weight matrices and two contractions. Where every
  resized axis upsamples, the widening does not apply and the function is
  ``F.interpolate(mode="bilinear", align_corners=False)``, which is used
  there (smp's ``UpsamplingBilinear2d`` is ``align_corners=True``: a
  different function).

The port trains Linknet through this decoder: the JAX package's train-only
``_S2dLinknetTailBlock`` is not ported (ROADMAP.md §3).

Under spatial training every conv runs on stripes where
``parallel.spatial``'s plan holds its level so, and a map is split where
it reaches such a level from a gathered one; each decoder names the
level of its output (``out_level``; PSPNet's None: its pooled bins are
global, so it gathers c5 and runs on whole maps).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wsiseg_tpu_torch.models.heads import at_least_f32
from wsiseg_tpu_torch.models.resnet import BatchNorm2d
from wsiseg_tpu_torch.parallel import spatial
from wsiseg_tpu_torch.parallel.spatial import Conv2d

PSP_BINS = (1, 2, 3, 6)
FPN_UPSAMPLES = {5: 3, 4: 2, 3: 1, 2: 0}   # nearest 2× steps per seg block


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, C, hh, ww) → (B, C, h, w), JAX ``_resize_nearest``
    (``decoders.py:21``)."""
    hh, ww = x.shape[2:]
    if (h, w) == (2 * hh, 2 * ww):
        return F.interpolate(x, scale_factor=2, mode="nearest")

    def index(n_in: int, n_out: int) -> torch.Tensor:
        k = torch.arange(n_out, dtype=torch.float32, device=x.device)
        return torch.floor((k + 0.5) * n_in / n_out).long()

    if h != hh:
        x = x.index_select(2, index(hh, h))
    if w != ww:
        x = x.index_select(3, index(ww, w))
    return x


def linear_weights(n_in: int, n_out: int, device=None,
                   dtype=torch.float32) -> torch.Tensor:
    """(n_out, n_in) weights of JAX's antialiased linear resize along one
    axis (``jax._src.image.scale.compute_weight_mat``, triangle kernel, no
    translation), computed in ``dtype``: JAX's default float, f32, or f64
    with x64 on."""
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=dtype)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(n_out, dtype=dtype) + 0.5) * inv_scale \
        - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=dtype)[:, None]
         ).abs() / kernel_scale
    wts = torch.clamp(1.0 - x, min=0.0)
    total = wts.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    wts = torch.where(total.abs() > eps,
                      wts / torch.where(total != 0, total,
                                        torch.ones_like(total)),
                      torch.zeros_like(wts))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    wts = torch.where(inside[None, :], wts, torch.zeros_like(wts))
    return wts.t().contiguous().to(device)


def resize_linear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, C, hh, ww) → (B, C, h, w), JAX
    ``jax.image.resize(..., method="linear")`` with its default
    ``antialias=True`` (``decoders.py:33``, and ``:130`` for PSPNet's
    pooled bins over indivisible dims). Computes in ``x``'s dtype."""
    hh, ww = x.shape[2:]
    if (h, w) == (hh, ww):
        return x
    if h >= hh and w >= ww:
        return F.interpolate(x, size=(h, w), mode="bilinear",
                             align_corners=False)
    wd = torch.float64 if x.dtype == torch.float64 else torch.float32
    if h != hh:
        x = torch.einsum("oh,bchw->bcow",
                         linear_weights(hh, h, x.device, wd).to(x.dtype), x)
    if w != ww:
        x = torch.einsum("ow,bchw->bcho",
                         linear_weights(ww, w, x.device, wd).to(x.dtype), x)
    return x.contiguous()


def psp_pool(c5: torch.Tensor, nbins: int) -> torch.Tensor:
    """(B, C, h, w) → (B, C, nbins, nbins) in f32 (f64 stays): the exact
    reshape-mean when both dims divide ``nbins``, else JAX's
    antialiased linear resize (``decoders.py:122-132``)."""
    b, c, h, w = c5.shape
    x = at_least_f32(c5)
    if h % nbins == 0 and w % nbins == 0:
        return x.reshape(b, c, nbins, h // nbins, nbins, w // nbins) \
            .mean(dim=(3, 5))
    return resize_linear(x, nbins, nbins)


def conv_bn(cin: int, cout: int, k: int) -> nn.Sequential:
    """smp's ``Sequential(conv, BatchNorm)`` without the conv's bias."""
    return nn.Sequential(Conv2d(cin, cout, k, 1, k // 2, bias=False),
                         BatchNorm2d(cout))


class FPNSegBlock(nn.Module):
    """max(n_up, 1) × (3×3 conv + BN + ReLU), each followed by a nearest
    2× while upsamples remain (JAX ``FPNDecoder.seg_block``); its input is
    pyramid level ``level``."""

    def __init__(self, cin: int, n_up: int, ch: int = 128, level: int = 2):
        super().__init__()
        self.n_up = n_up
        self.level = level
        for k in range(max(n_up, 1)):
            setattr(self, f"conv{k}", conv_bn(cin if k == 0 else ch, ch, 3))

    def forward(self, x: torch.Tensor, levels=None) -> torch.Tensor:
        for k in range(max(self.n_up, 1)):
            lvl = self.level - k
            with spatial.at(levels, lvl):
                x = F.relu(getattr(self, f"conv{k}")(x))
            if k < self.n_up:
                x = resize_nearest(x, 2 * x.shape[2], 2 * x.shape[3])
                x = spatial.settle(x, levels, lvl, lvl - 1)
        return x


class FPNDecoder(nn.Module):
    """smp FPN defaults: pyramid 256, segmentation 128, merge by sum
    (JAX ``FPNDecoder``, ``decoders.py:38``). Returns the (B, 128, H/4,
    W/4) merge; the head's 1×1 conv and ×4 bilinear follow on the
    Y-Net."""

    out_level = 2

    def __init__(self, encoder_channels: Sequence[int],
                 pyramid_channels: int = 256,
                 segmentation_channels: int = 128):
        super().__init__()
        for n, c in zip((5, 4, 3, 2), encoder_channels[:4]):
            setattr(self, f"lat{n}", Conv2d(c, pyramid_channels, 1))
            setattr(self, f"seg{n}", FPNSegBlock(
                pyramid_channels, FPN_UPSAMPLES[n], segmentation_channels,
                level=n))

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        p, out, levels = None, None, spatial.levels_of(features)
        for n, c in zip((5, 4, 3, 2), features[:4]):
            lat = getattr(self, f"lat{n}")(c)
            if p is not None:
                h = spatial.source_rows(c.shape[2], levels, n + 1, n)
                lat = lat + spatial.settle(resize_nearest(p, h, c.shape[3]),
                                           levels, n + 1, n)
            p = lat
            s = getattr(self, f"seg{n}")(p, levels)
            out = s if out is None else out + s
        return out


class PSPDecoder(nn.Module):
    """Pyramid pooling over c5 (bins 1, 2, 3, 6), a 1×1 conv + BN + ReLU
    per bin, bilinear back to c5's size, concat with c5, 3×3 fuse conv +
    BN + ReLU (JAX ``PSPDecoder``, ``decoders.py:95``). Returns the
    (B, 512, h, w) fuse output; the head's 1×1 conv and ×32 bilinear
    follow on the Y-Net."""

    def __init__(self, encoder_channels: Sequence[int],
                 fuse_channels: int = 512, bins: Sequence[int] = PSP_BINS):
        super().__init__()
        in_channels = encoder_channels[0]
        self.bins = tuple(bins)
        branch = max(in_channels // len(self.bins), 1)
        for bi in range(len(self.bins)):
            setattr(self, f"psp{bi}", conv_bn(in_channels, branch, 1))
        self.fuse = conv_bn(in_channels + len(self.bins) * branch,
                            fuse_channels, 3)

    out_level = None

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        levels = spatial.levels_of(features)
        c5 = spatial.settle(features[0], levels, 5, None)
        h, w = c5.shape[2:]
        outs = [c5]
        with spatial.at(levels, None):
            for bi, nbins in enumerate(self.bins):
                x = psp_pool(c5, nbins).to(c5.dtype)
                x = F.relu(getattr(self, f"psp{bi}")(x))
                outs.append(resize_linear(x, h, w))
            return F.relu(self.fuse(torch.cat(outs, dim=1)))


class LinknetDecoderBlock(nn.Module):
    """1×1 reduce to in/4, nearest 2× + 3×3, 1×1 to ``cout``, each BN +
    ReLU, then the residual skip add (JAX ``LinknetDecoderBlock``,
    ``decoders.py:149``; upsample + conv, not smp's ConvTranspose2d:
    PARITY.md, "Deliberate narrowings")."""

    def __init__(self, cin: int, cout: int, level: int = 0):
        super().__init__()
        mid = max(cin // 4, 1)
        self.level = level          # the pyramid level it makes
        self.conv1 = conv_bn(cin, mid, 1)
        self.conv2 = conv_bn(mid, mid, 3)
        self.conv3 = conv_bn(mid, cout, 1)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None,
                levels=None) -> torch.Tensor:
        """``levels``: the encoder's plan (``spatial.Pyramid``), under
        spatial training."""
        x = F.relu(self.conv1(x))       # 1×1: no halo in either layout
        x = resize_nearest(x, 2 * x.shape[2], 2 * x.shape[3])
        x = spatial.settle(x, levels, self.level + 1, self.level)
        with spatial.at(levels, self.level):
            x = F.relu(self.conv3(F.relu(self.conv2(x))))
        return x if skip is None else x + skip.to(x.dtype)


class LinknetDecoder(nn.Module):
    """Five blocks; block i adds encoder skip i (c4, c3, c2, c1), the last
    emits 32 channels with no skip (JAX ``LinknetDecoder``,
    ``decoders.py:234``, eval branch). Returns the (B, 32, H, W)
    activation the Y-Net's 3×3 head reads."""

    out_level = 0

    def __init__(self, encoder_channels: Sequence[int]):
        super().__init__()
        outs = list(encoder_channels[1:]) + [32]
        ins = [encoder_channels[0]] + outs[:-1]
        self.blocks = nn.ModuleList(
            LinknetDecoderBlock(i, o, level=4 - k)
            for k, (i, o) in enumerate(zip(ins, outs)))

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        x, levels = features[0], spatial.levels_of(features)
        skips = list(features[1:]) + [None]
        for block, skip in zip(self.blocks, skips):
            x = block(x, skip, levels)
        return x


def bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """mmsegmentation's ``resize(..., mode="bilinear", align_corners=False)``:
    ``F.interpolate`` whichever way each axis goes (no antialiasing, unlike
    :func:`resize_linear` when it downsamples)."""
    if tuple(x.shape[2:]) == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False)


class UPerNetDecoder(nn.Module):
    """mmsegmentation's ``UPerHead`` up to ``conv_seg`` (Xiao et al., ECCV
    2018, arXiv:1807.10221; as the Swin paper runs it): a pyramid pooling
    module on c5 (``AdaptiveAvgPool2d`` to 1, 2, 3 and 6 bins, a 1×1 conv
    + BN + ReLU each, bilinear back; never :func:`psp_pool`, whose
    antialiased resize differs where the bins do not divide c5), their
    concat with c5 through a 3×3 ``bottleneck``; 1×1 laterals on c2-c4 and
    top-down bilinear adds; 3×3 FPN convs on c2-c4; all four levels resized
    to 1/4 and concatenated (4·512 channels) through the 3×3
    ``fpn_bottleneck``. Every conv is conv + BN + ReLU with 512 output
    channels. Returns the (B, 512, H/4, W/4) map; the head's 1×1 conv and
    ×4 bilinear follow on the Y-Net. The training-only auxiliary FCN head
    is left out, in training as in inference."""

    out_level = 2

    def __init__(self, encoder_channels: Sequence[int], channels: int = 512,
                 bins: Sequence[int] = PSP_BINS):
        super().__init__()
        c5 = encoder_channels[0]
        self.bins = tuple(bins)
        self.psp_modules = nn.ModuleList(conv_bn(c5, channels, 1)
                                         for _ in self.bins)
        self.bottleneck = conv_bn(c5 + len(self.bins) * channels, channels, 3)
        ins = tuple(encoder_channels[1:4])[::-1]       # c2, c3, c4
        self.lateral_convs = nn.ModuleList(conv_bn(c, channels, 1)
                                           for c in ins)
        self.fpn_convs = nn.ModuleList(conv_bn(channels, channels, 3)
                                       for _ in ins)
        self.fpn_bottleneck = conv_bn((len(ins) + 1) * channels, channels, 3)

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        c5 = features[0]
        h, w = c5.shape[2:]
        psp = [c5] + [bilinear(F.relu(m(F.adaptive_avg_pool2d(c5, n))), h, w)
                      for m, n in zip(self.psp_modules, self.bins)]
        lat = [F.relu(m(c)) for m, c in zip(self.lateral_convs,
                                           features[1:4][::-1])]
        lat.append(F.relu(self.bottleneck(torch.cat(psp, dim=1))))
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + bilinear(lat[i], *lat[i - 1].shape[2:])
        outs = [F.relu(m(x)) for m, x in zip(self.fpn_convs, lat)] + [lat[-1]]
        h2, w2 = outs[0].shape[2:]
        outs = [outs[0]] + [bilinear(x, h2, w2) for x in outs[1:]]
        return F.relu(self.fpn_bottleneck(torch.cat(outs, dim=1)))
