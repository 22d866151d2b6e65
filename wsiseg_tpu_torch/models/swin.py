"""The Swin Transformer encoder (Liu et al., ICCV 2021, arXiv:2103.14030;
microsoft/Swin-Transformer, as SwinTransformer/Swin-Transformer-Semantic-
Segmentation ``mmseg/models/backbones/swin_transformer.py`` runs it under
UPerNet), the encoder ``swin_b``.

A 4×4/4 patch embedding (conv, then LayerNorm), then four stages of
``depth`` blocks, a patch merging between stages and a LayerNorm on each
stage's output (``norm0..3``). A block:

    x += proj(WMSA(pad(LN(x))))          cropped after
    x += fc2(GELU(fc1(LN(x))))

WMSA: the map is zero-padded at the bottom and right to a multiple of the
window (after ``norm1``; the padded tokens stay unmasked keys, as both
published codes do), rolled by (−shift, −shift) on odd blocks, cut into
window×window windows, each computing ``softmax(q kᵀ·scale + B[rel] + M)
v`` (:func:`wsiseg_tpu_torch.ops.attention.window_attention`), then
reversed, rolled back and cropped. ``B`` comes from a (2·window − 1)² ×
heads table by the relative position of each token pair; ``M`` is −100
between tokens of different shift regions, which happens only in the
windows of the last window row and column. Patch merging gathers each
2×2 neighbourhood in the order [x0::2,0::2; x1::2,0::2; x0::2,1::2;
x1::2,1::2] (zero-padded to even sides), then LayerNorm(4C) and a
Linear(4C → 2C) without bias. LayerNorm eps is torch's 1e-5, GELU exact;
no absolute position embedding, no dropout and no stochastic depth (the
port's trainers run the blocks whole).

Parameter names are Microsoft's (``patch_embed.proj/norm``,
``layers.{i}.blocks.{j}.{norm1,attn.{qkv,proj,
relative_position_bias_table},norm2,mlp.fc1,mlp.fc2}``,
``layers.{i}.downsample.{norm,reduction}``, ``norm{i}``); the relative
position index and the shift masks are no state (they follow from the
window and the map's size), so a meta-built model loads a state dict whole.

Tokens are (B, H, W, C), C fastest: a map is the channels_last view of
the same memory. The encoder returns the port's pyramid, deepest first,
[c5, c4, c3, c2, c1] at strides 32, 16, 8, 4 and 2; Swin has no stride-2
level, so c1 has 0 channels. Each stage runs in range ``swin.stage``.

Whole-image only: window borders and the edge padding depend on the whole
padded image, so a chunk of a slide is not a piece of its forward; the
encoder refuses spatial training and the engine refuses its chunked
routes for a Swin model (``FastWeights.chunk_exact``).
"""

from __future__ import annotations

import copy
import functools
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from wsiseg_tpu_torch.ops.attention import window_attention
from wsiseg_tpu_torch.parallel import comm

#: encoder name → published widths (Swin-B, window 12: the ImageNet-22K
#: 384² checkpoint UperNet Swin-B starts from)
SWIN_SPECS: Dict[str, Dict] = {
    "swin_b": {"embed_dim": 128, "depths": (2, 2, 18, 2),
               "heads": (4, 8, 16, 32), "window": 12, "patch": 4,
               "mlp_ratio": 4},
}
#: the shift mask's value between tokens of different regions
MASK_VALUE = -100.0
#: Peak device bytes per padded pixel of the fused whole-image route for
#: swin_b UPerNet: 7.6425 GB over the inputs around one 3072×4096 slide's
#: forward and postprocess = 607.4 B/px (606.3 a slide at four in flight;
#: NVIDIA H100 80GB HBM3, PERF.md §6). The engine's cap: 64e9 / (608 B/px
#: · 4 slides) = 26.32 M px.
SWIN_PEAK_BYTES_PER_PX = 608


def is_swin(arch: str) -> bool:
    return arch in SWIN_SPECS


def swin_out_channels(arch: str) -> Tuple[int, ...]:
    """Deepest-first channels of the pyramid; c1 has none."""
    c = SWIN_SPECS[arch]["embed_dim"]
    return (8 * c, 4 * c, 2 * c, c, 0)


@functools.lru_cache(maxsize=8)
def _relative_index(window: int, device: str) -> torch.Tensor:
    """(N·N,) index into the bias table of each token pair (i, j) of a
    window, Microsoft's ``relative_position_index``."""
    ys, xs = torch.meshgrid(torch.arange(window), torch.arange(window),
                            indexing="ij")
    c = torch.stack([ys.flatten(), xs.flatten()])            # (2, N)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0) + window - 1
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).reshape(-1) \
        .to(device)


def relative_bias(table: torch.Tensor, window: int) -> torch.Tensor:
    """(heads, N, N) bias of every token pair of a window from the
    ((2·window − 1)², heads) table."""
    n = window * window
    idx = _relative_index(window, str(table.device))
    return table[idx].view(n, n, -1).permute(2, 0, 1)


@functools.lru_cache(maxsize=64)
def shift_masks(hp: int, wp: int, window: int, shift: int,
                device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx, masks) of a padded hp×wp map rolled by (−shift, −shift): the
    (nb,) windows (row-major) of its last window row and column, the only
    ones whose tokens fall in more than one shift region, and their
    (nb, N, N) float32 masks, ``MASK_VALUE`` between tokens of different
    regions and 0 elsewhere."""
    region = torch.zeros(hp, wp)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    k = 0
    for hs in cuts:
        for ws in cuts:
            region[hs, ws] = k
            k += 1
    nh, nw = hp // window, wp // window
    win = region.view(nh, window, nw, window).permute(0, 2, 1, 3) \
        .reshape(nh * nw, window * window)
    idx = torch.tensor(sorted(set(range((nh - 1) * nw, nh * nw))
                              | set(range(nw - 1, nh * nw, nw))))
    w = win[idx]
    masks = (w[:, None, :] != w[:, :, None]).float() * MASK_VALUE
    return idx.to(device), masks.to(device)


def to_windows(x: torch.Tensor, window: int, shift: int) -> torch.Tensor:
    """(B, H, W, C) → (B, nW, N, C): zero-padded at the bottom and right
    to multiples of ``window``, rolled by (−shift, −shift), cut into
    windows row-major."""
    b, h, w, c = x.shape
    x = F.pad(x, (0, 0, 0, -w % window, 0, -h % window))
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    hp, wp = x.shape[1:3]
    return x.view(b, hp // window, window, wp // window, window, c) \
        .permute(0, 1, 3, 2, 4, 5).reshape(b, -1, window * window, c)


def from_windows(x: torch.Tensor, h: int, w: int, window: int,
                 shift: int) -> torch.Tensor:
    """:func:`to_windows` reversed: (B, nW, N, C) → (B, h, w, C)."""
    b, _, _, c = x.shape
    hp, wp = h + (-h % window), w + (-w % window)
    x = x.view(b, hp // window, wp // window, window, window, c) \
        .permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
    if shift:
        x = torch.roll(x, (shift, shift), (1, 2))
    return x[:, :h, :w]


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.window = window
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, masked=None) -> torch.Tensor:
        """(B, nW, N, C) windows → (B, nW, N, C)."""
        b, nw, n, c = x.shape
        d = c // self.heads
        qkv = self.qkv(x).view(b, nw, n, 3, self.heads, d) \
            .permute(3, 0, 1, 4, 2, 5)
        y = window_attention(qkv[0], qkv[1], qkv[2],
                             relative_bias(self.relative_position_bias_table,
                                           self.window), masked)
        return self.proj(y.transpose(2, 3).reshape(b, nw, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 mlp_ratio: int):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x: torch.Tensor, masked=None) -> torch.Tensor:
        """(B, H, W, C) tokens; ``masked`` (:func:`shift_masks`) for the
        map's padded size, read by a shifted block only."""
        h, w = x.shape[1:3]
        y = self.attn(to_windows(self.norm1(x), self.window, self.shift),
                      masked if self.shift else None)
        x = x + from_windows(y, h, w, self.window, self.shift)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) → (B, ⌈H/2⌉, ⌈W/2⌉, 2C)."""
        h, w = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int,
                 mlp_ratio: int, downsample: bool):
        super().__init__()
        self.window = window
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, 0 if j % 2 == 0 else window // 2,
                      mlp_ratio) for j in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        ws = self.window
        masked = shift_masks(h + (-h % ws), w + (-w % ws), ws, ws // 2,
                             str(x.device))
        for blk in self.blocks:
            x = blk(x, masked)
        return x


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(3, dim, patch, patch)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) → (B, H/p, W/p, C) tokens (sides zero-padded to
        multiples of the patch)."""
        p = self.patch
        x = F.pad(x, (0, -x.shape[3] % p, 0, -x.shape[2] % p))
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class SwinEncoder(nn.Module):
    """Returns [c5, c4, c3, c2, c1] (c1 with 0 channels), each the
    channels_last view of (B, h, w, C) tokens in the input's dtype."""

    def __init__(self, arch: str = "swin_b"):
        super().__init__()
        if not is_swin(arch):
            raise ValueError(f"unknown Swin encoder {arch!r}; expected one "
                             f"of {tuple(SWIN_SPECS)}")
        spec = SWIN_SPECS[arch]
        self.arch = arch
        c, n = spec["embed_dim"], len(spec["depths"])
        self.patch_embed = PatchEmbed(spec["patch"], c)
        self.layers = nn.ModuleList(
            SwinStage(c * 2 ** i, spec["depths"][i], spec["heads"][i],
                      spec["window"], spec["mlp_ratio"], i < n - 1)
            for i in range(n))
        for i in range(n):
            setattr(self, f"norm{i}", nn.LayerNorm(c * 2 ** i))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if comm.space() is not None:
            raise ValueError(
                f"spatial training splits each tile into row stripes, which "
                f"{self.arch}'s windows over the whole padded map cannot run "
                f"on: train {self.arch} data-parallel only (--mesh N)")
        b, _, h0, w0 = x.shape
        feats = [x.new_empty((b, 0, h0 // 2, w0 // 2))]
        x = self.patch_embed(x)
        for i, stage in enumerate(self.layers):
            with record_function("swin.stage"):
                x = stage(x)
                feats.append(getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2))
                if stage.downsample is not None:
                    x = stage.downsample(x)
        return feats[::-1]


@torch.no_grad()
def prepare_swin(encoder: SwinEncoder, mean: Sequence[float],
                 std: Sequence[float], dtype: torch.dtype
                 ) -> Dict[str, object]:
    """What the whole-image forward (:func:`encode_image`) reads: a frozen
    copy of ``encoder`` in ``dtype`` (LayerNorm's statistics are taken in
    float32 whatever its operands) and the input's normalisation."""
    enc = copy.deepcopy(encoder).to(dtype).eval().requires_grad_(False)
    dev = next(encoder.parameters()).device
    return {"encoder": enc, "dtype": dtype,
            "mean": torch.tensor(mean, device=dev).view(1, 3, 1, 1),
            "std": torch.tensor(std, device=dev).view(1, 3, 1, 1)}


def encode_image(prep: Dict[str, object],
                 img_u8: torch.Tensor) -> List[torch.Tensor]:
    """(N, H, W, 3) u8 images → the pyramid: (x/255 − mean)/std in
    float32, rounded to the compute dtype, through the encoder."""
    x = img_u8.permute(0, 3, 1, 2).float().div_(255.0)
    x = x.sub_(prep["mean"]).div_(prep["std"]).to(prep["dtype"])
    return prep["encoder"](x)

