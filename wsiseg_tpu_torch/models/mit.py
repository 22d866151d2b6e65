"""SegFormer's Mix Transformer encoder (Xie et al., arXiv:2105.15203;
NVlabs/SegFormer ``mmseg/models/backbones/mix_transformer.py``, the
encoder ``mit_b5`` of segmentation_models_pytorch).

Four stages. Each starts with an overlapping patch embedding (a conv,
7×7/4 for the first stage and 3×3/2 after, then LayerNorm) and runs
``depth`` blocks over the stage's tokens, then a LayerNorm:

    x += proj(attn(LN(x)))                            spatial-reduction
    x += fc2(GELU(dwconv3x3(fc1(LN(x)))))             Mix-FFN

The attention's queries are all N tokens of the map; its keys and values
come from the map reduced by an R×R/R conv and a LayerNorm (N/R²
tokens), or from the map itself where R = 1
(:func:`~wsiseg_tpu_torch.ops.attention.sr_attention`). No position
embedding: the Mix-FFN's zero-padded depthwise conv supplies position,
so any input size runs, and every output depends on the whole image.

Parameter names are NVlabs' and smp's (``patch_embed{i}.proj``,
``block{i}.{j}.attn.{q,kv,sr,norm,proj}``, ``.mlp.{fc1,dwconv.dwconv,
fc2}``, ``norm{i}``), so an smp ``mit_b5`` checkpoint's encoder loads.
LayerNorm eps as published: 1e-6 in the blocks and after each stage,
torch's 1e-5 in the patch embeddings and the reduction. GELU is exact.
No dropout and no stochastic depth (mit_b5 trains with a drop-path rate
of 0.1; the port's trainers run the blocks whole).

Tokens are (B, N, C) with C fastest, so a map is the channels_last view
of the same memory: the convs read and write it without a copy. The
encoder returns the port's pyramid, deepest first, [c5, c4, c3, c2, c1]
at strides 32, 16, 8, 4 and 2; MiT has no stride-2 level, so c1 has 0
channels (smp's placeholder). Each stage runs in range ``mit.stage``.

Whole-image only: a chunk of a slide, or a stripe of a tile, sees other
keys than the whole image, so no halo makes it exact. The encoder refuses
spatial training, and the engine refuses its chunked routes for a MiT
model (``FastWeights.chunk_exact``, set by
:func:`wsiseg_tpu_torch.models.infer_fast.prepare_fast`).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from wsiseg_tpu_torch.ops.attention import sr_attention
from wsiseg_tpu_torch.parallel import comm

#: encoder name → published widths (NVlabs ``mit_b5``)
MIT_SPECS: Dict[str, Dict[str, Tuple[int, ...]]] = {
    "mit_b5": {"dims": (64, 128, 320, 512), "heads": (1, 2, 5, 8),
               "depths": (3, 6, 40, 3), "sr": (8, 4, 2, 1),
               "mlp_ratio": (4, 4, 4, 4)},
}
#: LayerNorm eps of the blocks and the stage norms (``norm_layer``)
BLOCK_EPS = 1e-6
#: Peak device bytes per padded pixel of the fused whole-image route for
#: mit_b5 FPN (its attention keeps no score matrix): 3.7354 GB around
#: ``device_throughput`` at one 3072×4096 slide = 296.9 B/px (244.1 a
#: slide at four in flight; NVIDIA H100 80GB HBM3, PERF.md §6). The
#: engine's cap: 64e9 / (297 B/px · 4 slides) = 53.87 M px.
MIT_PEAK_BYTES_PER_PX = 297


def is_mit(arch: str) -> bool:
    return arch in MIT_SPECS


def mit_out_channels(arch: str) -> Tuple[int, ...]:
    """Deepest-first channels of the pyramid; c1 has none."""
    return tuple(MIT_SPECS[arch]["dims"][::-1]) + (0,)


def to_map(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, N, C) tokens → the (B, C, h, w) channels_last view."""
    return x.transpose(1, 2).unflatten(2, (h, w))


def to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, h, w) → (B, h·w, C); a view of a channels_last map."""
    return x.flatten(2).transpose(1, 2)


class PatchEmbed(nn.Module):
    """Overlapping patch embedding: a k×k/stride conv, then LayerNorm."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, cout, k, stride, k // 2)
        self.norm = nn.LayerNorm(cout)

    def forward(self, x: torch.Tensor):
        x = self.proj(x)
        h, w = x.shape[2:]
        return self.norm(to_tokens(x)), h, w


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, sr: int):
        super().__init__()
        self.heads = heads
        self.sr_ratio = sr
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr > 1:
            self.sr = nn.Conv2d(dim, dim, sr, sr)
            self.norm = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, c = x.shape
        d = c // self.heads
        q = self.q(x).unflatten(2, (self.heads, d)).transpose(1, 2)
        if self.sr_ratio > 1:
            x = self.norm(to_tokens(self.sr(to_map(x, h, w))))
        kv = self.kv(x).unflatten(2, (2, self.heads, d)).permute(
            2, 0, 3, 1, 4)
        y = sr_attention(q, kv[0], kv[1])
        return self.proj(y.transpose(1, 2).flatten(2))


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        return to_tokens(self.dwconv(to_map(x, h, w)))


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), h, w)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, sr: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=BLOCK_EPS)
        self.attn = Attention(dim, heads, sr)
        self.norm2 = nn.LayerNorm(dim, eps=BLOCK_EPS)
        self.mlp = MixFFN(dim, dim * mlp_ratio)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), h, w)
        return x + self.mlp(self.norm2(x), h, w)


class MiTEncoder(nn.Module):
    """Returns [c5, c4, c3, c2, c1] (c1 with 0 channels), each a
    channels_last map in the input's dtype."""

    def __init__(self, arch: str = "mit_b5"):
        super().__init__()
        if not is_mit(arch):
            raise ValueError(f"unknown MiT encoder {arch!r}; expected one "
                             f"of {tuple(MIT_SPECS)}")
        spec = MIT_SPECS[arch]
        self.arch = arch
        cin = 3
        for i, (dim, heads, depth, sr, ratio) in enumerate(zip(
                spec["dims"], spec["heads"], spec["depths"], spec["sr"],
                spec["mlp_ratio"]), 1):
            k, s = (7, 4) if i == 1 else (3, 2)
            setattr(self, f"patch_embed{i}", PatchEmbed(cin, dim, k, s))
            setattr(self, f"block{i}", nn.ModuleList(
                Block(dim, heads, sr, ratio) for _ in range(depth)))
            setattr(self, f"norm{i}", nn.LayerNorm(dim, eps=BLOCK_EPS))
            cin = dim

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if comm.space() is not None:
            raise ValueError(
                f"spatial training splits each tile into row stripes, which "
                f"{self.arch}'s global attention cannot run on: train "
                f"{self.arch} data-parallel only (--mesh N)")
        b, _, h0, w0 = x.shape
        feats = [x.new_empty((b, 0, h0 // 2, w0 // 2))]
        for i in range(1, 5):
            with record_function("mit.stage"):
                t, h, w = getattr(self, f"patch_embed{i}")(x)
                for blk in getattr(self, f"block{i}"):
                    t = blk(t, h, w)
                x = to_map(getattr(self, f"norm{i}")(t), h, w)
            feats.append(x)
        return feats[::-1]


@torch.no_grad()
def prepare_mit(encoder: MiTEncoder, mean: Sequence[float],
                std: Sequence[float], dtype: torch.dtype) -> Dict[str, object]:
    """What the whole-image forward (:func:`encode_image`) reads: a frozen
    copy of ``encoder`` in ``dtype`` (LayerNorm's statistics are taken in
    float32 whatever its operands) and the input's normalisation."""
    enc = copy.deepcopy(encoder).to(dtype).to(
        memory_format=torch.channels_last).eval().requires_grad_(False)
    dev = next(encoder.parameters()).device
    return {"encoder": enc, "dtype": dtype,
            "mean": torch.tensor(mean, device=dev).view(1, 3, 1, 1),
            "std": torch.tensor(std, device=dev).view(1, 3, 1, 1)}


def encode_image(prep: Dict[str, object],
                 img_u8: torch.Tensor) -> List[torch.Tensor]:
    """(N, H, W, 3) u8 images → the pyramid: (x/255 − mean)/std in
    float32, rounded to the compute dtype, as the channels_last view."""
    x = img_u8.permute(0, 3, 1, 2).float().div_(255.0)
    x = x.sub_(prep["mean"]).div_(prep["std"]).to(prep["dtype"])
    return prep["encoder"](x)
