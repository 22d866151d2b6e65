"""The plain reference SegFormer-FPN Y-Net: SegFormer's Mix Transformer
MiT-B5 (Xie et al., arXiv:2105.15203; NVlabs/SegFormer
``mmseg/models/backbones/mix_transformer.py``, ``mit_b5``) under the FPN
of :mod:`portbench.reference.ynet`, with the same segmentation head and
Y-Net classifier and regressor.

Plain ``torch.nn`` modules in float32, written as NVlabs writes them:
overlapping patch embeddings (7×7/4, then 3×3/2; conv, LayerNorm eps
1e-5), blocks ``x += proj(attn(LN(x)))``, ``x += fc2(GELU(dwconv(fc1(
LN(x)))))`` (LayerNorm eps 1e-6, exact GELU, 3×3 depthwise conv with
bias, zero padding), spatial-reduction attention whose keys and values
come from an R×R/R conv and LayerNorm (eps 1e-5) of the map where R > 1,
and a LayerNorm (eps 1e-6) after each stage. The attention is the explicit
``softmax(q kᵀ / √d) v`` (scale 1/8 at d = 64), computed a block of
queries at a time so that a whole slide fits: stage 1 of a 3072×4096
slide would otherwise hold a 786,432 × 12,288 score matrix (38.7 GB in
float32).

Departures from the published description:

- SegFormer's own all-MLP decoder is replaced by an FPN, as smp pairs
  ``FPN(encoder_name="mit_b5")``; it is the program's FPN, with the
  departures from smp that :mod:`portbench.reference.ynet` lists
  (BatchNorm after each segmentation conv, nearest top-down upsampling,
  the 1×1 head's logits upsampled ×4 bilinearly).
- The Y-Net's classifier and regressor read the stage-4 map (512
  channels), as on every family.
- No dropout and no stochastic depth (inference).
- Weights are random from the seed, not an ImageNet or ADE20K checkpoint.

Parameter names are NVlabs' and smp's, under ``encoder.``, so one state
dict loads into this model and into the program's. Imports nothing of
the program.

:func:`fp8_attention` switches the attention's four operands to float8
e4m3 with one scale per tensor (q, k and v; the probabilities one block
of queries at a time), as :func:`portbench.reference.lowp.to_fp8` rounds
a conv's; it serves only the control reading of the attention's
precision.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import lowp
from portbench.reference.ynet import FPNDecoder, Head

#: published widths, by encoder name
SPECS = {"mit_b5": {"dims": (64, 128, 320, 512), "heads": (1, 2, 5, 8),
                    "depths": (3, 6, 40, 3), "sr": (8, 4, 2, 1),
                    "mlp_ratio": 4}}
#: bytes of float32 scores the attention holds at once
SCORE_BYTES = 1 << 30

_ROUND = {"on": False}


@contextlib.contextmanager
def fp8_attention():
    """Within the block, the attention's q, k, probabilities and v are
    rounded to per-tensor float8 e4m3 before their products."""
    _ROUND["on"] = True
    try:
        yield
    finally:
        _ROUND["on"] = False


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / √d) v over (B, h, N, d) queries and (B, h, M, d)
    keys and values, ``SCORE_BYTES`` of scores at a time."""
    b, h, n, d = q.shape
    m = k.shape[2]
    rnd = lowp.to_fp8 if _ROUND["on"] else (lambda t: t)
    q, k, v = rnd(q), rnd(k), rnd(v)
    kt = k.transpose(-2, -1)
    step = max(1, SCORE_BYTES // (4 * b * h * m))
    out = torch.empty_like(q)
    for s in range(0, n, step):
        scores = torch.matmul(q[:, :, s:s + step], kt) * d ** -0.5
        p = torch.softmax(scores, dim=-1)
        del scores
        out[:, :, s:s + step] = torch.matmul(rnd(p), v)
    return out


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, cout, k, stride, k // 2)
        self.norm = nn.LayerNorm(cout)

    def forward(self, x):
        x = self.proj(x)
        _, _, h, w = x.shape
        return self.norm(x.flatten(2).transpose(1, 2)), h, w


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

    def forward(self, x, h: int, w: int):
        b, n, c = x.shape
        d = c // self.heads
        q = self.q(x).reshape(b, n, self.heads, d).permute(0, 2, 1, 3)
        if self.sr_ratio > 1:
            x_ = x.permute(0, 2, 1).reshape(b, c, h, w)
            x_ = self.sr(x_).reshape(b, c, -1).permute(0, 2, 1)
            x = self.norm(x_)
        kv = self.kv(x).reshape(b, -1, 2, self.heads, d).permute(
            2, 0, 3, 1, 4)
        y = attention(q, kv[0], kv[1])
        return self.proj(y.transpose(1, 2).reshape(b, n, c))


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, bias=True, groups=dim)

    def forward(self, x, h: int, w: int):
        b, n, c = x.shape
        x = x.transpose(1, 2).reshape(b, c, h, w)
        return self.dwconv(x).flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, h: int, w: int):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), h, w)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, sr: int, ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, sr)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * ratio)

    def forward(self, x, h: int, w: int):
        x = x + self.attn(self.norm1(x), h, w)
        return x + self.mlp(self.norm2(x), h, w)


class MixTransformer(nn.Module):
    """Returns [c5, c4, c3, c2] (strides 32, 16, 8, 4)."""

    def __init__(self, arch: str):
        super().__init__()
        spec = SPECS[arch]
        cin = 3
        for i in range(4):
            dim = spec["dims"][i]
            k, s = (7, 4) if i == 0 else (3, 2)
            setattr(self, f"patch_embed{i + 1}", PatchEmbed(cin, dim, k, s))
            setattr(self, f"block{i + 1}", nn.ModuleList(
                Block(dim, spec["heads"][i], spec["sr"][i],
                      spec["mlp_ratio"])
                for _ in range(spec["depths"][i])))
            setattr(self, f"norm{i + 1}", nn.LayerNorm(dim, eps=1e-6))
            cin = dim
        self.channels = list(spec["dims"][::-1])

    def forward(self, x) -> List[torch.Tensor]:
        b = x.shape[0]
        outs = []
        for i in range(1, 5):
            x, h, w = getattr(self, f"patch_embed{i}")(x)
            for blk in getattr(self, f"block{i}"):
                x = blk(x, h, w)
            x = getattr(self, f"norm{i}")(x)
            x = x.reshape(b, h, w, -1).permute(0, 3, 1, 2).contiguous()
            outs.append(x)
        return outs[::-1]


class SegFormerYNet(nn.Module):
    def __init__(self, arch: str, num_classes: int = 4, num_reg: int = 1):
        super().__init__()
        self.encoder = MixTransformer(arch)
        enc = self.encoder.channels
        self.decoder = FPNDecoder(enc)
        self.segmentation_head = Head(self.decoder.out, num_classes, 1, 4)
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
    """The reference model of a configuration file's dict (its
    ``"reference"`` names this module)."""
    if cfg["model_name"] != "FPN":
        raise ValueError(f"no SegFormer reference for decoder "
                         f"{cfg['model_name']!r}")
    return SegFormerYNet(cfg["arch_encoder"], cfg["num_classes"])
