"""Inference-fast functional ResNet stages — counterpart of
``wsiseg_tpu/models/fast_encoder.py`` (the ``encode_stages`` path that
the stem kernels feed: the fused stem's pooled c1, or the native c1 of the
fold route, max-pooled here).

Inference BatchNorm runs as an f32 affine on the conv output; weights are
prepared once (:func:`prepare_encoder`). Layer 1 runs residual-folded
(:func:`_basic_block_resfold`), which is exact only for non-negative block
inputs — true for every layer-1 block, whose inputs are maxpool/ReLU
outputs. BasicBlock archs only; Bottleneck waits (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from wsiseg_tpu_torch.models.fast_decoder import (_bn_affine, _chan, conv,
                                                  hwio, oihw)
from wsiseg_tpu_torch.models.resnet import ENCODER_SPECS, check_arch


@torch.no_grad()
def _prep_block(blk: nn.Module, resfold: bool,
                dtype: torch.dtype) -> Dict[str, object]:
    s1, t1 = _bn_affine(blk.bn1)
    s2, t2 = _bn_affine(blk.bn2)
    w1, w2 = hwio(blk.conv1), hwio(blk.conv2)
    if resfold:
        # [w1·s1 | I@center] (C→2C) and [w2·s2 ; I@center] (2C→C)
        c = w1.shape[2]
        eye = torch.zeros(3, 3, c, c, dtype=w1.dtype, device=w1.device)
        eye[1, 1] = torch.eye(c, dtype=w1.dtype, device=w1.device)
        return {"k1": oihw(torch.cat([w1 * s1, eye], dim=3), dtype),
                "b1": _chan(torch.cat([t1, torch.zeros_like(t1)])),
                "k2": oihw(torch.cat([w2 * s2, eye], dim=2), dtype),
                "t2": _chan(t2)}
    p = {"k1": oihw(w1, dtype), "s1": _chan(s1), "t1": _chan(t1),
         "k2": oihw(w2, dtype), "s2": _chan(s2), "t2": _chan(t2),
         "stride": blk.conv1.stride[0]}
    if blk.downsample is not None:
        sd, td = _bn_affine(blk.downsample[1])
        p.update(kd=oihw(hwio(blk.downsample[0]), dtype), sd=_chan(sd),
                 td=_chan(td))
    return p


def prepare_encoder(encoder: nn.Module,
                    dtype: torch.dtype) -> List[List[Dict[str, object]]]:
    """Per stage, per block: prepared OIHW kernels and f32 BN affines."""
    check_arch(encoder.arch)
    _, stages = ENCODER_SPECS[encoder.arch]
    return [[_prep_block(getattr(encoder, f"layer{i + 1}")[j], i == 0, dtype)
             for j in range(n)] for i, n in enumerate(stages)]


def _basic_block(p: Dict[str, object], xx: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    y = conv(xx, p["k1"], p["stride"])
    y = torch.relu(y * p["s1"] + p["t1"]).to(dtype)
    y = conv(y, p["k2"]) * p["s2"] + p["t2"]
    if "kd" in p:
        identity = conv(xx, p["kd"], p["stride"], padding=0) * p["sd"] \
            + p["td"]
    else:
        identity = xx.float()
    return torch.relu(y + identity).to(dtype)


def _basic_block_resfold(p: Dict[str, object], xx: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """Stride-1 BasicBlock with the residual folded into the convs: one
    conv emits (bn1-affine conv1 | x), the next bn2(conv2) + x."""
    a = torch.relu(conv(xx, p["k1"]) + p["b1"]).to(dtype)
    return torch.relu(conv(a, p["k2"]) + p["t2"]).to(dtype)


def encode_stages(prep: List[List[Dict[str, object]]],
                  pooled: Optional[torch.Tensor], dtype: torch.dtype,
                  c1: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """JAX ``encode_stages`` (``fast_encoder.py:214``): the four ResNet
    stages from the stem's pooled output (B, 64, H/4, W/4), or, with
    ``pooled`` None, from the native stem output ``c1``
    (B, 64, H/2, W/2) through the 3×3/2 max-pool (JAX ``maxpool_s2d``, an
    XLA op there: exact, as ``F.max_pool2d`` pads with -inf). Returns
    [c5, c4, c3, c2, c1] (``c1`` passed through; the fused stem path hands
    the decoder ``space_to_depth(c1)`` instead)."""
    if pooled is None:
        pooled = F.max_pool2d(c1, 3, 2, 1)
    xx = pooled.to(dtype)
    feats = []
    for i, blocks in enumerate(prep):
        for p in blocks:
            xx = (_basic_block_resfold(p, xx, dtype) if i == 0
                  else _basic_block(p, xx, dtype))
        feats.append(xx)
    c2, c3, c4, c5 = feats
    return [c5, c4, c3, c2, c1]
