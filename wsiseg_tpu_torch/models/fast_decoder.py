"""Inference-fast U-Net decoder with the space-to-depth (s2d) cell-domain
tail — counterpart of ``wsiseg_tpu/models/fast_decoder.py``.

A stride-1 3×3 conv maps exactly onto a 3×3 conv over s2d(f) cells with
transformed weights (derivations in the JAX module); the nearest 2×
upsample before a conv folds into its kernel (``upfold``). The decoder's
full-resolution tail therefore runs at quarter-resolution cells and the
seg head emits s2d(4) logit planes (``S2D_HEAD_F``), which the engine
postprocesses without a depth_to_space.

Channel order is the JAX one, ``(α·f + β)·C + c`` (position major).
``F.pixel_unshuffle`` orders ``c·f² + α·f + β`` and must not be used here.

Kernel transforms work on HWIO tensors, exactly as the JAX functions do
(so the tests compare them element by element), and
:func:`prepare_decoder` converts the results to OIHW once, when the
engine is built. Every conv is a plain ``F.conv2d`` (cuDNN on the card).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# s2d factor of the head logits that decode_cells(s2d_head=True) emits —
# the engine's planar postprocess interleaves f² position planes.
S2D_HEAD_F = 4


def _s2d_route(f: int) -> np.ndarray:
    """(3, 3, 3, 3, f², f²) 0/1 tensor: tap (dy, dx) of the logical kernel
    → (cell offset du, dv; input sub-position; output sub-position)."""
    route = np.zeros((3, 3, 3, 3, f * f, f * f), np.float32)
    for a in range(f):
        for b in range(f):
            for dy in range(3):
                du, by = divmod(a + dy - 1, f)
                if not (-1 <= du <= 1):
                    continue
                for dx in range(3):
                    dv, bx = divmod(b + dx - 1, f)
                    if not (-1 <= dv <= 1):
                        continue
                    route[dy, dx, du + 1, dv + 1,
                          by * f + bx, a * f + b] = 1.0
    return route


def s2d_kernel_f(w: torch.Tensor, f: int) -> torch.Tensor:
    """(3, 3, Cin, Cout) HWIO → (3, 3, f²·Cin, f²·Cout): the exact
    s2d(f)-domain kernel of a stride-1, pad-1 3×3 conv."""
    kh, kw, cin, cout = w.shape
    assert (kh, kw) == (3, 3)
    route = torch.from_numpy(_s2d_route(f)).to(w)
    out = torch.einsum("yxuvio,yxcm->uvicom", route, w)
    return out.reshape(3, 3, f * f * cin, f * f * cout)


def upfold_kernel(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) → (3, 3, Cin, 4·Cout): the s2d(2)-domain kernel
    of ``conv(upsample2x(x))`` reading x at cell resolution directly."""
    route = torch.from_numpy(_s2d_route(2).sum(axis=4)).to(w)
    out = torch.einsum("yxuvo,yxcm->uvcom", route, w)
    return out.reshape(3, 3, w.shape[2], 4 * w.shape[3])


def _upfold2_route() -> np.ndarray:
    """(3, 3, 3, 3, 4, 16) routing for :func:`upfold2_kernel`: logical tap
    (dy, dx) → (cell tap du, dv; s2d(2) input sub-position; s2d(4) output
    sub-position)."""
    route = np.zeros((3, 3, 3, 3, 4, 16), np.float32)
    for a in range(4):
        for b in range(4):
            for dy in range(3):
                du, al = divmod((a + dy - 1) // 2, 2)
                if not (-1 <= du <= 1):
                    continue
                for dx in range(3):
                    dv, be = divmod((b + dx - 1) // 2, 2)
                    if not (-1 <= dv <= 1):
                        continue
                    route[dy, dx, du + 1, dv + 1, al * 2 + be,
                          a * 4 + b] = 1.0
    return route


def upfold2_kernel(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) → (3, 3, 4·Cin, 16·Cout): ``conv3x3(upsample2x(
    x_half))`` taking ``x_half`` in s2d(2) layout to an s2d(4) output on
    the same cell grid."""
    cin, cout = w.shape[2], w.shape[3]
    route = torch.from_numpy(_upfold2_route()).to(w)
    out = torch.einsum("yxuvio,yxcm->uvicom", route, w)
    return out.reshape(3, 3, 4 * cin, 16 * cout)


def space_to_depth(x: torch.Tensor, f: int = 2) -> torch.Tensor:
    """(B, C, H, W) → (B, f²C, H/f, W/f), channel (α·f+β)·C + c; the
    result is channels_last in memory."""
    b, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1).reshape(b, h // f, f, w // f, f, c)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, h // f, w // f, f * f * c)
    return y.permute(0, 3, 1, 2)


def depth_to_space(x: torch.Tensor, f: int = 2) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    b, cf, h, w = x.shape
    c = cf // (f * f)
    y = x.permute(0, 2, 3, 1).reshape(b, h, w, f, f, c)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, f * h, f * w, c)
    return y.permute(0, 3, 1, 2)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2× upsample (keeps the memory format)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _bn_affine(bn: nn.BatchNorm2d):
    """Inference BatchNorm as f32 (scale', bias')."""
    inv = torch.rsqrt(bn.running_var.float() + bn.eps)
    scale = bn.weight.float() * inv
    return scale, bn.bias.float() - bn.running_mean.float() * scale


def hwio(conv: nn.Conv2d) -> torch.Tensor:
    """A conv's OIHW weight as the JAX HWIO kernel (f32)."""
    return conv.weight.detach().float().permute(2, 3, 1, 0)


def oihw(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """HWIO kernel → contiguous OIHW weight in ``dtype``."""
    return k.permute(3, 2, 0, 1).contiguous().to(dtype)


def _chan(v: torch.Tensor, reps: int = 1) -> torch.Tensor:
    """Per-channel f32 vector, tiled over ``reps`` s2d positions, shaped
    to broadcast over NCHW."""
    return v.repeat(reps).view(1, -1, 1, 1)


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
         padding: int = 1) -> torch.Tensor:
    """Conv in the weight's dtype, result upcast to f32. In bf16 the conv
    output is rounded to bf16 before the upcast, so a layer rounds twice
    (here, and after the f32 affine) where JAX's
    ``preferred_element_type=float32`` rounds once."""
    return F.conv2d(x, w, stride=stride, padding=padding).float()


@torch.no_grad()
def prepare_decoder(model, dtype: torch.dtype) -> Dict[str, object]:
    """All weight transforms of :func:`decode_cells`, done once: OIHW
    kernels in ``dtype`` and f32 BN affines tiled to each domain."""
    blocks = model.decoder.blocks
    prep: Dict[str, object] = {}
    for i in (0, 1):
        for cj in (1, 2):
            seq = getattr(blocks[i], f"conv{cj}")
            s, t = _bn_affine(seq[1])
            prep[f"b{i}c{cj}"] = (oihw(hwio(seq[0]), dtype), _chan(s),
                                  _chan(t))
    for i in (2, 3):
        w1 = hwio(blocks[i].conv1[0])
        cup = blocks[i - 1].conv2[0].out_channels
        s1, t1 = _bn_affine(blocks[i].conv1[1])
        s2, t2 = _bn_affine(blocks[i].conv2[1])
        prep[f"b{i}c1"] = (oihw(upfold_kernel(w1[:, :, :cup]), dtype),
                           oihw(s2d_kernel_f(w1[:, :, cup:], 2), dtype),
                           _chan(s1, 4), _chan(t1, 4))
        prep[f"b{i}c2"] = (oihw(s2d_kernel_f(hwio(blocks[i].conv2[0]), 2),
                                dtype), _chan(s2, 4), _chan(t2, 4))
    s1, t1 = _bn_affine(blocks[4].conv1[1])
    s2, t2 = _bn_affine(blocks[4].conv2[1])
    prep["b4c1"] = (oihw(upfold2_kernel(hwio(blocks[4].conv1[0])), dtype),
                    _chan(s1, 16), _chan(t1, 16))
    prep["b4c2"] = (oihw(s2d_kernel_f(hwio(blocks[4].conv2[0]), 4), dtype),
                    _chan(s2, 16), _chan(t2, 16))
    head = model.segmentation_head[0]
    prep["head"] = (oihw(s2d_kernel_f(hwio(head), 4), dtype),
                    _chan(head.bias.detach().float(), 16))
    return prep


def _affine_relu(y: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    return torch.relu(y * s + t).to(dtype)


def decode_cells(prep: Dict[str, object], feats: List[Optional[torch.Tensor]],
                 dtype: torch.dtype, s2d_head: bool = False,
                 skip3_s2d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """U-Net decoder forward with the full cell-domain s2d tail (JAX
    ``decode_cells``): blocks 0-1 native, blocks 2-3 in s2d(2) cells of
    their resolution, block4 + head in s2d(4) cells of the full
    resolution. ``s2d_head=True`` returns the (B, 16·nc, H/4, W/4) head
    logits in ``dtype``; otherwise (B, nc, H, W) f32.

    ``skip3_s2d`` (B, 4·C1, H/4, W/4) supplies ``space_to_depth(c1)``
    directly (the fused stem emits it; ``feats[4]`` may then be None)."""
    xx = feats[0].to(dtype)
    skips = list(feats[1:]) + [None]
    for i in (0, 1):
        xx = torch.cat([upsample2x(xx), skips[i].to(dtype)], dim=1)
        for cj in (1, 2):
            k, s, t = prep[f"b{i}c{cj}"]
            xx = _affine_relu(conv(xx, k), s, t, dtype)
    for i in (2, 3):
        k_up, k_sk, s1, t1 = prep[f"b{i}c1"]
        k2, s2, t2 = prep[f"b{i}c2"]
        if i == 3 and skip3_s2d is not None:
            sk = skip3_s2d.to(dtype)
        else:
            sk = space_to_depth(skips[i].to(dtype))
        y = conv(xx, k_up) + conv(sk, k_sk)
        xs = _affine_relu(y, s1, t1, dtype)
        xs = _affine_relu(conv(xs, k2), s2, t2, dtype)
        # block3's s2d(2) output feeds block4's upfold2 directly; block2
        # returns to native for block3's upfold conv1
        xx = depth_to_space(xs) if i == 2 else xs
    k1, s1, t1 = prep["b4c1"]
    xs = _affine_relu(conv(xx, k1), s1, t1, dtype)
    k2, s2, t2 = prep["b4c2"]
    xs = _affine_relu(conv(xs, k2), s2, t2, dtype)
    kh, bh = prep["head"]
    y = conv(xs, kh) + bh
    if s2d_head:
        return y.to(dtype)
    return depth_to_space(y, S2D_HEAD_F).float()
