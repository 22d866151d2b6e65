"""Inference-fast decoders — counterpart of
``wsiseg_tpu/models/fast_decoder.py``: the U-Net and Linknet decoders with
their space-to-depth (s2d) cell-domain tails, and (the JAX engine runs
the flax modules there) FPN and PSPNet on prepared weights.

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
engine is built. Every conv of :func:`decode_cells` is a plain
``F.conv2d`` (cuDNN on the card).

:func:`decode_linknet_cells` is Linknet's counterpart of
:func:`decode_cells` (same ``S2D_HEAD_F`` head planes);
:func:`decode_native` runs FPN and PSPNet to native full-resolution
logits (JAX ``infer_fast._apply_native_decoder``).

:func:`decode_fast` (JAX ``decode_fast``) is the batched-tile Unet
decoder of the grid, cls and chunked FCN routes: blocks 0-3 native,
block4 + head in s2d(2) cells, on the plain encoder
(:func:`unet_segment_fast`).

:func:`decode_fold` is the fold route's decoder (JAX ``decode_fold``): its
layer groups run on the port's hand-written conv kernels
(:mod:`wsiseg_tpu_torch.ops.conv9`), with weights prepared once by
:func:`prepare_fold`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wsiseg_tpu_torch.models.decoders import (FPN_UPSAMPLES, psp_pool,
                                              resize_linear, resize_nearest)
from wsiseg_tpu_torch.ops.conv9 import conv9, conv_chain, prep_layer

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


# ---- Linknet: blocks 3-4 + head in s2d cells ----

def _block_diag_1x1(w: torch.Tensor, f2: int) -> torch.Tensor:
    """(1, 1, Cin, Cout) HWIO → (1, 1, f²·Cin, f²·Cout): a 1×1 conv acts
    on each s2d position alike, so its s2d(f) kernel is kron(I_{f²}, w)
    (JAX ``_block_diag_1x1``, ``fast_decoder.py:496``)."""
    cin, cout = w.shape[2], w.shape[3]
    k = torch.kron(torch.eye(f2, dtype=w.dtype, device=w.device),
                   w.reshape(cin, cout).contiguous())
    return k.reshape(1, 1, f2 * cin, f2 * cout)


def _layer(seq: nn.Sequential, dtype: torch.dtype,
           k: Optional[torch.Tensor] = None, reps: int = 1):
    """``Sequential(conv, BN)`` → (OIHW kernel in ``dtype``, f32 BN scale,
    shift tiled over ``reps`` s2d positions); ``k`` replaces the conv's
    HWIO kernel by a transformed one."""
    s, t = _bn_affine(seq[1])
    return (oihw(hwio(seq[0]) if k is None else k, dtype), _chan(s, reps),
            _chan(t, reps))


def _cbr(x: torch.Tensor, layer, dtype: torch.dtype) -> torch.Tensor:
    """conv (SAME for 3×3, 1×1 unpadded) + f32 BN affine + ReLU, in
    ``dtype``."""
    k, s, t = layer
    return _affine_relu(conv(x, k, padding=k.shape[-1] // 2), s, t, dtype)


@torch.no_grad()
def prepare_linknet(model, dtype: torch.dtype) -> Dict[str, object]:
    """All weight transforms of :func:`decode_linknet_cells`, done once:
    blocks 0-2 and block3's conv1 native; block3's conv2 ``upfold``,
    conv3 block-diagonal in s2d(2); block4's conv1 block-diagonal s2d(2),
    conv2 ``upfold2``, conv3 block-diagonal s2d(4); the head
    ``s2d_kernel_f(·, 4)`` with its bias tiled 16×."""
    blocks = model.decoder.blocks
    prep: Dict[str, object] = {
        f"b{i}": [_layer(getattr(blocks[i], f"conv{k}"), dtype)
                  for k in (1, 2, 3)] for i in (0, 1, 2)}
    b3, b4 = blocks[3], blocks[4]
    prep["b3"] = [
        _layer(b3.conv1, dtype),
        _layer(b3.conv2, dtype, upfold_kernel(hwio(b3.conv2[0])), 4),
        _layer(b3.conv3, dtype, _block_diag_1x1(hwio(b3.conv3[0]), 4), 4)]
    prep["b4"] = [
        _layer(b4.conv1, dtype, _block_diag_1x1(hwio(b4.conv1[0]), 4), 4),
        _layer(b4.conv2, dtype, upfold2_kernel(hwio(b4.conv2[0])), 16),
        _layer(b4.conv3, dtype, _block_diag_1x1(hwio(b4.conv3[0]), 16), 16)]
    head = model.segmentation_head[0]
    prep["head"] = (oihw(s2d_kernel_f(hwio(head), 4), dtype),
                    _chan(head.bias.detach().float(), 16))
    return prep


def decode_linknet_cells(prep: Dict[str, object],
                         feats: List[Optional[torch.Tensor]],
                         dtype: torch.dtype, s2d_head: bool = False,
                         skip3_s2d: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Linknet decoder forward (JAX ``decode_linknet_cells``,
    ``fast_decoder.py:506-601``, with a batch dimension): blocks 0-2
    native; block3 at H/4 cells (conv1 native, then s2d(2) of its H/2
    output) with the residual skip ``space_to_depth(c1)``; block4 + head
    on the same cells in s2d(4) of the full resolution.
    ``s2d_head=True`` returns the (B, 16·nc, H/4, W/4) head logits in
    ``dtype`` — :func:`decode_cells`' plane contract; otherwise (B, nc, H,
    W) f32. ``skip3_s2d`` (B, 4·C1, H/4, W/4) supplies
    ``space_to_depth(c1)`` directly (the fused stem emits it;
    ``feats[4]`` may then be None)."""
    xx = feats[0].to(dtype)
    skips = list(feats[1:]) + [None]
    for i in (0, 1, 2):
        l1, l2, l3 = prep[f"b{i}"]
        xx = upsample2x(_cbr(xx, l1, dtype))
        xx = _cbr(_cbr(xx, l2, dtype), l3, dtype) + skips[i].to(dtype)
    for layer in prep["b3"]:
        xx = _cbr(xx, layer, dtype)
    if skip3_s2d is None:
        skip3_s2d = space_to_depth(skips[3].to(dtype))
    xx = xx + skip3_s2d.to(dtype)
    for layer in prep["b4"]:
        xx = _cbr(xx, layer, dtype)
    kh, bh = prep["head"]
    y = conv(xx, kh) + bh
    if s2d_head:
        return y.to(dtype)
    return depth_to_space(y, S2D_HEAD_F).float()


# ---- batched tiles: block4 + head in s2d(2) cells ----

@torch.no_grad()
def prepare_decode_fast(model, dtype: torch.dtype) -> Dict[str, object]:
    """All weight transforms of :func:`decode_fast`, done once: blocks 0-3
    native; block4's conv1 ``upfold``, conv2 and the head
    ``s2d_kernel_f(·, 2)``, their affines and the head bias tiled 4×."""
    blocks = model.decoder.blocks
    prep: Dict[str, object] = {
        f"b{i}c{cj}": _layer(getattr(blocks[i], f"conv{cj}"), dtype)
        for i in range(4) for cj in (1, 2)}
    b4, head = blocks[4], model.segmentation_head[0]
    prep["b4c1"] = _layer(b4.conv1, dtype, upfold_kernel(hwio(b4.conv1[0])),
                          4)
    prep["b4c2"] = _layer(b4.conv2, dtype,
                          s2d_kernel_f(hwio(b4.conv2[0]), 2), 4)
    prep["head"] = (oihw(s2d_kernel_f(hwio(head), 2), dtype),
                    _chan(head.bias.detach().float(), 4))
    return prep


def decode_fast(prep: Dict[str, object], feats: List[torch.Tensor],
                dtype: torch.dtype, s2d_head: bool = False) -> torch.Tensor:
    """U-Net decoder forward with the s2d(2) block4 tail (JAX
    ``decode_fast``, ``fast_decoder.py:225-277``): blocks 0-3 native,
    block4 + seg head at half resolution through :func:`upfold_kernel`
    and :func:`s2d_kernel_f`. Each conv is followed by its f32 BN affine
    and ReLU, rounded to ``dtype``. Returns (B, nc, H, W) f32 logits, or
    with ``s2d_head`` the (B, 4·nc, H/2, W/2) s2d(2) f32 logits."""
    xx = feats[0].to(dtype)
    for i, skip in enumerate(feats[1:]):
        xx = torch.cat([upsample2x(xx), skip.to(dtype)], dim=1)
        for cj in (1, 2):
            xx = _cbr(xx, prep[f"b{i}c{cj}"], dtype)
    xs = _cbr(_cbr(xx, prep["b4c1"], dtype), prep["b4c2"], dtype)
    kh, bh = prep["head"]
    y = conv(xs, kh) + bh
    return y if s2d_head else depth_to_space(y, 2)


def unet_segment_fast(net, prep: Dict[str, object], x: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """The Y-Net's plain encoder (``net.encode``, e.g. a
    :func:`~wsiseg_tpu_torch.models.ynet.compute_copy`) then
    :func:`decode_fast` (JAX ``unet_segment_fast``, ``:604-621``, which
    keeps the flax encoder for batched tiles): (B, nc, H, W) f32 logits of
    the normalized (B, 3, H, W) input, H and W even."""
    return decode_fast(prep, net.encode(x.to(dtype)), dtype)


# ---- FPN and PSPNet: native full-resolution logits ----

@torch.no_grad()
def prepare_native(model, dtype: torch.dtype) -> Dict[str, object]:
    """Weights of :func:`decode_native` for an FPN or PSPNet Y-Net, done
    once: OIHW kernels in ``dtype``, f32 BN affines and biases."""
    dec, head = model.decoder, model.segmentation_head[0]
    prep: Dict[str, object] = {
        "family": model.model_name, "upsample": model.head_upsample,
        "head": (oihw(hwio(head), dtype), _chan(head.bias.detach().float()))}
    if model.model_name == "FPN":
        for n in (5, 4, 3, 2):
            lat, seg = getattr(dec, f"lat{n}"), getattr(dec, f"seg{n}")
            prep[f"lat{n}"] = (oihw(hwio(lat), dtype),
                               _chan(lat.bias.detach().float()))
            prep[f"seg{n}"] = [_layer(getattr(seg, f"conv{k}"), dtype)
                               for k in range(max(seg.n_up, 1))]
    else:
        prep["bins"] = dec.bins
        prep["psp"] = [_layer(getattr(dec, f"psp{b}"), dtype)
                       for b in range(len(dec.bins))]
        prep["fuse"] = _layer(dec.fuse, dtype)
    return prep


def _fpn(prep: Dict[str, object], feats: List[torch.Tensor],
         dtype: torch.dtype) -> torch.Tensor:
    """JAX ``FPNDecoder`` up to its head: the (B, 128, H/4, W/4) merge.
    Rounding points as in the flax module applied in bf16: the lateral
    convs emit ``dtype``, each seg block's BN + ReLU output stays f32
    (resized and summed in f32), and a conv rounds its input to
    ``dtype``."""
    p, out = None, None
    for n, c in zip((5, 4, 3, 2), feats[:4]):
        k, b = prep[f"lat{n}"]
        lat = (conv(c.to(dtype), k, padding=0) + b).to(dtype)
        p = lat if p is None else lat + resize_nearest(p, *c.shape[2:])
        x = p
        for k, s, t in prep[f"seg{n}"]:
            x = torch.relu(conv(x.to(dtype), k) * s + t)
            if FPN_UPSAMPLES[n]:
                x = upsample2x(x)
        out = x if out is None else out + x
    return out


def _psp(prep: Dict[str, object], feats: List[torch.Tensor],
         dtype: torch.dtype) -> torch.Tensor:
    """JAX ``PSPDecoder`` up to its head: pooled pyramid over c5, one
    1×1 conv + BN + ReLU per bin resized back in f32, concat, 3×3 fuse."""
    c5 = feats[0].to(dtype)
    h, w = c5.shape[2:]
    outs = [c5]
    for (k, s, t), nbins in zip(prep["psp"], prep["bins"]):
        x = conv(psp_pool(c5, nbins).to(dtype), k, padding=0)
        outs.append(resize_linear(torch.relu(x * s + t), h, w).to(dtype))
    return _cbr(torch.cat(outs, dim=1), prep["fuse"], dtype)


def decode_native(prep: Dict[str, object], feats: List[torch.Tensor],
                  dtype: torch.dtype) -> torch.Tensor:
    """FPN or PSPNet forward on the whole-image pyramid (JAX
    ``infer_fast._apply_native_decoder``, which applies the flax decoder
    in bf16): decoder, 1×1 head, and the bilinear upsample to (B, nc, H,
    W) f32 logits. As there, the head's logits are rounded to ``dtype``
    and resized in ``dtype``."""
    body = _fpn if prep["family"] == "FPN" else _psp
    kh, bh = prep["head"]
    y = (conv(body(prep, feats, dtype).to(dtype), kh, padding=0)
         + bh).to(dtype)
    f = prep["upsample"]
    return resize_linear(y, f * y.shape[2], f * y.shape[3]).float()


# ---- fold route: decode_fold on the conv kernels ----

def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """Logical NCHW (channels_last in memory) → the NHWC view."""
    return x.permute(0, 2, 3, 1)


def _s2d_nhwc(x: torch.Tensor, f: int = 2) -> torch.Tensor:
    return space_to_depth(x.permute(0, 3, 1, 2), f).permute(0, 2, 3, 1)


def _d2s_nhwc(x: torch.Tensor, f: int = 2) -> torch.Tensor:
    return depth_to_space(x.permute(0, 3, 1, 2), f).permute(0, 2, 3, 1)


def _up2_nhwc(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c) \
        .reshape(b, 2 * h, 2 * w, c)


@torch.no_grad()
def prepare_fold(model, dtype: torch.dtype) -> Dict[str, list]:
    """All weight transforms of :func:`decode_fold`, done once: per layer
    group a list of ``(w (Cout, 9, Cin), bias f32, relu)`` from
    :func:`wsiseg_tpu_torch.ops.conv9.prep_layer` (BN scale folded in f32,
    rounded once to ``dtype``). Blocks 0-1 native; blocks 2-3 conv1 =
    ``concat([upfold(w1[:, :, :cup]), s2d(w1[:, :, cup:])], Cin)`` and
    conv2 = ``s2d(w2)`` with 4× tiled affines (JAX ``fast_decoder.py:
    446-450``); block4 + head ``upfold``, ``s2d``, ``s2d(head)`` with the
    tiled head bias (``:460-468``). Unlike :func:`prepare_decoder`'s cell
    layout, everything is s2d(2) and the head stays s2d(2)."""
    blocks = model.decoder.blocks
    prep: Dict[str, list] = {}

    def layer(k, bn, reps=1):
        s, t = _bn_affine(bn)
        return (*prep_layer(k, s.repeat(reps), t.repeat(reps), dtype), True)

    for i in (0, 1):
        prep[f"b{i}"] = [layer(hwio(getattr(blocks[i], f"conv{cj}")[0]),
                               getattr(blocks[i], f"conv{cj}")[1])
                         for cj in (1, 2)]
    for i in (2, 3):
        w1 = hwio(blocks[i].conv1[0])
        cup = blocks[i - 1].conv2[0].out_channels
        k1 = torch.cat([upfold_kernel(w1[:, :, :cup]),
                        s2d_kernel_f(w1[:, :, cup:], 2)], dim=2)
        prep[f"b{i}"] = [layer(k1, blocks[i].conv1[1], 4),
                         layer(s2d_kernel_f(hwio(blocks[i].conv2[0]), 2),
                               blocks[i].conv2[1], 4)]
    b4 = blocks[4]
    head = model.segmentation_head[0]
    prep["b4"] = [layer(upfold_kernel(hwio(b4.conv1[0])), b4.conv1[1], 4),
                  layer(s2d_kernel_f(hwio(b4.conv2[0]), 2), b4.conv2[1], 4),
                  (*prep_layer(s2d_kernel_f(hwio(head), 2), None,
                               head.bias.detach().float().repeat(4), dtype),
                   False)]
    return prep


def _run_layers(x: torch.Tensor, layers, out_dtype=torch.bfloat16,
                use_chain: bool = True) -> torch.Tensor:
    """A layer group (JAX ``_run_layers``, ``fast_decoder.py:42``): one
    fused :func:`conv_chain` launch, or :func:`conv9` per layer with bf16
    between layers."""
    if use_chain:
        return conv_chain(x, layers, out_dtype)
    for i, (w, b, relu) in enumerate(layers):
        x = conv9(x, w, b, relu,
                  out_dtype if i + 1 == len(layers) else torch.bfloat16)
    return x


def decode_fold(prep: Dict[str, list], feats: List[torch.Tensor],
                dtype: torch.dtype, use_chain: bool = False,
                planar_head: bool = False) -> torch.Tensor:
    """U-Net decoder forward with blocks 2-4 + head in the s2d(2) domain,
    each layer group on the conv kernels — JAX ``decode_fold``
    (``fast_decoder.py:383-485``), with a batch dimension. ``feats`` are
    the encoder's [c5, c4, c3, c2, c1] (B, C, h, w), native c1 (stage
    dims even). Rounding points as in JAX: every group but the last
    emits bf16; the block4 + head group emits f32 logits. The glue
    between groups (upsample, concat, space_to_depth, depth_to_space)
    stays torch ops, as it is XLA in JAX.

    ``use_chain`` runs each group as one :func:`conv_chain` launch instead
    of :func:`conv9` per layer. It defaults to False, unlike JAX: on the
    H100 the per-layer route is the faster one and the one the engine
    serves (``PERF.md`` §6).

    ``planar_head=True`` returns the (B, 4·nc, H/2, W/2) s2d(2) head
    logits (channel pos·nc + c) without the final depth_to_space;
    otherwise (B, nc, H, W) f32."""
    xx = _nhwc(feats[0]).to(dtype)
    skips = [_nhwc(f) for f in feats[1:]]
    for i in (0, 1):
        xx = torch.cat([_up2_nhwc(xx).to(dtype), skips[i].to(dtype)], dim=3)
        xx = _run_layers(xx, prep[f"b{i}"], use_chain=use_chain)
    x = xx                                  # (B, H/8, W/8, 128) native
    for i in (2, 3):
        xin = torch.cat([x.to(dtype), _s2d_nhwc(skips[i].to(dtype))], dim=3)
        x = _run_layers(xin, prep[f"b{i}"], use_chain=use_chain)
        if i < 3:
            x = _d2s_nhwc(x)                # native for the next upfold
    y = _run_layers(_d2s_nhwc(x).to(dtype), prep["b4"],
                    out_dtype=torch.float32, use_chain=use_chain)
    if planar_head:
        return y.permute(0, 3, 1, 2)
    return _d2s_nhwc(y).permute(0, 3, 1, 2)
