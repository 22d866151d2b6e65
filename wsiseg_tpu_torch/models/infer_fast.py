"""Whole-image dense-inference forward: stem kernel + functional Y-Net —
counterpart of ``wsiseg_tpu/models/infer_fast.py``
(``_segment_from_packed``), in its two branches:

- default (JAX v2 branch, ``infer_fast.py:192-227``), every decoder family
  and encoder: the fused stem
  (:func:`wsiseg_tpu_torch.ops.stem.stem_pool_conv`) emits
  ``space_to_depth(c1)`` and the pooled c1; the ResNet stages
  (:func:`.fast_encoder.encode_stages`, Basic or Bottleneck blocks) follow,
  then the family's decoder: the cell-domain Unet tail
  (:func:`.fast_decoder.decode_cells`) or Linknet tail
  (:func:`.fast_decoder.decode_linknet_cells`), both taking the stem's
  ``space_to_depth(c1)`` as their block-3 skip and emitting s2d(4) head
  planes, or FPN/PSPNet (:func:`.fast_decoder.decode_native`, native
  full-resolution logits: ``NATIVE_DECODERS``, laid out as the same
  s2d(4) planes by :func:`decode`);
- the transformers (no JAX counterpart): SegFormer's MiT under FPN and
  Swin under UPerNet. The u8 image normalised in float32 and rounded to
  the compute dtype, the patch embeddings and stages
  (:func:`.mit.encode_image`, :func:`.swin.encode_image`), then
  :func:`.fast_decoder.decode_native`, as every FPN; no stem kernel;
- fold (``infer_fast.py:229-253``), Unet on BasicBlock encoders only: the
  native stem (:func:`wsiseg_tpu_torch.ops.stem.stem_conv`) emits c1, the
  stages start from its max-pool, and :func:`.fast_decoder.decode_fold`
  runs the decoder on the conv kernels (:mod:`wsiseg_tpu_torch.ops.conv9`).
  Any other pair raises ``ValueError`` (:func:`check_fold`), where the
  JAX fold branch runs BasicBlock code on Bottleneck parameters
  (ROADMAP.md §3).

Weights, the stem kernel's cell-form operand included, are prepared once
by :func:`prepare_fast`, with the facts the engine needs about the model
(:class:`FastWeights`: the fused route's peak bytes a pixel, its width
alignment, whether a halo makes a chunk exact). The forward runs in
ranges ``fast.stem``, ``fast.encode`` and ``fast.decode`` (MiT: the last
two). No TPU sublane packer
is needed: the stem kernels read NHWC u8 and pad the 3-px ring
themselves.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from wsiseg_tpu_torch.models.fast_decoder import (S2D_HEAD_F, decode_cells,
                                                  decode_fold,
                                                  decode_linknet_cells,
                                                  decode_native,
                                                  prepare_decoder,
                                                  prepare_fold,
                                                  prepare_linknet,
                                                  prepare_native,
                                                  space_to_depth)
from wsiseg_tpu_torch.models.fast_encoder import encode_stages, prepare_encoder
from wsiseg_tpu_torch.models import mit, swin
from wsiseg_tpu_torch.models.resnet import is_bottleneck
from wsiseg_tpu_torch.ops.stem import fold_from_encoder, pad_value, \
    prepare_stem_cells, stem_conv, stem_pool_conv

#: decoders whose forward emits native (N, nc, H, W) logits; Unet and
#: Linknet emit s2d(4) head planes
NATIVE_DECODERS = ("FPN", "PSPNet", "UPerNet")
#: Peak device bytes per padded pixel of the fused whole-image route, for
#: the widest ResNet family one card serves: resnet50 Linknet, 6.7607 GB
#: around ``device_throughput`` at one 3072×4096 slide = 537.3 B/px
#: (resnet18 Unet 341.1; NVIDIA H100 80GB HBM3, ``chip_smoke.py``, PERF.md
#: §5). MiT's is :data:`.mit.MIT_PEAK_BYTES_PER_PX`, Swin's
#: :data:`.swin.SWIN_PEAK_BYTES_PER_PX`.
FCN_PEAK_BYTES_PER_PX = 538
_PREPARE = {"Unet": prepare_decoder, "Linknet": prepare_linknet,
            "FPN": prepare_native, "PSPNet": prepare_native,
            "UPerNet": prepare_native}
#: the transformer encoders by family: (is_family(arch), prepare,
#: encode_image, the fused route's peak bytes a padded pixel)
TRANSFORMERS = {
    "mit": (mit.is_mit, mit.prepare_mit, mit.encode_image,
            mit.MIT_PEAK_BYTES_PER_PX),
    "swin": (swin.is_swin, swin.prepare_swin, swin.encode_image,
             swin.SWIN_PEAK_BYTES_PER_PX)}


def check_fold(model) -> None:
    """The fold route serves Unet on BasicBlock encoders only (JAX gates it
    to Unet, ``engine.py:470-471``, and its fold branch has no Bottleneck
    path, ``infer_fast.py:246``): raise ``ValueError`` for any other
    model."""
    if model.model_name != "Unet" or is_bottleneck(model.arch):
        raise ValueError(
            f"the fold route (fcn_fold) serves Unet on BasicBlock encoders "
            f"(resnet18/34) only, not {model.model_name} on {model.arch}")


@dataclass
class FastWeights:
    """Everything the whole-image forward reads, prepared once, and what
    the engine needs to know of the model. A transformer (``encoder``
    "mit" or "swin") has no stem (``stem_w``, ``stem_b`` and ``pad_rgb``
    None), ``enc`` is :func:`.mit.prepare_mit`'s or
    :func:`.swin.prepare_swin`'s, and its attention sees every pixel of
    the padded image (MiT's keys; Swin's windows and edge padding): its
    slides are padded only to multiples of 32 (``w_align``), and no halo
    makes a chunk of one exact (``chunk_exact``)."""
    stem_w: Optional[torch.Tensor]   # (7, 7, 3, 64), normalize+BN folded
    stem_b: Optional[torch.Tensor]   # (64,) f32
    pad_rgb: Optional[Tuple[int, int, int]]
    enc: object
    dec: Dict[str, object]
    dtype: torch.dtype
    family: str = "Unet"          # the model's decoder
    fold: Optional[Dict[str, list]] = None   # decode_fold's layer groups
    stem_cells: Optional[torch.Tensor] = None  # the stem kernel's operand
    encoder: str = "resnet"       # "resnet", or a key of TRANSFORMERS
    peak_bytes_per_px: int = FCN_PEAK_BYTES_PER_PX  # fused route's B/px
    w_align: int = 256            # padded width's multiple: K1's row blocks
    chunk_exact: bool = True      # a halo makes a chunk of a slide exact

    @property
    def native(self) -> bool:
        """The decoder computes native full-resolution logits (FPN,
        PSPNet), which :func:`decode` lays out as head planes."""
        return self.family in NATIVE_DECODERS


@torch.no_grad()
def prepare_fast(model, mean: Sequence[float], std: Sequence[float],
                 dtype: torch.dtype, fold: bool = False) -> FastWeights:
    """Weights of :func:`segment_from_image`; ``fold`` also prepares the
    fold route's decoder (:func:`prepare_fold`; Unet on BasicBlock
    encoders only, :func:`check_fold`)."""
    if fold:
        check_fold(model)
    for family, (is_family, prepare, _, peak) in TRANSFORMERS.items():
        if is_family(model.arch):
            return FastWeights(None, None, None,
                               prepare(model.encoder, mean, std, dtype),
                               _PREPARE[model.model_name](model, dtype),
                               dtype, model.model_name, encoder=family,
                               peak_bytes_per_px=peak, w_align=32,
                               chunk_exact=False)
    # the stem runs in bf16 (the kernel's contract) unless an f32 oracle
    # run asks for f32 throughout
    w, b = fold_from_encoder(model.encoder, mean, std,
                             torch.float32 if dtype == torch.float32
                             else torch.bfloat16)
    return FastWeights(w, b, pad_value(mean),
                       prepare_encoder(model.encoder, dtype),
                       _PREPARE[model.model_name](model, dtype), dtype,
                       model.model_name,
                       prepare_fold(model, dtype) if fold else None,
                       prepare_stem_cells(w))


@torch.no_grad()
def segment_from_image(fw: FastWeights, img_u8: torch.Tensor,
                       planar_head: bool = True,
                       fold: bool = False) -> torch.Tensor:
    """(N, H, W, 3) u8 (H, W multiples of 32) → head logits. Default route:
    (N, 16·nc, H/4, W/4) s2d(4) planes (``planar_head``; FPN, PSPNet and
    UPerNet, a transformer's included, give their f32 logits in this
    layout), in the compute dtype for Unet and Linknet, else (N, nc, H, W)
    f32.
    ``fold=True`` (weights from ``prepare_fast(..., fold=True)``): native
    stem, encoder, and :func:`decode_fold` on ``conv9`` per layer (the JAX
    engine's ``use_chain=False``), giving (N, 4·nc, H/2, W/2) s2d(2) f32
    planes (``planar_head``), else (N, nc, H, W) f32. Ranges
    ``fast.stem`` (not for a transformer), ``fast.encode``,
    ``fast.decode``."""
    if fw.encoder in TRANSFORMERS:
        with record_function("fast.encode"):
            feats = TRANSFORMERS[fw.encoder][2](fw.enc, img_u8)
        with record_function("fast.decode"):
            return decode(fw, feats, None, planar_head)
    if fold:
        if fw.fold is None:
            raise ValueError("fold=True needs prepare_fast(..., fold=True)")
        with record_function("fast.stem"):
            c1 = stem_conv(img_u8, fw.stem_w, fw.stem_b, fw.pad_rgb,
                           fw.stem_cells)
        with record_function("fast.encode"):
            feats = encode_stages(fw.enc, None, fw.dtype,
                                  c1=c1.permute(0, 3, 1, 2))
        with record_function("fast.decode"):
            return decode_fold(fw.fold, feats, fw.dtype, use_chain=False,
                               planar_head=planar_head)
    with record_function("fast.stem"):
        c1s2d, pool = stem_pool_conv(img_u8, fw.stem_w, fw.stem_b,
                                     fw.pad_rgb, fw.stem_cells)
    # NHWC kernel outputs are the channels_last NCHW tensors, no copy
    with record_function("fast.encode"):
        feats = encode_stages(fw.enc, pool.permute(0, 3, 1, 2), fw.dtype)
    with record_function("fast.decode"):
        return decode(fw, feats, c1s2d.permute(0, 3, 1, 2), planar_head)


def decode(fw: FastWeights, feats: List[torch.Tensor],
           skip3_s2d: torch.Tensor, planar_head: bool = True
           ) -> torch.Tensor:
    """The default route's decoder for the model's family, on the
    encoder's pyramid and the stem's ``space_to_depth(c1)``: Unet's or
    Linknet's cell-domain tail, or FPN's / PSPNet's native (N, nc, H, W)
    f32 logits; with ``planar_head`` each gives s2d(4) planes, channel
    pos·nc + c (the native logits through ``space_to_depth``)."""
    if fw.native:
        seg = decode_native(fw.dec, feats, fw.dtype)
        return space_to_depth(seg, S2D_HEAD_F) if planar_head else seg
    tail = decode_cells if fw.family == "Unet" else decode_linknet_cells
    return tail(fw.dec, feats, fw.dtype, s2d_head=planar_head,
                skip3_s2d=skip3_s2d)


def segment_whole_image(model, img_u8: np.ndarray, dataset_mean,
                        dataset_std, dtype: torch.dtype = torch.bfloat16,
                        planar_head: bool = False, device=None,
                        fold: bool = False) -> torch.Tensor:
    """Dense logits for one (H, W, 3) u8 image: (H, W, nc) f32, or the
    planar head with ``planar_head`` — (H/4, W/4, 16·nc) s2d(4), or
    (H/2, W/2, 4·nc) s2d(2) with ``fold`` — the JAX function's layouts
    (``infer_fast.py:268-286``); FPN and PSPNet ignore ``planar_head``, as
    there. ``device`` defaults to the model's."""
    device = device or next(model.parameters()).device
    fw = prepare_fast(model, dataset_mean, dataset_std, dtype, fold=fold)
    img = torch.from_numpy(np.ascontiguousarray(img_u8))[None].to(device)
    return segment_from_image(fw, img, planar_head and not fw.native,
                              fold=fold)[0].permute(1, 2, 0)
