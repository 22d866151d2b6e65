"""Whole-image dense-inference forward: stem kernel + functional Y-Net —
counterpart of ``wsiseg_tpu/models/infer_fast.py``
(``_segment_from_packed``, Unet decoder), in its two branches:

- default (JAX v2 branch, ``infer_fast.py:192-227``): the fused stem
  (:func:`wsiseg_tpu_torch.ops.stem.stem_pool_conv`) emits
  ``space_to_depth(c1)`` and the pooled c1; the ResNet stages
  (:func:`.fast_encoder.encode_stages`) and the cell-domain Unet tail
  (:func:`.fast_decoder.decode_cells`) follow;
- fold (``infer_fast.py:229-253``): the native stem
  (:func:`wsiseg_tpu_torch.ops.stem.stem_conv`) emits c1, the stages start
  from its max-pool, and :func:`.fast_decoder.decode_fold` runs the decoder
  on the conv kernels (:mod:`wsiseg_tpu_torch.ops.conv9`).

Weights, the stem kernel's cell-form operand included, are prepared once
by :func:`prepare_fast`. No TPU sublane packer
is needed: the stem kernels read NHWC u8 and pad the 3-px ring
themselves.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from wsiseg_tpu_torch.models.fast_decoder import (decode_cells, decode_fold,
                                                  prepare_decoder,
                                                  prepare_fold)
from wsiseg_tpu_torch.models.fast_encoder import encode_stages, prepare_encoder
from wsiseg_tpu_torch.ops.stem import fold_from_encoder, pad_value, \
    prepare_stem_cells, stem_conv, stem_pool_conv


@dataclass
class FastWeights:
    """Everything the whole-image forward reads, prepared once."""
    stem_w: torch.Tensor          # (7, 7, 3, 64), normalize+BN folded
    stem_b: torch.Tensor          # (64,) f32
    pad_rgb: Tuple[int, int, int]
    enc: List[List[Dict[str, object]]]
    dec: Dict[str, object]
    dtype: torch.dtype
    fold: Optional[Dict[str, list]] = None   # decode_fold's layer groups
    stem_cells: Optional[torch.Tensor] = None  # the stem kernel's operand


@torch.no_grad()
def prepare_fast(model, mean: Sequence[float], std: Sequence[float],
                 dtype: torch.dtype, fold: bool = False) -> FastWeights:
    """Weights of :func:`segment_from_image`; ``fold`` also prepares the
    fold route's decoder (:func:`prepare_fold`)."""
    # the stem runs in bf16 (the kernel's contract) unless an f32 oracle
    # run asks for f32 throughout
    w, b = fold_from_encoder(model.encoder, mean, std,
                             torch.float32 if dtype == torch.float32
                             else torch.bfloat16)
    return FastWeights(w, b, pad_value(mean),
                       prepare_encoder(model.encoder, dtype),
                       prepare_decoder(model, dtype), dtype,
                       prepare_fold(model, dtype) if fold else None,
                       prepare_stem_cells(w))


@torch.no_grad()
def segment_from_image(fw: FastWeights, img_u8: torch.Tensor,
                       planar_head: bool = True,
                       fold: bool = False) -> torch.Tensor:
    """(N, H, W, 3) u8 (H, W multiples of 32) → head logits. Default route:
    (N, 16·nc, H/4, W/4) s2d(4) planes in the compute dtype
    (``planar_head``), else (N, nc, H, W) f32. ``fold=True`` (weights from
    ``prepare_fast(..., fold=True)``): native stem, encoder, and
    :func:`decode_fold` on ``conv9`` per layer (the JAX engine's
    ``use_chain=False``), giving (N, 4·nc, H/2, W/2) s2d(2) f32 planes
    (``planar_head``), else (N, nc, H, W) f32."""
    if fold:
        if fw.fold is None:
            raise ValueError("fold=True needs prepare_fast(..., fold=True)")
        c1 = stem_conv(img_u8, fw.stem_w, fw.stem_b, fw.pad_rgb,
                       fw.stem_cells)
        feats = encode_stages(fw.enc, None, fw.dtype,
                              c1=c1.permute(0, 3, 1, 2))
        return decode_fold(fw.fold, feats, fw.dtype, use_chain=False,
                           planar_head=planar_head)
    c1s2d, pool = stem_pool_conv(img_u8, fw.stem_w, fw.stem_b, fw.pad_rgb,
                                 fw.stem_cells)
    # NHWC kernel outputs are the channels_last NCHW tensors, no copy
    feats = encode_stages(fw.enc, pool.permute(0, 3, 1, 2), fw.dtype)
    return decode_cells(fw.dec, feats, fw.dtype, s2d_head=planar_head,
                        skip3_s2d=c1s2d.permute(0, 3, 1, 2))


def segment_whole_image(model, img_u8: np.ndarray, dataset_mean,
                        dataset_std, dtype: torch.dtype = torch.bfloat16,
                        planar_head: bool = False, device=None,
                        fold: bool = False) -> torch.Tensor:
    """Dense logits for one (H, W, 3) u8 image: (H, W, nc) f32, or the
    planar head with ``planar_head`` — (H/4, W/4, 16·nc) s2d(4), or
    (H/2, W/2, 4·nc) s2d(2) with ``fold`` — the JAX function's layouts
    (``infer_fast.py:268-286``). ``device`` defaults to the model's."""
    device = device or next(model.parameters()).device
    fw = prepare_fast(model, dataset_mean, dataset_std, dtype, fold=fold)
    img = torch.from_numpy(np.ascontiguousarray(img_u8))[None].to(device)
    return segment_from_image(fw, img, planar_head,
                              fold=fold)[0].permute(1, 2, 0)
