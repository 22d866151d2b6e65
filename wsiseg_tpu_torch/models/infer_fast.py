"""Whole-image dense-inference forward: fused stem kernel + functional
Y-Net — counterpart of ``wsiseg_tpu/models/infer_fast.py`` (the non-fold
v2 branch of ``_segment_from_packed``, Unet decoder).

The raw u8 level image goes straight to the fused stem
(:mod:`wsiseg_tpu_torch.ops.stem`), which emits ``space_to_depth(c1)``
and the pooled c1; the ResNet stages (:func:`.fast_encoder.encode_stages`)
and the cell-domain Unet tail (:func:`.fast_decoder.decode_cells`) follow
from weights prepared once by :func:`prepare_fast`. No TPU sublane packer
is needed: the stem kernel reads NHWC u8 and pads the 3-px ring itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from wsiseg_tpu_torch.models.fast_decoder import decode_cells, prepare_decoder
from wsiseg_tpu_torch.models.fast_encoder import encode_stages, prepare_encoder
from wsiseg_tpu_torch.ops.stem import fold_from_encoder, pad_value, \
    stem_pool_conv


@dataclass
class FastWeights:
    """Everything the whole-image forward reads, prepared once."""
    stem_w: torch.Tensor          # (7, 7, 3, 64), normalize+BN folded
    stem_b: torch.Tensor          # (64,) f32
    pad_rgb: Tuple[int, int, int]
    enc: List[List[Dict[str, object]]]
    dec: Dict[str, object]
    dtype: torch.dtype


@torch.no_grad()
def prepare_fast(model, mean: Sequence[float], std: Sequence[float],
                 dtype: torch.dtype) -> FastWeights:
    # the stem runs in bf16 (the kernel's contract) unless an f32 oracle
    # run asks for f32 throughout
    w, b = fold_from_encoder(model.encoder, mean, std,
                             torch.float32 if dtype == torch.float32
                             else torch.bfloat16)
    return FastWeights(w, b, pad_value(mean),
                       prepare_encoder(model.encoder, dtype),
                       prepare_decoder(model, dtype), dtype)


@torch.no_grad()
def segment_from_image(fw: FastWeights, img_u8: torch.Tensor,
                       planar_head: bool = True) -> torch.Tensor:
    """(N, H, W, 3) u8 (H, W multiples of 32) → head logits: (N, 16·nc,
    H/4, W/4) s2d(4) planes in the compute dtype (``planar_head``), else
    (N, nc, H, W) f32."""
    c1s2d, pool = stem_pool_conv(img_u8, fw.stem_w, fw.stem_b, fw.pad_rgb)
    # NHWC kernel outputs are the channels_last NCHW tensors, no copy
    feats = encode_stages(fw.enc, pool.permute(0, 3, 1, 2), fw.dtype)
    return decode_cells(fw.dec, feats, fw.dtype, s2d_head=planar_head,
                        skip3_s2d=c1s2d.permute(0, 3, 1, 2))


def segment_whole_image(model, img_u8: np.ndarray, dataset_mean,
                        dataset_std, dtype: torch.dtype = torch.bfloat16,
                        planar_head: bool = False,
                        device=None) -> torch.Tensor:
    """Dense logits for one (H, W, 3) u8 image: (H, W, nc) f32, or the
    (H/4, W/4, 16·nc) planar s2d(4) head with ``planar_head`` — the JAX
    function's layouts. ``device`` defaults to the model's."""
    device = device or next(model.parameters()).device
    fw = prepare_fast(model, dataset_mean, dataset_std, dtype)
    img = torch.from_numpy(np.ascontiguousarray(img_u8))[None].to(device)
    return segment_from_image(fw, img, planar_head)[0].permute(1, 2, 0)
