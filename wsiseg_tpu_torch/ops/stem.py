"""Fused ResNet stem: u8 → normalize → 7×7/2 conv → BN → ReLU → (s2d(c1),
3×3/2 max-pool) — the port of ``wsiseg_tpu/ops/pallas_stem.py``
(``stem_pool_conv`` / ``_stem2_kernel``, with ``fold_stem_weights2``).

On a CUDA tensor :func:`stem_pool_conv` launches the hand-written kernel
in ``wsiseg_tpu_torch/csrc/stem.cu`` (built with ``nvcc`` for ``sm_90a`` at
first use, bound with ``ctypes``) or raises; on a CPU tensor it runs the
plain PyTorch version :func:`stem_pool_conv_ref`. ``LAUNCHES`` counts the
kernel launches.

Numerics, shared by both versions: normalize and BN fold into the conv
(``w·s[c]·g[co]`` and bias ``Σ w·t·g + b``, in f32), the folded weights
are rounded to bf16 as on the TPU (kept f32 only for the plain version's
f32 oracle runs), products of u8 pixels and bf16 weights
are exact in f32, sums are f32, and both outputs are rounded to bf16 after
+bias and ReLU. The image's 3-px border reads as the per-channel pad value
``clip(round(255·mean))``, the u8 value closest to normalized zero.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wsiseg_tpu_torch.models.fast_decoder import space_to_depth

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None
_lib_lock = threading.Lock()


def pad_value(mean: Sequence[float]) -> Tuple[int, int, int]:
    """Per-channel u8 value closest to normalized zero."""
    v = np.clip(np.round(255.0 * np.asarray(mean, np.float64)), 0, 255)
    return tuple(int(x) for x in v)


@torch.no_grad()
def fold_stem_weights(kernel: torch.Tensor, bn_scale: torch.Tensor,
                      bn_bias: torch.Tensor, bn_mean: torch.Tensor,
                      bn_var: torch.Tensor, mean: Sequence[float],
                      std: Sequence[float], eps: float = 1e-5,
                      dtype: torch.dtype = torch.bfloat16
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold normalize((u8/255 - mean)/std) + conv + BN into the stem's
    weights. ``kernel`` is the (64, 3, 7, 7) OIHW conv weight. Returns
    (w_folded (7, 7, 3, 64) — flattened, row (ky·7 + kx)·3 + c — and bias
    (64,) f32). The kernel takes bf16 weights, as the TPU kernel;
    ``dtype=torch.float32`` keeps the fold unrounded for the plain
    version's f32 oracle runs."""
    dev = kernel.device
    mean = torch.tensor(mean, dtype=torch.float32, device=dev)
    std = torch.tensor(std, dtype=torch.float32, device=dev)
    s = 1.0 / (255.0 * std)
    t = -mean / std
    w = kernel.float().permute(2, 3, 1, 0)             # (7, 7, 3, 64)
    g = bn_scale.float() * torch.rsqrt(bn_var.float() + eps)
    b = bn_bias.float() - bn_mean.float() * g
    w_scaled = w * s[None, None, :, None] * g[None, None, None, :]
    bias = torch.einsum("yxc,yxco->o", t.expand(7, 7, 3), w) * g + b
    return w_scaled.to(dtype).contiguous(), bias.contiguous()


def fold_from_encoder(encoder, mean, std, dtype=torch.bfloat16):
    """:func:`fold_stem_weights` from a ResNetEncoder's conv1/bn1."""
    bn = encoder.bn1
    return fold_stem_weights(encoder.conv1.weight, bn.weight, bn.bias,
                             bn.running_mean, bn.running_var, mean, std,
                             bn.eps, dtype)


@torch.no_grad()
def stem_pool_conv_ref(img_u8: torch.Tensor, w_folded: torch.Tensor,
                       bias: torch.Tensor, pad_rgb: Sequence[int]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel. img_u8 (N, H, W, 3) uint8,
    H and W multiples of 4. Returns (c1s2d (N, H/4, W/4, 256), pool
    (N, H/4, W/4, 64)) NHWC in ``w_folded``'s dtype (bf16 as the kernel,
    f32 for an unrounded oracle)."""
    n, h, w, _ = img_u8.shape
    pad = torch.tensor(pad_rgb, dtype=torch.float32, device=img_u8.device)
    canvas = pad.view(1, 3, 1, 1).repeat(n, 1, h + 6, w + 6)
    canvas[:, :, 3:3 + h, 3:3 + w] = img_u8.permute(0, 3, 1, 2).float()
    k = w_folded.float().permute(3, 2, 0, 1)          # OIHW
    c1 = torch.relu(F.conv2d(canvas, k, stride=2) + bias.view(1, -1, 1, 1))
    c1s2d = space_to_depth(c1).permute(0, 2, 3, 1)
    pool = F.max_pool2d(c1, 3, 2, 1).permute(0, 2, 3, 1)
    return (c1s2d.to(w_folded.dtype).contiguous(),
            pool.to(w_folded.dtype).contiguous())


def _source_key(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into ``_build/`` (once per source/flag hash,
    under a file lock so concurrent processes do not race). Raises with
    nvcc's stderr if the build fails."""
    sources = sorted(CSRC.glob("*.cu"))
    out = BUILD_DIR / f"libwsiseg_kernels_{_source_key(sources)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}): "
                               f"{' '.join(cmd)}\n{r.stderr}")
        os.replace(tmp, out)
    return out


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            fn = lib.wsiseg_stem_pool_conv
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p] * 3)
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def stem_pool_conv(img_u8: torch.Tensor, w_folded: torch.Tensor,
                   bias: torch.Tensor, pad_rgb: Sequence[int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused stem forward. img_u8 (N, H, W, 3) uint8 NHWC, H and W
    multiples of 4; w_folded (7, 7, 3, 64) bf16 and bias (64,) f32 from
    :func:`fold_stem_weights`. Returns (c1s2d (N, H/4, W/4, 256), pool
    (N, H/4, W/4, 64)) bf16 NHWC. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    global LAUNCHES
    if img_u8.dim() != 4 or img_u8.shape[3] != 3 \
            or img_u8.shape[1] % 4 or img_u8.shape[2] % 4:
        raise ValueError(f"img_u8 must be (N, H, W, 3) with H, W multiples "
                         f"of 4, got {tuple(img_u8.shape)}")
    if img_u8.device.type == "cpu":
        return stem_pool_conv_ref(img_u8, w_folded, bias, pad_rgb)
    if img_u8.device.type != "cuda":
        raise ValueError(f"no stem kernel for device {img_u8.device}")
    n, h, w, _ = img_u8.shape
    dev = img_u8.device
    _check(img_u8, "img_u8", torch.uint8, (n, h, w, 3), dev)
    _check(w_folded, "w_folded", torch.bfloat16, (7, 7, 3, 64), dev)
    _check(bias, "bias", torch.float32, (64,), dev)
    fn = _library().wsiseg_stem_pool_conv
    c1s2d = torch.empty((n, h // 4, w // 4, 256), dtype=torch.bfloat16,
                        device=dev)
    pool = torch.empty((n, h // 4, w // 4, 64), dtype=torch.bfloat16,
                       device=dev)
    with torch.cuda.device(dev):
        err = fn(img_u8.data_ptr(), w_folded.data_ptr(), bias.data_ptr(),
                 n, h, w, *(int(v) for v in pad_rgb), c1s2d.data_ptr(),
                 pool.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stem kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return c1s2d, pool
