"""Fused ResNet stem: u8 → normalize → 7×7/2 conv → BN → ReLU — the port of
``wsiseg_tpu/ops/pallas_stem.py``, in two modes of one CUDA kernel:

- :func:`stem_pool_conv` emits (s2d(c1), 3×3/2 max-pool): the port of
  ``stem_pool_conv`` (``pallas_stem.py:319``, body ``_stem2_kernel``
  ``:244``, with ``fold_stem_weights2``); ``LAUNCHES`` counts its launches;
- :func:`stem_conv` emits native c1 (N, H/2, W/2, 64): the port of
  ``stem_conv`` (``pallas_stem.py:124``, body ``_stem_kernel`` ``:79``, with
  ``fold_stem_weights``); ``STEM_CONV_LAUNCHES`` counts its launches.

Both JAX folds fold the same way, so both modes take the weights of
:func:`fold_stem_weights`. On a CUDA tensor each wrapper launches the
hand-written kernel in ``wsiseg_tpu_torch/csrc/stem.cu`` (built with
``nvcc`` for ``sm_90a`` at first use, bound with ``ctypes``) or raises; on
a CPU tensor it runs its plain PyTorch version (:func:`stem_pool_conv_ref`,
:func:`stem_conv_ref`).

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

#: stem_pool_conv kernel launches since import (or since a caller reset
#: it to 0)
LAUNCHES = 0
#: stem_conv kernel launches, likewise
STEM_CONV_LAUNCHES = 0

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
#: per-source compile only: ptxas's register / shared-memory / spill report
#: goes to ``_build/<source>_<key>.log`` (:func:`ptxas_report`)
PTXAS_VERBOSE = ("-Xptxas", "-v")

_lib = None
_lib_lock = threading.Lock()
_entries = {}
_P = ctypes.c_void_p
# image, weights, bias; n, h, w; pad RGB — the stem entries' common head
_STEM_ARGS = [_P] * 3 + [ctypes.c_int] * 6


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


def _c1_ref(img_u8: torch.Tensor, w_folded: torch.Tensor,
            bias: torch.Tensor, pad_rgb: Sequence[int]) -> torch.Tensor:
    """f32 c1 (N, 64, H/2, W/2) of the folded stem, unrounded."""
    n, h, w, _ = img_u8.shape
    pad = torch.tensor(pad_rgb, dtype=torch.float32, device=img_u8.device)
    canvas = pad.view(1, 3, 1, 1).repeat(n, 1, h + 6, w + 6)
    canvas[:, :, 3:3 + h, 3:3 + w] = img_u8.permute(0, 3, 1, 2).float()
    k = w_folded.float().permute(3, 2, 0, 1)          # OIHW
    return torch.relu(F.conv2d(canvas, k, stride=2) + bias.view(1, -1, 1, 1))


@torch.no_grad()
def stem_conv_ref(img_u8: torch.Tensor, w_folded: torch.Tensor,
                  bias: torch.Tensor, pad_rgb: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version of the native-mode kernel. img_u8 (N, H, W, 3)
    uint8, H and W even. Returns c1 (N, H/2, W/2, 64) NHWC in
    ``w_folded``'s dtype (bf16 as the kernel, f32 for an unrounded
    oracle)."""
    c1 = _c1_ref(img_u8, w_folded, bias, pad_rgb)
    return c1.permute(0, 2, 3, 1).to(w_folded.dtype).contiguous()


@torch.no_grad()
def stem_pool_conv_ref(img_u8: torch.Tensor, w_folded: torch.Tensor,
                       bias: torch.Tensor, pad_rgb: Sequence[int]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the pool-mode kernel. img_u8 (N, H, W, 3)
    uint8, H and W multiples of 4. Returns (c1s2d (N, H/4, W/4, 256), pool
    (N, H/4, W/4, 64)) NHWC in ``w_folded``'s dtype (bf16 as the kernel,
    f32 for an unrounded oracle)."""
    from wsiseg_tpu_torch.models.fast_decoder import space_to_depth

    c1 = _c1_ref(img_u8, w_folded, bias, pad_rgb)
    c1s2d = space_to_depth(c1).permute(0, 2, 3, 1)
    pool = F.max_pool2d(c1, 3, 2, 1).permute(0, 2, 3, 1)
    return (c1s2d.to(w_folded.dtype).contiguous(),
            pool.to(w_folded.dtype).contiguous())


def _source_key(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + PTXAS_VERBOSE).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build_key() -> str:
    return _source_key(sorted(CSRC.glob("*.cu"))
                       + sorted(CSRC.glob("*.cuh")))


def build_library() -> Path:
    """Compile ``csrc/*.cu`` (which include ``csrc/*.cuh``) into
    ``_build/`` (once per source/flag hash, under a file lock so concurrent
    processes do not race): one ``nvcc`` per source, all started together,
    then one link. Raises with nvcc's stderr if a step fails."""
    sources = sorted(CSRC.glob("*.cu"))
    key = _build_key()
    out = BUILD_DIR / f"libwsiseg_kernels_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        objs = [BUILD_DIR / f"{src.stem}_{key}.o" for src in sources]
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True))
                 for cmd in ([nvcc, *NVCC_FLAGS, *PTXAS_VERBOSE, "-c", "-o",
                              str(obj), str(src)]
                             for src, obj in zip(sources, objs))]
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                *map(str, objs)]
        for src, (cmd, proc) in zip(sources, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{err}")
            (BUILD_DIR / f"{src.stem}_{key}.log").write_text(err)
        r = subprocess.run(link, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}): "
                               f"{' '.join(link)}\n{r.stderr}")
        os.replace(tmp, out)
    return out


def ptxas_report(source: str) -> str:
    """ptxas's ``-v`` report (registers, shared memory, spills per kernel)
    from the last build of ``csrc/<source>.cu``."""
    build_library()
    return (BUILD_DIR / f"{source}_{_build_key()}.log").read_text()


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build_library()))
    return _lib


def kernel_entry(name: str, argtypes):
    """The library's C entry ``name`` with its argument types declared
    (pointers and the stream as ``c_void_p``, ints as ``c_int``); every
    entry returns its CUDA error code."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(_library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
                 device: torch.device) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous ``dtype`` tensor
    of ``shape`` on ``device``."""
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
    _check_stem_args(img_u8, w_folded, bias)
    fn = kernel_entry("wsiseg_stem_pool_conv", _STEM_ARGS + [_P] * 3)
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


def stem_conv(img_u8: torch.Tensor, w_folded: torch.Tensor,
              bias: torch.Tensor, pad_rgb: Sequence[int]) -> torch.Tensor:
    """Stem forward to native c1. img_u8 (N, H, W, 3) uint8 NHWC, H and W
    even; w_folded (7, 7, 3, 64) bf16 and bias (64,) f32 from
    :func:`fold_stem_weights`. Returns c1 (N, H/2, W/2, 64) bf16 NHWC. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    global STEM_CONV_LAUNCHES
    if img_u8.dim() != 4 or img_u8.shape[3] != 3 \
            or img_u8.shape[1] % 2 or img_u8.shape[2] % 2:
        raise ValueError(f"img_u8 must be (N, H, W, 3) with H, W even, got "
                         f"{tuple(img_u8.shape)}")
    if img_u8.device.type == "cpu":
        return stem_conv_ref(img_u8, w_folded, bias, pad_rgb)
    if img_u8.device.type != "cuda":
        raise ValueError(f"no stem kernel for device {img_u8.device}")
    n, h, w, _ = img_u8.shape
    dev = img_u8.device
    _check_stem_args(img_u8, w_folded, bias)
    fn = kernel_entry("wsiseg_stem_conv", _STEM_ARGS + [_P] * 2)
    c1 = torch.empty((n, h // 2, w // 2, 64), dtype=torch.bfloat16,
                     device=dev)
    with torch.cuda.device(dev):
        err = fn(img_u8.data_ptr(), w_folded.data_ptr(), bias.data_ptr(),
                 n, h, w, *(int(v) for v in pad_rgb), c1.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stem_conv kernel launch failed: CUDA error "
                           f"{err}")
    STEM_CONV_LAUNCHES += 1
    return c1


def _check_stem_args(img_u8, w_folded, bias) -> None:
    n, h, w, _ = img_u8.shape
    dev = img_u8.device
    check_tensor(img_u8, "img_u8", torch.uint8, (n, h, w, 3), dev)
    check_tensor(w_folded, "w_folded", torch.bfloat16, (7, 7, 3, 64), dev)
    check_tensor(bias, "bias", torch.float32, (64,), dev)
