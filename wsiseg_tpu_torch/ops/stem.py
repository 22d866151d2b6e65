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
hand-written kernel in ``wsiseg_tpu_torch/csrc/stem_sm90.cu`` (built with
``nvcc`` for ``sm_90a`` at first use, bound with ``ctypes``) or raises; on
a CPU tensor it runs its plain PyTorch version (:func:`stem_pool_conv_ref`,
:func:`stem_conv_ref`).

The kernel computes the stem in the *cell form* of ``_stem2_kernel``: an
implicit GEMM on ``wgmma`` with M = 64 quarter-resolution cells (4 input
pixels each) of one c1 row, K = 336 = 7 kernel rows × 3 cell shifts × 16
values (4 pixels × RGB and 4 zeros), N = 128 = two c1 column parities × 64
channels, against :func:`fold_stem_weights_cells`'s weights. Its plain
version is :func:`stem_cells_ref`, its tile plan :func:`plan_stem`.

Numerics, shared by every version: normalize and BN fold into the conv
(``w·s[c]·g[co]`` and bias ``Σ w·t·g + b``, in f32), the folded weights
are rounded to bf16 as on the TPU (kept f32 only for the plain versions'
f32 oracle runs), products of u8 pixels and bf16 weights
are exact in f32, sums are f32, and both outputs are rounded to bf16 after
+bias and ReLU. The image's 3-px border reads as the per-channel pad value
``clip(round(255·mean))``, the u8 value closest to normalized zero.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence, Tuple

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

# the cell form (csrc/stem_sm90.cu): its A operand's assembly forms, in the
# kernel's order. per_row builds each c1 row's 64 × 336 tile; block writes
# each input row once per block with its three cell shifts; block_shifted
# writes it once and reads the shifts through shifted descriptors.
FORMS = ("per_row", "block", "block_shifted")
#: the form the wrappers launch, chosen by probe 5's times on the card
#: (``wsiseg_tpu_torch.probes.probe_stem_assembly``, PERF.md §6)
SERVED_FORM = "block_shifted"
K_STEPS = 21                     # (ky, s): 7 kernel rows × 3 cell shifts
CELLS = 64                       # wgmma M: cells of one c1 row
RING = 9                         # input rows a block form keeps per warpgroup
MAX_SMEM = 232448                # shared memory a block may use on an H100
W_BYTES = K_STEPS * 2 * 128 * 16         # the resident B operand
STAGE_BYTES = CELLS * 256                # one output row, staged
XW_BYTES = 4 * 4 * 8 * 4                 # the pool's cross-warp shift
STATIC_BYTES = 512                       # bias and slack
MAX_WGS = 3
H100_SMS = 132

_lib = None
_lib_lock = threading.Lock()
_entries = {}
_P, _I = ctypes.c_void_p, ctypes.c_int


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
def fold_stem_weights_cells(w_folded: torch.Tensor) -> torch.Tensor:
    """:func:`fold_stem_weights`'s (7, 7, 3, 64) weights in the cell form
    of ``pallas_stem.fold_stem_weights2``: w336 (336, 128), row 48·ky +
    16·s + 3·pix + ch, column 64·β + co, holding tap (ky, dx) where 2β + dx
    = 4s + pix (the input pixel's offset from the cell's first). Each entry
    receives at most one tap, so the scatter is exact in any dtype; rows
    16·k + 12 … 16·k + 15 are zero."""
    w336 = w_folded.new_zeros((336, 128))
    for ky in range(7):
        for beta in range(2):
            for dx in range(7):
                s, pix = divmod(2 * beta + dx, 4)
                r = 48 * ky + 16 * s + 3 * pix
                w336[r:r + 3, 64 * beta:64 * beta + 64] = w_folded[ky, dx]
    return w336


def cells_operand(w336: torch.Tensor) -> torch.Tensor:
    """w336 (336, 128) → the kernel's resident B operand (21, 2, 128, 8):
    k-step ks = 3·ky + s, plane p holding K values 8p … 8p + 7 of each
    column (16 bytes a column) — the K-major, unswizzled layout that the
    kernel's wgmma descriptors name."""
    return w336.reshape(K_STEPS, 2, 8, 128).permute(0, 1, 3, 2).contiguous()


def prepare_stem_cells(w_folded: torch.Tensor) -> torch.Tensor:
    """The B operand of ``w_folded`` (:func:`cells_operand` of
    :func:`fold_stem_weights_cells`), once per model."""
    return cells_operand(fold_stem_weights_cells(w_folded))


def _c1_ref(img_u8: torch.Tensor, w_folded: torch.Tensor,
            bias: torch.Tensor, pad_rgb: Sequence[int]) -> torch.Tensor:
    """f32 c1 (N, 64, H/2, W/2) of the folded stem, unrounded."""
    n, h, w, _ = img_u8.shape
    pad = torch.tensor(pad_rgb, dtype=torch.float32, device=img_u8.device)
    canvas = pad.view(1, 3, 1, 1).repeat(n, 1, h + 6, w + 6)
    canvas[:, :, 3:3 + h, 3:3 + w] = img_u8.permute(0, 3, 1, 2).float()
    k = w_folded.float().permute(3, 2, 0, 1)          # OIHW
    return torch.relu(F.conv2d(canvas, k, stride=2) + bias.view(1, -1, 1, 1))


def _pool_outputs(c1: torch.Tensor, dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s2d(c1), 3×3/2 max-pool of c1) NHWC in ``dtype`` from f32 NCHW c1."""
    from wsiseg_tpu_torch.models.fast_decoder import space_to_depth

    c1s2d = space_to_depth(c1).permute(0, 2, 3, 1)
    pool = F.max_pool2d(c1, 3, 2, 1).permute(0, 2, 3, 1)
    return c1s2d.to(dtype).contiguous(), pool.to(dtype).contiguous()


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
    return _pool_outputs(_c1_ref(img_u8, w_folded, bias, pad_rgb),
                         w_folded.dtype)


@torch.no_grad()
def stem_cells_ref(img_u8: torch.Tensor, w336: torch.Tensor,
                   bias: torch.Tensor, pad_rgb: Sequence[int],
                   pool: bool = True):
    """Plain PyTorch version of the cell form (the kernel's GEMM): the
    image, padded by ``pad_rgb``, as cells of 4 pixels × RGB (+ 4 zeros),
    unfolded into (cells, 336) patches — kernel row ky, cell shift s — times
    ``w336`` (:func:`fold_stem_weights_cells`), + bias, ReLU, split by
    column parity. Returns :func:`stem_pool_conv_ref`'s outputs (``pool``)
    or :func:`stem_conv_ref`'s, in ``w336``'s dtype."""
    n, h, w, _ = img_u8.shape
    cells = (w // 2 + 1) // 2
    pad = torch.tensor(pad_rgb, dtype=torch.float32, device=img_u8.device)
    canvas = pad.repeat(n, h + 6, 4 * (cells + 2), 1)
    canvas[:, 3:3 + h, 3:3 + w] = img_u8.float()
    cv = F.pad(canvas.view(n, h + 6, cells + 2, 12), (0, 4))
    # (n, H/2, cells, 16, ky, s): padded row 2y + ky, cell q + s
    patches = cv.unfold(1, 7, 2).unfold(2, 3, 1)
    patches = patches.permute(0, 1, 2, 4, 5, 3).reshape(n, h // 2, cells, 336)
    acc = patches @ w336.float() + bias.float().repeat(2)
    c1 = torch.relu(acc).view(n, h // 2, 2 * cells, 64)[:, :, :w // 2]
    if not pool:
        return c1.to(w336.dtype).contiguous()
    return _pool_outputs(c1.permute(0, 3, 1, 2), w336.dtype)


def slab_bytes(form: str) -> int:
    """Shared memory of one warpgroup's A operand in ``form``: the 21
    k-step tiles of one c1 row (per_row), or a ring of RING input rows with
    three shifted 64-cell copies (block) or one 66-cell copy
    (block_shifted), 32 bytes a cell."""
    return {"per_row": K_STEPS * CELLS, "block": RING * 3 * CELLS,
            "block_shifted": RING * (CELLS + 2)}[form] * 32


def warpgroup_bytes(form: str) -> int:
    return slab_bytes(form) + STAGE_BYTES + XW_BYTES


@dataclass(frozen=True)
class StemPlan:
    """How ``csrc/stem_sm90.cu`` splits one launch: every warpgroup owns a
    unit — a strip of ``strip_cells`` output cells (64 M rows; in pool mode
    M row 0 is the cell left of the strip, for the pool's column halo) over
    ``seg_rows`` c1 rows (in pool mode a segment below the first also
    recomputes the c1 row above it, for the pool's row halo). Units are
    numbered image-major, then strip, then segment; block b runs units
    b·wgs … b·wgs + wgs - 1."""
    n: int
    h: int
    w: int
    pool: bool
    form: str
    wgs: int
    strips: int
    segs: int
    seg_rows: int

    @property
    def halo(self) -> int:
        return 1 if self.pool else 0

    @property
    def strip_cells(self) -> int:
        return CELLS - self.halo

    @property
    def cells_out(self) -> int:
        """Cells of an output row: W/4 (pool), ⌈W/4⌉ c1 column pairs
        (native; the last pair of a W % 4 == 2 image has one column)."""
        return self.w // 4 if self.pool else (self.w // 2 + 1) // 2

    @property
    def rows(self) -> int:
        return self.h // 2

    @property
    def units(self) -> int:
        return self.n * self.strips * self.segs

    @property
    def grid(self) -> int:
        return -(-self.units // self.wgs)

    @property
    def threads(self) -> int:
        return 128 * self.wgs

    @property
    def smem_bytes(self) -> int:
        return W_BYTES + self.wgs * warpgroup_bytes(self.form)

    def unit(self, u: int) -> Tuple[int, int, int, int, int]:
        """Unit ``u`` as the kernel reads it: (image, first cell of its 64
        M rows, first c1 row computed, first c1 row stored, end row)."""
        seg, t = u % self.segs, u // self.segs
        strip, nb = t % self.strips, t // self.strips
        c0 = strip * self.strip_cells - self.halo
        y_begin = seg * self.seg_rows
        y_end = min(self.rows, y_begin + self.seg_rows)
        y_first = y_begin - (1 if self.pool and y_begin > 0 else 0)
        return nb, c0, y_first, y_begin, y_end


@functools.lru_cache(maxsize=64)
def plan_stem(n: int, h: int, w: int, pool: bool, form: str = SERVED_FORM,
              sms: int = H100_SMS) -> StemPlan:
    """The launch plan of :func:`stem_pool_conv` (``pool``) or
    :func:`stem_conv`: as many warpgroups a block as fit in shared memory
    beside the resident weights (at most 3), and the row segments that
    minimise waves × rows a unit (the makespan) over ``sms`` blocks.
    Cached: the search costs about a millisecond of host time at the bench
    geometry, more than the kernel."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if n < 1 or h < 2 or w < 2:
        raise ValueError(f"empty stem launch {(n, h, w)}")
    wgs = min(MAX_WGS, (MAX_SMEM - W_BYTES - STATIC_BYTES)
              // warpgroup_bytes(form))
    base = StemPlan(n, h, w, pool, form, wgs, 1, 1, 1)
    strips = -(-base.cells_out // base.strip_cells)
    rows, slots = base.rows, sms * wgs
    best = None
    for segs in range(1, rows + 1):
        seg_rows = -(-rows // segs)
        seg_rows += seg_rows % 2 if pool else 0
        real = -(-rows // seg_rows)
        units = n * strips * real
        cost = -(-units // slots) * (seg_rows + (base.halo if real > 1
                                                 else 0))
        if best is None or (cost, units) < best[0]:
            best = ((cost, units), real, seg_rows)
    _, segs, seg_rows = best
    return StemPlan(n, h, w, pool, form, wgs, strips, segs, seg_rows)


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


def launch_cells(img_u8: torch.Tensor, w_cells: torch.Tensor,
                 bias: torch.Tensor, pad_rgb: Sequence[int], pool: bool,
                 form: str = SERVED_FORM):
    """One launch of ``csrc/stem_sm90.cu`` on CUDA tensors: img_u8 (N, H,
    W, 3) u8, w_cells (21, 2, 128, 8) bf16 from :func:`prepare_stem_cells`,
    bias (64,) f32. Returns (c1s2d, pool) (``pool``) or c1, as the
    wrappers; counts nothing (the wrappers and the probes count their
    own). Raises if the launch fails."""
    n, h, w, _ = img_u8.shape
    dev = img_u8.device
    check_tensor(img_u8, "img_u8", torch.uint8, (n, h, w, 3), dev)
    check_tensor(w_cells, "w_cells", torch.bfloat16, (K_STEPS, 2, 128, 8),
                 dev)
    check_tensor(bias, "bias", torch.float32, (64,), dev)
    p = plan_stem(n, h, w, pool, form,
                  torch.cuda.get_device_properties(dev).multi_processor_count)
    if pool:
        out = (torch.empty((n, h // 4, w // 4, 256), dtype=torch.bfloat16,
                           device=dev),
               torch.empty((n, h // 4, w // 4, 64), dtype=torch.bfloat16,
                           device=dev))
    else:
        out = (torch.empty((n, h // 2, w // 2, 64), dtype=torch.bfloat16,
                           device=dev),)
    fn = kernel_entry("wsiseg_stem_sm90",
                      [_P] * 3 + [_I] * 6 + [_P] * 2 + [_I] * 6 + [_P])
    with torch.cuda.device(dev):
        err = fn(img_u8.data_ptr(), w_cells.data_ptr(), bias.data_ptr(),
                 n, h, w, *(int(v) for v in pad_rgb), out[0].data_ptr(),
                 out[1].data_ptr() if pool else None, int(pool),
                 FORMS.index(form), p.strips, p.segs, p.seg_rows, p.wgs,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stem kernel launch failed: CUDA error {err}")
    return out if pool else out[0]


def _cells_for(img_u8, w_folded, bias, w_cells):
    dev = img_u8.device
    check_tensor(w_folded, "w_folded", torch.bfloat16, (7, 7, 3, 64), dev)
    check_tensor(bias, "bias", torch.float32, (64,), dev)
    return prepare_stem_cells(w_folded) if w_cells is None else w_cells


def stem_pool_conv(img_u8: torch.Tensor, w_folded: torch.Tensor,
                   bias: torch.Tensor, pad_rgb: Sequence[int],
                   w_cells: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused stem forward. img_u8 (N, H, W, 3) uint8 NHWC, H and W
    multiples of 4; w_folded (7, 7, 3, 64) bf16 and bias (64,) f32 from
    :func:`fold_stem_weights`; ``w_cells``, the kernel's operand
    (:func:`prepare_stem_cells` of ``w_folded``, made here when not given).
    Returns (c1s2d (N, H/4, W/4, 256), pool (N, H/4, W/4, 64)) bf16 NHWC.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global LAUNCHES
    if img_u8.dim() != 4 or img_u8.shape[3] != 3 \
            or img_u8.shape[1] % 4 or img_u8.shape[2] % 4:
        raise ValueError(f"img_u8 must be (N, H, W, 3) with H, W multiples "
                         f"of 4, got {tuple(img_u8.shape)}")
    if img_u8.device.type == "cpu":
        return stem_pool_conv_ref(img_u8, w_folded, bias, pad_rgb)
    if img_u8.device.type != "cuda":
        raise ValueError(f"no stem kernel for device {img_u8.device}")
    out = launch_cells(img_u8, _cells_for(img_u8, w_folded, bias, w_cells),
                       bias, pad_rgb, True)
    LAUNCHES += 1
    return out


def stem_conv(img_u8: torch.Tensor, w_folded: torch.Tensor,
              bias: torch.Tensor, pad_rgb: Sequence[int],
              w_cells: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stem forward to native c1. img_u8 (N, H, W, 3) uint8 NHWC, H and W
    even; w_folded (7, 7, 3, 64) bf16 and bias (64,) f32 from
    :func:`fold_stem_weights`; ``w_cells`` as for :func:`stem_pool_conv`.
    Returns c1 (N, H/2, W/2, 64) bf16 NHWC. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    global STEM_CONV_LAUNCHES
    if img_u8.dim() != 4 or img_u8.shape[3] != 3 \
            or img_u8.shape[1] % 2 or img_u8.shape[2] % 2:
        raise ValueError(f"img_u8 must be (N, H, W, 3) with H, W even, got "
                         f"{tuple(img_u8.shape)}")
    if img_u8.device.type == "cpu":
        return stem_conv_ref(img_u8, w_folded, bias, pad_rgb)
    if img_u8.device.type != "cuda":
        raise ValueError(f"no stem kernel for device {img_u8.device}")
    out = launch_cells(img_u8, _cells_for(img_u8, w_folded, bias, w_cells),
                       bias, pad_rgb, False)
    STEM_CONV_LAUNCHES += 1
    return out
