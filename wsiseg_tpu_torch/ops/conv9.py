"""Fused SAME 3×3/1 convolutions with affine + ReLU epilogues — the port of
``wsiseg_tpu/ops/conv9.py`` and ``wsiseg_tpu/ops/pallas_conv.py``:

- :func:`conv9` — ``conv9`` (``conv9.py:137``, via ``_conv9_padded``
  ``:110``, body ``_conv9_kernel`` ``:49``): one conv, + bias, optional
  ReLU, bf16 or f32 out;
- :func:`conv_chain` — ``conv_chain`` (``conv9.py:360``, via
  ``_chain_padded`` ``:306``, body ``_chain_kernel`` ``:175``): L = 1..3
  fused convs with the ``"full"`` border semantics (out-of-image positions
  re-zeroed between layers, i.e. per-layer SAME zero padding);
- :func:`conv3x3_small` — ``conv3x3_small`` (``pallas_conv.py:43``, body
  ``_head_kernel`` ``:28``): one conv + bias, f32 out, no ReLU.

All three launch one templated CUDA kernel, ``csrc/conv3x3.cu`` (built
with the stem by :func:`wsiseg_tpu_torch.ops.stem.build_library`), and
count their launches apart in ``LAUNCHES``. On the card the kernel takes
bf16 activations and weights, the serving dtype; an f32 activation on a
CUDA tensor raises ``ValueError`` (the ``*_ref`` plain versions run f32 on
the CPU). CPU tensors take the plain versions.

A layer is ``(w, bias, relu)`` with ``w`` (Cout, 9, Cin), tap ``dy·3 +
dx``, and ``bias`` (Cout,) f32, as :func:`prep_layer` makes them from an
HWIO kernel and a BN scale — the host-side weight prep of the JAX
functions (``conv9.py:154-167``, ``:413-437``). Weights take the input's
dtype at each call, as the JAX kernels cast them. The TPU-only 128-lane
channel padding and the Mosaic mask modes are not carried over.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from wsiseg_tpu_torch.ops.stem import check_tensor, kernel_entry

#: kernel launches per wrapper since import (or since a caller reset them)
LAUNCHES = {"conv9": 0, "conv_chain": 0, "conv3x3_small": 0}

#: shared memory a block may use on an H100
MAX_SMEM = 232448
MAX_LAYERS = 3

Layer = Tuple[torch.Tensor, torch.Tensor, bool]


@torch.no_grad()
def prep_layer(kernel: torch.Tensor, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               dtype: torch.dtype = torch.bfloat16
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HWIO ``kernel`` (3, 3, Cin, Cout) and per-Cout ``scale`` → (w
    (Cout, 9, Cin), bias (Cout,) f32): ``kernel · scale`` in f32, rounded
    once to ``dtype``; a missing bias is zero."""
    kf = kernel.float()
    if scale is not None:
        kf = kf * scale.float()
    cin, cout = kf.shape[2], kf.shape[3]
    b = (torch.zeros(cout, dtype=torch.float32, device=kf.device)
         if bias is None else bias.float())
    w = kf.permute(3, 0, 1, 2).reshape(cout, 9, cin)
    return w.to(dtype).contiguous(), b.contiguous()


def _batched(x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 3:
        return x[None]
    if x.dim() != 4:
        raise ValueError(f"x must be (H, W, C) or (N, H, W, C), got "
                         f"{tuple(x.shape)}")
    return x


def _conv_ref(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              relu: bool, out_dtype: torch.dtype) -> torch.Tensor:
    """One SAME conv of NHWC ``x`` in f32 (exact products of the rounded
    operands, f32 sums), + bias, ReLU, rounded to ``out_dtype``."""
    cout, _, cin = w.shape
    k = w.to(x.dtype).float().view(cout, 3, 3, cin).permute(0, 3, 1, 2)
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), k, padding=1)
    y = y + bias.float().view(1, -1, 1, 1)
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


@torch.no_grad()
def conv9_ref(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              relu: bool = False,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of :func:`conv9`."""
    y = _conv_ref(_batched(x), w, bias, relu, out_dtype)
    return y[0] if x.dim() == 3 else y


@torch.no_grad()
def conv_chain_ref(x: torch.Tensor, layers: Sequence[Layer],
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of :func:`conv_chain`: the layers one by one, each
    with its own SAME zero padding (so out-of-image positions read zero at
    every layer), intermediates rounded to the input's dtype."""
    y = _batched(x)
    for i, (w, b, relu) in enumerate(layers):
        y = _conv_ref(y, w, b, relu,
                      out_dtype if i + 1 == len(layers) else x.dtype)
    return y[0] if x.dim() == 3 else y


@torch.no_grad()
def conv3x3_small_ref(x: torch.Tensor, kernel: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`conv3x3_small`."""
    w, b = prep_layer(kernel, None, bias, x.dtype)
    return conv9_ref(x, w, b, relu=False, out_dtype=torch.float32)


def _launch(x: torch.Tensor, layers: Sequence[Layer],
            out_dtype: torch.dtype, ref_name: str) -> torch.Tensor:
    """Run the CUDA chain kernel on NHWC ``x``; raises on what it does not
    take."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the conv3x3 kernel takes bf16 activations on the "
                         f"card, got {x.dtype}; {ref_name} is the plain "
                         "version for other dtypes")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"1..{MAX_LAYERS} layers, got {len(layers)}")
    n, h, w, cin = x.shape
    dev = x.device
    x = x.contiguous()
    args, couts, relu_mask, c = [], [], 0, cin
    for i, (wl, bl, relu) in enumerate(layers):
        cout = wl.shape[0]
        check_tensor(wl, f"layer {i} weights", torch.bfloat16, (cout, 9, c),
                     dev)
        check_tensor(bl, f"layer {i} bias", torch.float32, (cout,), dev)
        args += [wl.data_ptr(), bl.data_ptr(), cout]
        couts.append(cout)
        relu_mask |= int(bool(relu)) << i
        c = cout
    while len(couts) < MAX_LAYERS:
        args += [None, None, 0]
        couts.append(0)
    smem = kernel_entry("wsiseg_conv3x3_smem_bytes",
                        [ctypes.c_int] * 4)(len(layers), *couts)
    if smem > MAX_SMEM:
        raise ValueError(f"a {len(layers)}-layer chain with output channels "
                         f"{couts[:len(layers)]} needs {smem} bytes of "
                         f"shared memory per block, over {MAX_SMEM}")
    out = torch.empty((n, h, w, c), dtype=out_dtype, device=dev)
    fn = kernel_entry("wsiseg_conv3x3_chain",
                      [ctypes.c_void_p] + [ctypes.c_int] * 5
                      + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] * 3
                      + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), n, h, w, cin, len(layers), *args, relu_mask,
                 int(out_dtype == torch.float32), out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: CUDA error {err}")
    return out


def _run(name: str, ref, x: torch.Tensor, layers: Sequence[Layer],
         out_dtype: torch.dtype) -> torch.Tensor:
    layers = [(w.to(x.dtype), b, relu) for w, b, relu in layers]
    if x.device.type == "cpu":
        return ref(x, layers, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no conv3x3 kernel for device {x.device}")
    y = _launch(_batched(x), layers, out_dtype, f"{name}_ref")
    LAUNCHES[name] += 1
    return y[0] if x.dim() == 3 else y


def conv9(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
          relu: bool = False,
          out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """SAME 3×3/1 conv of x ((N,) H, W, Cin NHWC) with prepared weights
    (:func:`prep_layer`): ``conv(x, w) + bias``, optional ReLU, f32
    accumulation, rounded to ``out_dtype``. CPU tensors take
    :func:`conv9_ref`; CUDA tensors launch the kernel with L = 1."""
    return _run("conv9", lambda x_, ls, od: conv9_ref(x_, *ls[0], od), x,
                [(w, bias, relu)], out_dtype)


def conv_chain(x: torch.Tensor, layers: Sequence[Layer],
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """L = 1..3 fused SAME 3×3/1 convs of x ((N,) H, W, C0 NHWC), each
    ``(w, bias, relu)`` from :func:`prep_layer`; intermediates in x's dtype
    and re-zeroed outside the image, only the last layer is written, in
    ``out_dtype``. CPU tensors take :func:`conv_chain_ref`; CUDA tensors
    launch the kernel."""
    return _run("conv_chain", conv_chain_ref, x, layers, out_dtype)


def conv3x3_small(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME 3×3 conv + bias with an f32 output and no ReLU; ``kernel`` is
    HWIO (3, 3, Cin, Cout) and takes x's dtype. CPU tensors take
    :func:`conv3x3_small_ref`; CUDA tensors launch the kernel with
    L = 1."""
    w, b = prep_layer(kernel, None, bias, x.dtype)
    return _run("conv3x3_small",
                lambda x_, ls, od: conv9_ref(x_, *ls[0], od), x,
                [(w, b, False)], torch.float32)
