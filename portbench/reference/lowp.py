"""The control: the plain reference computed in the precision below the
one the configuration states (bfloat16 → 8-bit floating point).

Every conv and linear of the reference takes its input and its weight
rounded to float8 e4m3 with one scale per tensor (its largest magnitude
mapped to 448, e4m3's largest finite value), the usual per-tensor
scaling of fp8 inference and training, and multiplies them in float32;
in training, the gradient arriving at each output is rounded to float8
e5m2 the same way (largest 57344) before the backward's two products,
as fp8 training computes them. Imports nothing of the program.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to scaled float8 e4m3 and back, in ``x``'s dtype;
    its gradient passes through unchanged."""
    q = _round(x.detach(), torch.float8_e4m3fn, E4M3_MAX)
    return x + (q - x).detach()


class _GradFp8(torch.autograd.Function):
    """Identity forward; the backward rounds the gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def _conv_hook(mod: nn.Conv2d, args, _out):
    return _GradFp8.apply(F.conv2d(
        to_fp8(args[0]), to_fp8(mod.weight), mod.bias, mod.stride,
        mod.padding, mod.dilation, mod.groups))


def _linear_hook(mod: nn.Linear, args, _out):
    return _GradFp8.apply(F.linear(to_fp8(args[0]), to_fp8(mod.weight),
                                   mod.bias))


@contextlib.contextmanager
def fp8(model: nn.Module):
    """Within the block, ``model``'s convs and linears compute from fp8
    operands, and in training from fp8 gradients."""
    handles = []
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            handles.append(m.register_forward_hook(_conv_hook))
        elif isinstance(m, nn.Linear):
            handles.append(m.register_forward_hook(_linear_hook))
    try:
        yield model
    finally:
        for h in handles:
            h.remove()
