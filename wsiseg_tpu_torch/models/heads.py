"""Classification/regression heads — counterpart of
``wsiseg_tpu/models/heads.py``: Classifier = GAP + Linear, Regressor =
GAP + Linear(n→n//4) + ReLU + Linear(n//4→out), and the gradient
reversal function (reference models/models.py:5-17).

The heads return at least float32: bf16 logits are widened, float64 ones
(the CPU oracles) stay float64.
"""

from __future__ import annotations

import torch
from torch import nn


class Classifier(nn.Module):
    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(in_features, num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) deepest encoder feature → (B, num_classes)."""
        return at_least_f32(self.fc(x.mean(dim=(2, 3))))


class Regressor(nn.Module):
    def __init__(self, in_features: int, num_outputs: int = 1):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(in_features, in_features // 4),
                                nn.ReLU(),
                                nn.Linear(in_features // 4, num_outputs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return at_least_f32(self.fc(x.mean(dim=(2, 3))))


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


class _GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.scale * g, None


def gradient_reversal(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Identity forward, -scale · grad backward (reference ReverseLayerF,
    models/models.py:5-17; JAX ``heads.gradient_reversal``)."""
    return _GradientReversal.apply(x, scale)
