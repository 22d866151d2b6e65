"""Classification/regression heads — counterpart of
``wsiseg_tpu/models/heads.py``: Classifier = GAP + Linear, Regressor =
GAP + Linear(n→n//4) + ReLU + Linear(n//4→out). Present so the whole
parameter tree converts; ``gradient_reversal`` waits for the training port.
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
        return self.fc(x.mean(dim=(2, 3))).float()


class Regressor(nn.Module):
    def __init__(self, in_features: int, num_outputs: int = 1):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(in_features, in_features // 4),
                                nn.ReLU(),
                                nn.Linear(in_features // 4, num_outputs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x.mean(dim=(2, 3))).float()
