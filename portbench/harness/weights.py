"""Seeded weights, made on the device in a few large draws.

Every conv and linear kernel is LeCun-normal (standard deviation
``1/sqrt(fan_in)``, the init the program's own ``init_ynet`` uses), every
bias is small, and every BatchNorm gets a scale, shift, running mean and
running variance drawn around the identity, so that an inference route
that folds BatchNorm into its convolutions is exercised. The names and
shapes are the plain reference's (smp's and torchvision's), and the same
dict is handed to the program and to the reference.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn


def make_state(model: nn.Module, generator: torch.Generator,
               scale: Optional[Dict[str, float]] = None,
               dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A state dict for ``model``'s keys and shapes, drawn on
    ``generator``'s device: one normal and one uniform draw for all
    leaves, then cut and scaled leaf by leaf; ``scale`` (a
    configuration's ``init_scale``) multiplies the named leaves."""
    dev = generator.device
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    floats = [k for k in shapes if not k.endswith("num_batches_tracked")]
    total = sum(int(torch.Size(shapes[k]).numel()) for k in floats)
    normal = torch.randn(total, generator=generator, device=dev, dtype=dtype)
    uniform = torch.rand(total, generator=generator, device=dev, dtype=dtype)
    bn = {k.rsplit(".", 1)[0] for k in floats if k.endswith("running_var")}
    out, at = {}, 0
    for k in floats:
        n = int(torch.Size(shapes[k]).numel())
        z, u = normal[at:at + n].view(shapes[k]), uniform[at:at + n] \
            .view(shapes[k])
        at += n
        owner, leaf = k.rsplit(".", 1)
        if owner in bn:
            out[k] = {"weight": 0.8 + 0.4 * u, "bias": 0.1 * z,
                      "running_mean": 0.1 * z,
                      "running_var": 0.7 + 0.6 * u}[leaf]
        elif leaf == "weight":
            out[k] = z * (1.0 / (n // shapes[k][0])) ** 0.5
        else:
            out[k] = 0.01 * z
    for k, f in (scale or {}).items():
        out[k] = out[k] * f
    for k in shapes:
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.long, device=dev)
    return out
