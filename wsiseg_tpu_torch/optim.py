"""Optimizer factory: adam / sgd / adabound — counterpart of
``wsiseg_tpu/optim.py`` (reference models/optimizers.py:6-21).

The JAX package chains optax's ``add_decayed_weights`` (g + wd·p) before
each rule, which is coupled L2 — torch's ``weight_decay`` on ``Adam`` and
``SGD``, not ``AdamW``:

* adam: ``torch.optim.Adam(lr, betas=(β1, β2), eps=1e-8, weight_decay)``;
* sgd: ``torch.optim.SGD(lr, momentum=β1, dampening=0, weight_decay)``,
  whose first step's buffer is the gradient, as optax's trace from zeros;
* adabound: :class:`AdaBound`, the JAX package's formula (Luo et al.
  2019), which torch does not ship.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from wsiseg_tpu_torch.config import Config


class AdaBound(torch.optim.Optimizer):
    """Adam whose per-parameter step size is clipped into a band
    [lb(t), ub(t)] that narrows to ``final_lr`` (SGD-like) as t grows —
    JAX ``optim.adabound`` (``optim.py:25``): t is the step count, the
    bias corrections and the band are computed in float32 as JAX's
    ``count.astype(float32)`` makes them, and the update is
    ``-clip(lr / (sqrt(ν·ν̂) + eps), lb, ub) · μ·μ̂``.
    ``weight_decay`` is coupled L2 (g + wd·p)."""

    def __init__(self, params: Iterable, lr: float, betas=(0.9, 0.999),
                 final_lr: float = 0.1, gamma: float = 1e-3,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, final_lr=final_lr,
                                      gamma=gamma, eps=eps,
                                      weight_decay=weight_decay))

    @staticmethod
    def scalars(count: int, b1: float, b2: float, final_lr: float,
                gamma: float):
        """(μ̂, ν̂, lb, ub) at step ``count``, each rounded as JAX's f32
        arithmetic rounds it."""
        f32 = np.float32
        t = f32(count)
        mu_hat = f32(1.0) / (f32(1.0) - f32(b1) ** t)
        nu_hat = f32(1.0) / (f32(1.0) - f32(b2) ** t)
        lb = f32(final_lr) * (f32(1.0) - f32(1.0) / (f32(gamma) * t
                                                      + f32(1.0)))
        ub = f32(final_lr) * (f32(1.0) + f32(1.0) / (f32(gamma) * t))
        return float(mu_hat), float(nu_hat), float(lb), float(ub)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                m, v = st["exp_avg"], st["exp_avg_sq"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).add_(g * g, alpha=1 - b2)
                mu_hat, nu_hat, lb, ub = self.scalars(
                    st["step"], b1, b2, group["final_lr"], group["gamma"])
                size = group["lr"] / (torch.sqrt(v * nu_hat) + group["eps"])
                p.sub_(size.clamp_(lb, ub) * (m * mu_hat))
        return loss


def build_optimizer(cfg: Config, params: Iterable) -> torch.optim.Optimizer:
    """adam/sgd/adabound over ``params`` with the reference's wiring:
    adam(lr, betas, weight_decay) / sgd(lr, momentum=beta1, weight_decay)
    (models/optimizers.py:8-19)."""
    params = list(params)
    if cfg.optim == "adam":
        fused = bool(params) and all(p.is_cuda for p in params)
        return torch.optim.Adam(params, lr=cfg.lr,
                                betas=(cfg.beta1, cfg.beta2), eps=1e-8,
                                weight_decay=cfg.weight_decay,
                                fused=fused or None)
    if cfg.optim == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.beta1,
                               dampening=0.0,
                               weight_decay=cfg.weight_decay)
    if cfg.optim == "adabound":
        return AdaBound(params, lr=cfg.lr, betas=(cfg.beta1, cfg.beta2),
                        weight_decay=cfg.weight_decay)
    raise KeyError(f"unknown optimizer {cfg.optim!r}")
