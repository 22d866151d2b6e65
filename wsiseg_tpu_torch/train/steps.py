"""Train steps for every trainer family — counterpart of
``wsiseg_tpu/train/steps.py``.

Each ``make_*_train_step`` returns ``step(state, batch, generator=None)
-> metrics``: one optimizer update of ``state.model`` with
``state.optimizer`` on a batch of device tensors, ``state.step`` counted.
Mixed-task batches are handled with per-row task masks and masked losses
instead of the reference's boolean indexing (``encoding[0][is_cls]``,
train_cellularity.py:87).
Metrics are 0-dim device tensors: reading them is the caller's sync.

Batches are dicts of tensors on the model's device (the HR ensemble's:
``image`` (B, P, H, W, 3) and ``cls_label``, :func:`make_hr_train_step`):
  image      (B, H, W, 3) float, already normalized (channels last: the
             step reads it as an NCHW view in ``channels_last`` memory)
  seg_label  (B, H, W) int        (zeros where not seg)
  cls_label  (B,) int             (-1 where not cls)
  reg_label  (B,) float           (0 where not reg)
  is_cls / is_reg / is_seg  (B,) float {0, 1}

Precision: parameters and BatchNorm statistics in ``cfg.param_dtype``;
convolutions and linears under ``torch.autocast`` in
``cfg.compute_dtype`` when that is bf16 or f16; the losses in float32 (the
heads widen the logits). A float64 ``compute_dtype`` runs everything in
float64, no autocast: the oracles.

The model trains through its native decoder for every family: the JAX
package's train s2d tails (``unet._S2dTailBlock``,
``decoders._S2dLinknetTailBlock``) and ``losses.cross_entropy_s2d`` compute
the same values in another layout and are not ported (ROADMAP.md §3).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from wsiseg_tpu_torch import losses
from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]

_SEG_LOSSES = ("xent", "focal", "ohem", "cent", "dice", "jaccard", "tversky")


def autocast(cfg: Config, device: torch.device):
    """``torch.autocast`` in ``cfg.compute_dtype`` when that is a 16-bit
    type, else a null context."""
    if cfg.compute_dtype in ("bfloat16", "float16"):
        return torch.autocast(device.type,
                              dtype=getattr(torch, cfg.compute_dtype))
    return contextlib.nullcontext()


def _on(weights, dev: torch.device) -> Optional[torch.Tensor]:
    """Class weights on the device once, so that no step copies them from
    the host (a copy from pageable memory waits for the device)."""
    return None if weights is None else torch.as_tensor(
        weights, dtype=torch.float64, device=dev)


def _make_update(loss_fn: Callable[[Batch], tuple], cfg: Config,
                 grad_accum: Optional[int]) -> Callable:
    """step(state, batch) for any ``loss_fn(batch) -> (total, aux)`` that
    runs ``state.model`` (closed over by the caller).

    ``grad_accum > 1`` splits the batch into that many microbatches and
    accumulates their grads before the ONE optimizer update (JAX
    ``_make_grads_fn``, ``steps.py:55``): BatchNorm statistics are each
    microbatch's, the running ones chaining through them; the grads are
    the mean of the microbatch grads; the aux values the mean of the
    microbatches' values."""
    ga = cfg.grad_accum if grad_accum is None else grad_accum

    def step(state: TrainState, batch: Batch,
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        del generator           # the model draws nothing (no dropout)
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=False)
        b = next(iter(batch.values())).shape[0]
        if b % ga:
            raise ValueError(
                f"batch size {b} not divisible by grad_accum {ga}")
        m = b // ga
        sums: Dict[str, torch.Tensor] = {}
        for k in range(ga):
            mb = {key: v[k * m:(k + 1) * m] for key, v in batch.items()} \
                if ga > 1 else batch
            total, aux = loss_fn(mb)
            total.backward()
            for key, v in aux.items():
                v = v.detach()
                sums[key] = v if key not in sums else sums[key] + v
        for p in model.parameters():
            if p.grad is None:
                # a head this loss does not reach: JAX's gradient there is
                # 0, and the optimizer still decays and moves it
                p.grad = torch.zeros_like(p)
            elif ga > 1:
                p.grad.div_(ga)
        if ga > 1:
            sums = {k: v / ga for k, v in sums.items()}
        opt.step()
        state.step += 1
        return sums

    return step


def make_hybrid_train_step(model, cfg: Config, cls_weights=None,
                           seg_weights=None,
                           grad_accum: Optional[int] = None) -> Callable:
    """Three-head step: xent(cls) + mse(reg) + xent(seg), summed — the
    ``train_cellularity.py:86-108`` recipe; each loss masked to its rows.
    ``grad_accum`` defaults to ``cfg.grad_accum`` (see
    :func:`_make_update`)."""
    dev = next(model.parameters()).device
    cls_weights, seg_weights = _on(cls_weights, dev), _on(seg_weights, dev)

    def loss_fn(batch: Batch):
        with autocast(cfg, dev):
            out = model(batch["image"].permute(0, 3, 1, 2))
        l_cls = losses.cross_entropy(
            out["cls"], batch["cls_label"], class_weights=cls_weights,
            ignore_index=-1, sample_weight=batch["is_cls"])
        l_reg = losses.mse(out["reg"][:, 0], batch["reg_label"],
                           sample_weight=batch["is_reg"])
        l_seg = losses.cross_entropy(
            out["seg"], batch["seg_label"], class_weights=seg_weights,
            sample_weight=batch["is_seg"])
        total = l_cls + l_reg + l_seg
        return total, {"loss": total, "loss_cls": l_cls, "loss_reg": l_reg,
                       "loss_seg": l_seg}

    return _make_update(loss_fn, cfg, grad_accum)


def make_seg_train_step(model, cfg: Config, class_weights=None,
                        with_dice: bool = False,
                        grad_accum: Optional[int] = None) -> Callable:
    """Pure-segmentation step (train_ssr.py:41-60): ``cfg.loss`` (a
    segmentation loss, else xent) on the decoder's logits, plus dice when
    ``with_dice``."""
    base = losses.loss_fn(cfg.loss if cfg.loss in _SEG_LOSSES else "xent")
    dev = next(model.parameters()).device
    class_weights = _on(class_weights, dev)

    def loss_fn(batch: Batch):
        with autocast(cfg, dev):
            seg = model.segment(batch["image"].permute(0, 3, 1, 2))
        kwargs = {}
        if cfg.loss in ("xent", "focal", "cent", "dice"):
            kwargs["class_weights"] = class_weights
        total = base(seg, batch["seg_label"], **kwargs)
        if with_dice:
            total = total + losses.dice(seg, batch["seg_label"],
                                        class_weights=class_weights)
        return total, {"loss": total}

    return _make_update(loss_fn, cfg, grad_accum)


def make_cls_train_step(model, cfg: Config, class_weights=None,
                        grad_accum: Optional[int] = None) -> Callable:
    """Pure patch-classification step through ``YNet.classify`` (encoder →
    classifier; train_p.py:55-80). With ``grad_accum > 1`` the reported
    ``acc`` is the mean of the microbatches' accuracies, as in JAX."""
    dev = next(model.parameters()).device
    class_weights = _on(class_weights, dev)

    def loss_fn(batch: Batch):
        with autocast(cfg, dev):
            out = model.classify(batch["image"].permute(0, 3, 1, 2))
        labels = batch["cls_label"]
        total = losses.cross_entropy(out, labels,
                                     class_weights=class_weights,
                                     ignore_index=-1,
                                     sample_weight=batch.get("is_cls"))
        w = batch.get("is_cls")
        w = torch.ones_like(out[:, 0]) if w is None else w.to(out.dtype)
        correct = (out.argmax(-1) == labels).to(out.dtype)
        acc = (correct * w).sum() / torch.clamp(w.sum(), min=1e-8)
        return total, {"loss": total, "acc": acc}

    return _make_update(loss_fn, cfg, grad_accum)


def make_hr_train_step(model, cfg: Config, class_weights=None,
                       grad_accum: Optional[int] = None) -> Callable:
    """Multi-patch region-ensemble step (train_hr.py:58-68): class-weighted
    cross entropy on the ensemble logits, and their accuracy. The batch's
    ``image`` is (B, P, H, W, 3) normalized, ``cls_label`` (B,). ``fc0``
    (the per-patch head) gets a zero grad, as in JAX, where the loss does
    not reach it."""
    dev = next(model.parameters()).device
    class_weights = _on(class_weights, dev)

    def loss_fn(batch: Batch):
        with autocast(cfg, dev):
            _, ens = model(batch["image"])
        labels = batch["cls_label"]
        total = losses.cross_entropy(ens, labels,
                                     class_weights=class_weights)
        acc = (ens.argmax(-1) == labels).to(ens.dtype).mean()
        return total, {"loss": total, "acc": acc}

    return _make_update(loss_fn, cfg, grad_accum)
