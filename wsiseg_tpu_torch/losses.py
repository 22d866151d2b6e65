"""Loss zoo — counterpart of ``wsiseg_tpu/losses.py``: the reference's 15
registered losses (models/losses.py:8-40), built one at a time by
:func:`loss_fn`.

Conventions:
* classification/segmentation losses take ``logits`` with classes on
  dim 1 ((B, C) or (B, C, H, W)) and integer ``targets`` ((B,) or
  (B, H, W));
* regression losses take ``(pred, target)`` float tensors of equal shape;
* every loss accepts ``sample_weight`` — per-example {0,1} (or soft)
  weights — because multi-task batches mask rows instead of indexing them
  (reference train_cellularity.py:86-103).

The JAX package computes dense losses class-major (a TPU lane-layout
device, ``losses.py:48-104``); the values are the same as the plain
formulas computed here. Its deliberate departures from the reference stay:
jaccard's union is ``|x|+|y|-|x∩y|``, dice's ``ignore_index`` works.

Under data-parallel training (inside
:func:`~wsiseg_tpu_torch.parallel.comm.data_parallel` over several ranks)
every reduction across samples is global, as under JAX's mesh: each
mean's numerator and denominator (:func:`global_ratio`), each class sum, and
OHEM's ranking (over the gathered per-pixel losses). Without a data group
nothing changes. Under spatial training the group is every rank of the
(data, space) mesh: dense logits are stripes, each pixel on one rank;
values that every space rank computes alike (the heads' logits) enter
each ratio's numerator and denominator once per space rank, and the
factors cancel.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from wsiseg_tpu_torch.models.decoders import resize_linear, resize_nearest
from wsiseg_tpu_torch.parallel import comm, spatial

Tensor = torch.Tensor


def global_ratio(num: Tensor, den) -> Tensor:
    """num / max(den, 1e-8), both summed over the data group's ranks."""
    den = torch.as_tensor(den, dtype=num.dtype, device=num.device)
    if comm.world() > 1:
        num, den = comm.global_sum(torch.stack([num, den])).unbind()
    return num / torch.clamp(den, min=1e-8)


def global_mean(values: Tensor) -> Tensor:
    """values.mean(), over the data group's ranks."""
    if comm.world() > 1:
        return global_ratio(values.sum(), float(values.numel()))
    return values.mean()


def _mean(values: Tensor, weights: Optional[Tensor]) -> Tensor:
    """Weighted mean over the leading (sample) axis; plain mean if None."""
    if weights is None:
        return global_mean(values)
    w = weights.to(values.dtype)
    while w.ndim < values.ndim:
        w = w[..., None]
    return global_ratio((values * w).sum(),
                        w.sum() * (values.numel() / w.numel()))


def _spatial(sample_weight: Tensor, targets: Tensor, dtype) -> Tensor:
    """(B,) sample weights broadcast to the targets' shape."""
    sw = sample_weight.reshape(
        sample_weight.shape + (1,) * (targets.ndim - sample_weight.ndim))
    return sw.expand(targets.shape).to(dtype)


def _pick(x: Tensor, t: Tensor) -> Tensor:
    """x[b, t[b, ...], ...]: the class-dim entry each target names."""
    return x.gather(1, t.long().unsqueeze(1)).squeeze(1)


def _weighted(values: Tensor, sw: Optional[Tensor]) -> Tensor:
    if sw is None:
        return global_mean(values)
    return global_ratio((values * sw).sum(), sw.sum())


def _class_sum(x: Tensor) -> Tensor:
    """Sum over every dim but the class dim (and the data group's ranks):
    (C,)."""
    return comm.global_sum(x.sum(dim=[d for d in range(x.ndim) if d != 1]))


def _one_hot(targets: Tensor, num_classes: int, dtype) -> Tensor:
    """(B, ...) int → (B, C, ...) one-hot; out-of-range targets → 0."""
    k = torch.arange(num_classes, device=targets.device).view(
        (1, num_classes) + (1,) * (targets.ndim - 1))
    return (targets.unsqueeze(1) == k).to(dtype)


def _cw(class_weights, like: Tensor) -> Tensor:
    return torch.as_tensor(class_weights, dtype=like.dtype,
                           device=like.device)


def cross_entropy(logits: Tensor, targets: Tensor,
                  class_weights=None, ignore_index: int = -1,
                  sample_weight: Optional[Tensor] = None) -> Tensor:
    """Weighted softmax CE with ignore_index (torch CrossEntropyLoss
    semantics: the weighted mean divides by the applied weights' sum)."""
    valid = targets != ignore_index
    t = torch.where(valid, targets, torch.zeros_like(targets))
    nll = -_pick(F.log_softmax(logits, dim=1), t)
    w = valid.to(logits.dtype)
    if class_weights is not None:
        w = w * _cw(class_weights, logits)[t.long()]
    if sample_weight is not None:
        w = w * _spatial(sample_weight, targets, logits.dtype)
    return global_ratio((nll * w).sum(), w.sum())


def bce(probs: Tensor, targets: Tensor,
        sample_weight: Optional[Tensor] = None) -> Tensor:
    """Binary cross entropy on probabilities (torch BCELoss)."""
    p = torch.clamp(probs, 1e-7, 1 - 1e-7)
    t = targets.to(p.dtype)
    return _mean(-(t * torch.log(p) + (1 - t) * torch.log(1 - p)),
                 sample_weight)


def focal(logits: Tensor, targets: Tensor, gamma: float = 2.0,
          class_weights=None,
          sample_weight: Optional[Tensor] = None) -> Tensor:
    """Multi-class focal loss (reference FocalLoss2d,
    models/losses.py:95-130)."""
    logpt = _pick(F.log_softmax(logits, dim=1), targets)
    pt = torch.exp(logpt)
    if class_weights is not None:
        logpt = logpt * _cw(class_weights, logits)[targets.long()]
    loss = -((1.0 - pt) ** gamma) * logpt
    sw = (None if sample_weight is None
          else _spatial(sample_weight, targets, logits.dtype))
    return _weighted(loss, sw)


def ohem(logits: Tensor, targets: Tensor, ratio: float = 0.5,
         scale_factor: float = 1.0 / 16.0,
         sample_weight: Optional[Tensor] = None) -> Tensor:
    """Online hard example mining (reference OHEM,
    models/losses.py:133-160): dense logits and labels are downscaled by
    ``scale_factor`` (JAX's antialiased linear and half-pixel nearest
    resizes), and CE is averaged over the hardest ``ratio`` of the
    pixels (ranked over the whole batch, as the JAX package does; under
    data-parallel training over the global batch). On stripes (spatial
    training) the logits and labels are gathered over the space group
    first, and each space rank ranks its 1/M of the resized pixels, so
    that the ranking sees each pixel once."""
    sp = comm.space() if logits.ndim == 4 else None
    if sp is not None:
        logits, targets = spatial.gather(logits, sp), \
            spatial.gather(targets, sp)
    if logits.ndim == 4 and scale_factor != 1.0:
        _, _, h, w = logits.shape
        nh, nw = max(1, int(h * scale_factor)), max(1, int(w * scale_factor))
        logits = resize_linear(logits, nh, nw)
        targets = resize_nearest(targets.unsqueeze(1), nh, nw).squeeze(1)
    nll = -_pick(F.log_softmax(logits, dim=1), targets)
    if sample_weight is not None:
        nll = nll * _spatial(sample_weight, targets, logits.dtype)
    nll = nll.reshape(-1)
    total = nll.shape[0] * comm.world()
    if sp is not None:
        # this rank's share, padded with -inf (never among the top k)
        total //= sp.size
        share = -(-nll.shape[0] // sp.size)
        part = nll[sp.rank * share:(sp.rank + 1) * share]
        nll = F.pad(part, (0, share - part.shape[0]), value=float("-inf"))
    every = comm.gather_slots(nll).reshape(-1)
    k = max(1, int(ratio * total))
    return torch.topk(every, k).values.mean()


def conditional_entropy_ce(logits: Tensor, targets: Tensor,
                           class_weights=None,
                           sample_weight: Optional[Tensor] = None) -> Tensor:
    """Conditional entropy + cross entropy (reference
    ConditionalEntropyLoss, models/losses.py:163-178)."""
    logp = F.log_softmax(logits, dim=1)
    ent = (torch.exp(logp) * logp).sum(dim=1)        # negative entropy
    nll = -_pick(logp, targets)
    if class_weights is not None:
        nll = nll * _cw(class_weights, logits)[targets.long()]
    sw = (None if sample_weight is None
          else _spatial(sample_weight, targets, logits.dtype))
    return _weighted(-ent + nll, sw)


def _probs_onehot(logits: Tensor, targets: Tensor,
                  sample_weight: Optional[Tensor]):
    probs = F.softmax(logits, dim=1)
    oh = _one_hot(targets, logits.shape[1], logits.dtype)
    if sample_weight is not None:
        sw = sample_weight.to(logits.dtype).reshape(
            sample_weight.shape + (1,) * (logits.ndim - sample_weight.ndim))
        probs, oh = probs * sw, oh * sw
    return probs, oh


def dice(logits: Tensor, targets: Tensor, class_weights=None,
         ignore_index: Optional[int] = None,
         sample_weight: Optional[Tensor] = None,
         eps: float = 1e-4) -> Tensor:
    """Soft Dice (reference DiceLoss, models/losses.py:226-258): per
    channel 1 - 2|x∩y| / (|x|+|y|), class-weighted, summed / C."""
    c = logits.shape[1]
    valid = (torch.ones_like(targets, dtype=torch.bool)
             if ignore_index is None else targets != ignore_index)
    t = torch.where(valid, targets, torch.zeros_like(targets))
    vf = valid.to(logits.dtype).unsqueeze(1)
    probs = F.softmax(logits, dim=1)
    oh = _one_hot(t, c, logits.dtype) * vf
    if sample_weight is not None:
        sw = sample_weight.to(logits.dtype).reshape(
            sample_weight.shape + (1,) * (logits.ndim - sample_weight.ndim))
        probs, oh = probs * sw, oh * sw
    inter = _class_sum(probs * oh)
    denom = _class_sum(probs * vf) + _class_sum(oh) + eps
    per_channel = 1.0 - 2.0 * inter / denom
    if class_weights is not None:
        per_channel = per_channel * _cw(class_weights, logits)
    return per_channel.sum() / c


def jaccard(logits: Tensor, targets: Tensor, eps: float = 1.0,
            sample_weight: Optional[Tensor] = None) -> Tensor:
    """Soft IoU loss, mean over channels."""
    probs, oh = _probs_onehot(logits, targets, sample_weight)
    inter = _class_sum(probs * oh)
    union = _class_sum(probs) + _class_sum(oh) - inter
    return (1.0 - inter / (union + eps)).mean()


def tversky(logits: Tensor, targets: Tensor, alpha: float = 1.0,
            beta: float = 1.0, eps: float = 1e-6,
            sample_weight: Optional[Tensor] = None) -> Tensor:
    """Tversky loss (reference TverskyLoss, models/losses.py:189-223)."""
    probs, oh = _probs_onehot(logits, targets, sample_weight)
    inter = _class_sum(probs * oh) + eps
    fps = _class_sum(probs * (1 - oh))
    fns = _class_sum((1 - probs) * oh)
    return (1.0 - inter / (inter + alpha * fps + beta * fns)).mean()


def zeroloss(*args, **kwargs) -> Tensor:
    return torch.tensor(0.0)


# ---- regression losses (reference models/losses.py:49-83) ----

def mse(pred: Tensor, target: Tensor, sample_weight=None) -> Tensor:
    return _mean((pred - target) ** 2, sample_weight)


def l1(pred: Tensor, target: Tensor, sample_weight=None) -> Tensor:
    return _mean((pred - target).abs(), sample_weight)


def rmse(pred: Tensor, target: Tensor, sample_weight=None) -> Tensor:
    return torch.sqrt(mse(pred, target, sample_weight))


def logcosh(pred: Tensor, target: Tensor, sample_weight=None) -> Tensor:
    return _mean(torch.log(torch.cosh(pred - target + 1e-12)),
                 sample_weight)


def xtanh(pred: Tensor, target: Tensor, sample_weight=None) -> Tensor:
    e = pred - target
    return _mean(e * torch.tanh(e), sample_weight)


def xsigmoid(pred: Tensor, target: Tensor, sample_weight=None) -> Tensor:
    e = pred - target
    return _mean(2 * e / (1 + torch.exp(-e)) - e, sample_weight)


_REGISTRY = {
    "xent": cross_entropy,
    "bce": bce,
    "focal": focal,
    "ohem": ohem,
    "cent": conditional_entropy_ce,
    "dice": dice,
    "jaccard": jaccard,
    "tversky": tversky,
    "zeroloss": zeroloss,
    "mse": mse,
    "l1": l1,
    "rmse": rmse,
    "logcosh": logcosh,
    "xtanh": xtanh,
    "xsigmoid": xsigmoid,
}


def loss_fn(name: str, **fixed_kwargs) -> Callable[..., Tensor]:
    """The loss ``name`` (reference ``lossfn``, models/losses.py:8-40),
    with ``fixed_kwargs`` (e.g. class_weights) bound."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown loss {name!r}; known: {sorted(_REGISTRY)}")
    base = _REGISTRY[name]
    if not fixed_kwargs:
        return base

    def bound(*args, **kw):
        return base(*args, **{**fixed_kwargs, **kw})

    bound.__name__ = f"{name}_bound"
    return bound
