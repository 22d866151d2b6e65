"""Collectives of the multi-rank port — what GSPMD inserts for the JAX
package (``jax.lax.psum``, the all-gather of a sharded output,
``jax.lax.ppermute``), as explicit calls every rank makes.

The port is multi-controller: every rank runs the same Python on its own
rows. :func:`data_parallel` names the group whose ranks share a batch;
inside it :func:`global_sum` all-reduces a sum and carries its gradient
back, so every reduction across samples (BatchNorm moments, a loss's
numerator and denominator, OHEM's ranking) is the global one, as under
JAX's mesh. Outside it (and with ``group=None`` in no such context) each
function is the identity, so the single-device code paths are unchanged.

Gradients: a SUM all-reduce hands each rank back the world size times its
share (every rank holds the same global loss and seeds its backward with
1), so :func:`all_reduce_grads` divides the all-reduced parameter
gradients by the world size, which gives the exact global gradient.

:func:`gather_slots` and :func:`shift` are built from one ``all_reduce``
of a zero-filled ``(world, …)`` slot buffer: that one code path runs on
NCCL, on gloo over CPU tensors and on gloo over CUDA tensors (gloo has no
CUDA ``all_gather`` or ``send``/``recv``). The halos it carries are a
stripe or less, so the world-size factor in bytes does not matter yet.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterable

import torch
import torch.distributed as dist

_DATA_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "wsiseg_data_group", default=None)


def as_group(mesh_or_group):
    """The process group of a 1-D ``DeviceMesh`` (or a group as given)."""
    get = getattr(mesh_or_group, "get_group", None)
    return get() if get is not None else mesh_or_group


@contextlib.contextmanager
def data_parallel(mesh_or_group):
    """Run the enclosed forward and backward over the data group of
    ``mesh_or_group`` (None: single device)."""
    token = _DATA_GROUP.set(None if mesh_or_group is None
                            else as_group(mesh_or_group))
    try:
        yield
    finally:
        _DATA_GROUP.reset(token)


def _resolve(group):
    """``group`` (a mesh or a group), or the enclosing
    :func:`data_parallel`'s; None without either."""
    return _DATA_GROUP.get() if group is None else as_group(group)


def world(group=None) -> int:
    """Ranks in ``group`` (default: the data group); 1 without one."""
    g = _resolve(group)
    return 1 if g is None else dist.get_world_size(g)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def global_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over the group's ranks of ``t`` (differentiable); ``t`` itself
    without a group."""
    g = _resolve(group)
    if g is None or dist.get_world_size(g) == 1:
        return t
    return _AllReduceSum.apply(t, g)


def _slots(t: torch.Tensor, g) -> torch.Tensor:
    """Σ over ranks of an (n, …) zero buffer holding each rank's ``t`` at
    its index: differentiable for floating types. Any other type goes as
    its bytes, summed as int32 words: one rank's bytes plus zeros are
    those bytes exactly, and every backend sums int32."""
    r, n = dist.get_rank(g), dist.get_world_size(g)
    if t.is_floating_point():
        return _AllReduceSum.apply(
            torch.stack([t if i == r else torch.zeros_like(t)
                         for i in range(n)]), g)
    raw = t.contiguous().view(torch.uint8).reshape(-1)
    m = raw.numel()
    buf = torch.zeros((n, m + (-m) % 4), dtype=torch.uint8, device=t.device)
    buf[r, :m] = raw
    dist.all_reduce(buf.view(torch.int32), group=g)
    return buf[:, :m].contiguous().view(t.dtype).reshape((n,) + t.shape)


def gather_slots(t: torch.Tensor, group=None) -> torch.Tensor:
    """(world, …): every rank's ``t`` (equal shapes) in rank order
    (differentiable for floating types); ``t[None]`` without a group."""
    g = _resolve(group)
    if g is None:
        return t[None]
    return _slots(t, g)


def shift(t: torch.Tensor, k: int, group=None) -> torch.Tensor:
    """``jax.lax.ppermute`` with the permutation (i, i + k): rank i + k
    receives rank i's ``t``; ranks below k receive zeros."""
    g = _resolve(group)
    if g is None:
        return torch.zeros_like(t)
    r = dist.get_rank(g)
    buf = _slots(t, g)                # every rank joins the collective
    return buf[r - k] if r >= k else torch.zeros_like(t)


def gather_objects(obj, group=None) -> list:
    """Every rank's picklable ``obj`` in rank order (``[obj]`` without a
    group, or in a group of one). It travels pickled, through host
    memory: for finished host results, not for tensors a route still
    computes on."""
    g = _resolve(group)
    if g is None or dist.get_world_size(g) == 1:
        return [obj]
    out = [None] * dist.get_world_size(g)
    dist.all_gather_object(out, obj, group=g)
    return out


def _flat_apply(tensors: Iterable[torch.Tensor], op) -> None:
    """``op`` on one flat buffer per (dtype, device) holding ``tensors``,
    copied back in place (one collective each, any memory format)."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        op(flat)
        o = 0
        for t in ts:
            t.copy_(flat[o:o + t.numel()].view(t.shape))
            o += t.numel()


def all_reduce_grads(params: Iterable[torch.nn.Parameter],
                     group=None) -> None:
    """Each ``.grad`` all-reduced and divided by the world size: the
    global gradient of the global loss (module docstring)."""
    g = _resolve(group)
    if g is None:
        return
    n = dist.get_world_size(g)
    grads = [p.grad for p in params if p.grad is not None]

    def op(flat):
        dist.all_reduce(flat, group=g)
        flat.div_(n)

    _flat_apply(grads, op)


def broadcast_tensors(tensors: Iterable[torch.Tensor], group=None,
                      src: int = 0) -> None:
    """Every tensor overwritten in place with rank ``src``'s (group rank)."""
    g = _resolve(group)
    if g is None:
        return
    src_global = dist.get_global_rank(g, src)
    _flat_apply(list(tensors),
                lambda flat: dist.broadcast(flat, src=src_global, group=g))


def any_rank(flag: bool, device, group=None) -> bool:
    """True when ``flag`` is true on any rank of ``group``."""
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    return bool(global_sum(t, group).item() > 0)
