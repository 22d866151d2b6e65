"""Collectives of the multi-rank port — what GSPMD inserts for the JAX
package (``jax.lax.psum``, the all-gather of a sharded output,
``jax.lax.ppermute``), as explicit calls every rank makes.

The port is multi-controller: every rank runs the same Python on its own
rows. :func:`data_parallel` names the group whose ranks share a batch (on
a (data, space) mesh: every rank of the mesh); inside it
:func:`global_sum` all-reduces a sum and carries its gradient back, so
every reduction across samples (BatchNorm moments, a loss's numerator and
denominator, OHEM's ranking) is the global one, as under JAX's mesh.
Outside it (and with ``group=None`` in no such context) each function is
the identity, so the single-device code paths are unchanged.

:func:`spatial` names the space axis of a (data, space) mesh: the ranks
that hold the horizontal stripes of the same tiles
(``parallel/spatial.py`` holds the ops that read it). Without a space
axis it is the identity as well.

Gradients: a SUM all-reduce hands each rank back the world size times its
share (every rank holds the same global loss and seeds its backward with
1), so :func:`all_reduce_grads` divides the all-reduced parameter
gradients by the world size, which gives the exact global gradient. This
holds for any forward built from local ops and collectives whose backward
all-reduces, replicated work included: a value every space rank computes
alike enters a global ratio's numerator and denominator once per rank,
and the factors cancel.

:func:`gather_slots` and :func:`shift` are built from one ``all_reduce``
of a zero-filled ``(world, …)`` slot buffer: that one code path runs on
NCCL, on gloo over CPU tensors and on gloo over CUDA tensors (gloo has no
CUDA ``all_gather`` or ``send``/``recv``). The halos it carries are a
stripe or less, so the world-size factor in bytes does not matter yet.

``ALLREDUCE_CALLS`` and ``ALLREDUCE_BYTES`` count every all-reduce these
functions make (forward and backward of :func:`global_sum`, the slot
buffers, the gradients) and the bytes of each rank's buffer, since import
(or since a caller reset them to 0). The gradient all-reduce runs in
range ``comm.grads``. A single device makes none: nothing here runs
without a group of more than one rank.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterable

import torch
import torch.distributed as dist
from torch.profiler import record_function

_DATA_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "wsiseg_data_group", default=None)
_SPACE: contextvars.ContextVar = contextvars.ContextVar(
    "wsiseg_space", default=None)
_STRIPED: contextvars.ContextVar = contextvars.ContextVar(
    "wsiseg_striped", default=True)

#: all-reduces made since import (or since a caller reset it to 0)
ALLREDUCE_CALLS = 0
#: bytes of each rank's buffer in those all-reduces
ALLREDUCE_BYTES = 0


def all_reduce(t: torch.Tensor, group) -> None:
    """``dist.all_reduce`` (sum) of ``t`` in place over ``group``, counted
    in ``ALLREDUCE_CALLS`` and ``ALLREDUCE_BYTES``."""
    global ALLREDUCE_CALLS, ALLREDUCE_BYTES
    ALLREDUCE_CALLS += 1
    ALLREDUCE_BYTES += t.numel() * t.element_size()
    dist.all_reduce(t, group=group)


def as_group(mesh_or_group):
    """The process group of a ``DeviceMesh``: its one group when 1-D, the
    group of all its ranks (``parallel.mesh.make_mesh`` makes it) when
    it has more dims; a group as given."""
    dims = getattr(mesh_or_group, "mesh_dim_names", None)
    if dims is not None and len(dims) > 1:
        flat = getattr(mesh_or_group, "flat_group", None)
        if flat is None:
            raise ValueError("a mesh of more than one dim needs the group "
                             "of all its ranks: build it with "
                             "parallel.mesh.make_mesh")
        return flat
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


class Space:
    """The space axis of a (data, space) mesh as one rank sees it: the
    ``group`` of the ranks that hold the ``size`` stripes of the same
    tiles, and this rank's stripe index ``rank``."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size


@contextlib.contextmanager
def spatial(mesh_or_space):
    """Run the enclosed forward on this rank's stripe of each tile: the
    ``space`` dim of ``mesh_or_space`` (or a :class:`Space` as given).
    Yields the Space; without such a dim (or with None) it yields None and
    changes nothing."""
    sp = mesh_or_space
    if sp is not None and not isinstance(sp, Space):
        names = tuple(sp.mesh_dim_names or ())
        sp = (Space(sp.get_group("space"), sp.get_local_rank("space"),
                    sp.size(names.index("space")))
              if "space" in names else None)
    token, flag = _SPACE.set(sp), _STRIPED.set(True)
    try:
        yield sp
    finally:
        _STRIPED.reset(flag)
        _SPACE.reset(token)


def space_root():
    """The enclosing :func:`spatial`'s Space, whatever the enclosed ops
    see now; None outside one."""
    return _SPACE.get()


def space():
    """The enclosing :func:`spatial`'s Space while the ops see stripes;
    None in a :func:`striped` (False) region and outside one."""
    sp = _SPACE.get()
    return sp if sp is not None and _STRIPED.get() else None


@contextlib.contextmanager
def striped(flag: bool):
    """Inside :func:`spatial`: whether the enclosed ops see stripes
    (True) or whole maps, which every space rank computes alike."""
    token = _STRIPED.set(bool(flag))
    try:
        yield
    finally:
        _STRIPED.reset(token)


def _resolve(group):
    """``group`` (a mesh or a group), or the enclosing
    :func:`data_parallel`'s; None without either."""
    return _DATA_GROUP.get() if group is None else as_group(group)


def data_group():
    """The enclosing :func:`data_parallel`'s group (None without one)."""
    return _DATA_GROUP.get()


def world(group=None) -> int:
    """Ranks in ``group`` (default: the data group); 1 without one."""
    g = _resolve(group)
    return 1 if g is None else dist.get_world_size(g)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        all_reduce(y, group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce(g, ctx.group)
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
        # 16-bit floats travel as float32 (exact: one value per slot), as
        # not every backend sums them on every device
        w = t.float() if t.element_size() < 4 else t
        return _AllReduceSum.apply(
            torch.stack([w if i == r else torch.zeros_like(w)
                         for i in range(n)]), g).to(t.dtype)
    raw = t.contiguous().view(torch.uint8).reshape(-1)
    m = raw.numel()
    buf = torch.zeros((n, m + (-m) % 4), dtype=torch.uint8, device=t.device)
    buf[r, :m] = raw
    all_reduce(buf.view(torch.int32), g)
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
    global gradient of the global loss (module docstring); in range
    ``comm.grads``."""
    g = _resolve(group)
    if g is None:
        return
    n = dist.get_world_size(g)
    grads = [p.grad for p in params if p.grad is not None]

    def op(flat):
        all_reduce(flat, g)
        flat.div_(n)

    with record_function("comm.grads"):
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
