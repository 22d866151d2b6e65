"""Spatial (data × space) training: the ops that run a model on horizontal
stripes of its tiles — what GSPMD inserts for the JAX package's
``shard_batch_spatial`` (its halo collective-permutes), as explicit
collectives over the space group of :func:`~.comm.spatial`.

Each space rank s of M holds rows [s·h, (s+1)·h) of every tile, h = H/M.
An op whose output row depends on neighbouring input rows takes them from
the neighbouring ranks (:func:`neighbour_rows`: the top rows from the rank
above, the bottom rows from the rank below; zeros, −∞ or the edge row at
the tile's true top and bottom), so that its own padding applies at the
true edges only. :func:`halo_rows` derives the rows from an op's kernel
k, stride s and padding p: (p, max(0, k − s − p)) at the input's
resolution. So conv1 (7×7/2, pad 3) takes (3, 2), a 3×3/1 conv (1, 1), a
3×3/2 conv and ``max_pool2d(3, 2, 1)`` (1, 0), a 1×1 conv none, a nearest
2× none and a half-pixel linear upsample (1, 1) at the low resolution.
Each exchange is one all-reduce of a zero-filled slot buffer
(``comm.gather_slots``, the mechanism of ``comm.shift``), differentiable,
its backward the transpose; every rank's result depends on it, so every
rank's backward joins it. A conv or pool runs on the stripe with its own
padding and recomputes the output rows whose window crosses an edge from
a slab between the received rows (:func:`_on_stripe`): its backward keeps
the stripe, which the ReLU before it keeps as well, not a halo'd copy.

The gather rule. Level l of the pyramid is the map at stride 2^l (level 0
the input, 1 conv1's output c1, 2–5 c2–c5). A stride-2 op keeps whole,
aligned output rows only when the stripe's first row is a multiple of 2,
i.e. when the stripe height is even, and its halo must fit inside one
neighbour's stripe. So level l runs on stripes when level l − 1 does,
its stripe height is even and at least the op's largest halo row count
(:func:`plan`, computed once a forward from the input stripe's height;
the encoder returns it with its features, a :class:`Pyramid`, and the
decoders and heads take it from there). Where that fails, the stage's input is gathered over the space group and
that level and every deeper one run on whole maps, which every space rank
computes alike. The decoders follow the encoder's plan level by level:
where a whole map reaches a level that runs on stripes, it is split there
again, so that a skip and the upsampled map meet as stripes of equal
height. PSPNet's pooled bins are global, so c5 is gathered before its
decoder; OHEM's 1/16 antialiased resize and its ranking see gathered
logits (``losses.ohem``). The seg logits always end on stripes, as the
labels are. At 64² tiles over 2 space ranks every level runs on stripes;
at 32² over 4 (stripe 8 rows) levels 4 and 5 are gathered, at 32² over 2
level 5.

The heads' global average pool over a stripe is the space group's mean
(:func:`mean_hw`). BatchNorm and every loss reduce over all the mesh's
ranks (``comm.data_parallel``): on a gathered stage each pixel enters
the moments once per space rank, numerator and count alike.

Without an enclosing :func:`~.comm.spatial` (or in a
``comm.striped(False)`` region) every op here is the plain one.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from wsiseg_tpu_torch.parallel import comm

#: (kernel, stride, padding) of the stride-2 op that makes each level of
#: the ResNet encoder from the one above: conv1, then the max pool and
#: each stage's first 3×3/2 conv (its 1×1/2 shortcut needs no halo)
STRIDE_OPS = {1: (7, 2, 3), 2: (3, 2, 1), 3: (3, 2, 1), 4: (3, 2, 1),
              5: (3, 2, 1)}


def halo_rows(k: int, s: int, p: int) -> Tuple[int, int]:
    """(top, bottom) rows a stripe needs from its neighbours for an op of
    kernel ``k``, stride ``s`` and padding ``p`` along the height: the
    first output row reads p rows above the stripe, the last k − s − p
    rows below it."""
    return p, max(0, k - s - p)


def plan(h0: int) -> Tuple[bool, ...]:
    """Which levels 0–5 run on stripes for an input stripe of ``h0`` rows
    (module docstring): level 0 always; level l when level l − 1 does and
    its stripe height is even and holds the halo of :data:`STRIDE_OPS`."""
    levels, h = [True], h0
    for lvl in range(1, 6):
        k, s, p = STRIDE_OPS[lvl]
        ok = levels[-1] and h % s == 0 and max(halo_rows(k, s, p)) <= h
        levels.append(ok)
        if ok:
            h //= s
    return tuple(levels)


class Pyramid(list):
    """The encoder's features [c5, c4, c3, c2, c1] with the ``levels`` of
    the forward that made them (:func:`plan`; None when they are whole
    maps), which the decoders and heads follow."""

    def __init__(self, features, levels: Optional[Tuple[bool, ...]] = None):
        super().__init__(features)
        self.levels = levels


def levels_of(features) -> Optional[Tuple[bool, ...]]:
    """The plan ``features`` were made by (None for a plain list)."""
    return getattr(features, "levels", None)


def _striped(levels: Tuple[bool, ...], level: Optional[int]) -> bool:
    return level is not None and levels[level]


def at(levels: Optional[Tuple[bool, ...]], level: Optional[int]):
    """A context in which the ops see level ``level`` as ``levels`` has it
    (None: a whole map); a null context without a plan."""
    if levels is None:
        return contextlib.nullcontext()
    return comm.striped(_striped(levels, level))


def whole():
    """A context in which the ops see whole maps (the HR ensemble's
    patches, which split over the space ranks whole)."""
    return comm.striped(False)


def settle(x: torch.Tensor, levels: Optional[Tuple[bool, ...]],
           src: Optional[int], dst: Optional[int]) -> torch.Tensor:
    """``x``, held as ``levels`` holds level ``src`` (None: whole), as
    level ``dst`` is held: gathered when it leaves stripes, split when it
    enters them; ``x`` itself without a plan."""
    sp = comm.space_root()
    if sp is None or levels is None:
        return x
    a, b = _striped(levels, src), _striped(levels, dst)
    if a and not b:
        return gather(x, sp)
    if b and not a:
        return split(x, sp)
    return x


def source_rows(h: int, levels: Optional[Tuple[bool, ...]],
                src: Optional[int], dst: Optional[int]) -> int:
    """The rows a map of level ``src`` must be resized to so that
    :func:`settle` to level ``dst`` leaves ``h`` rows."""
    sp = comm.space_root()
    if sp is None or levels is None:
        return h
    striped = _striped(levels, dst) and not _striped(levels, src)
    return h * sp.size if striped else h


def gather(x: torch.Tensor, sp: comm.Space) -> torch.Tensor:
    """The whole map from every space rank's stripe (rows on dim −2),
    in stripe order; differentiable for floating types."""
    if sp.size == 1:
        return x
    every = comm.gather_slots(x.contiguous(), sp.group)
    every = every.movedim(0, -3)
    return every.reshape(*every.shape[:-3], -1, every.shape[-1])


def split(x: torch.Tensor, sp: comm.Space) -> torch.Tensor:
    """This rank's stripe of a whole map (rows on dim −2)."""
    n = x.shape[-2]
    if n % sp.size:
        raise ValueError(f"a map of {n} rows does not split over "
                         f"{sp.size} space ranks")
    h = n // sp.size
    return x[..., sp.rank * h:(sp.rank + 1) * h, :]


def gather_patches(f: torch.Tensor, sp: Optional[comm.Space]
                   ) -> torch.Tensor:
    """(B, p, …) → (B, M·p, …): every space rank's patches of each row,
    in patch order (rank s holds patches [s·p, (s+1)·p))."""
    if sp is None or sp.size == 1:
        return f
    every = comm.gather_slots(f.contiguous(), sp.group)
    return every.movedim(0, 1).reshape(f.shape[0], -1, *f.shape[2:])


def neighbour_rows(x: torch.Tensor, top: int, bottom: int, sp: comm.Space,
                   fill="zero") -> Tuple[torch.Tensor, torch.Tensor]:
    """(above, below): the ``top`` last rows of the rank above and the
    ``bottom`` first rows of the rank below this rank's (…, h, w) stripe,
    in one collective. At the tile's true top and bottom (space ranks 0
    and M − 1) the rows are ``fill``: ``"zero"``, ``"-inf"`` or
    ``"edge"`` (the stripe's own edge row repeated)."""
    h = x.shape[-2]
    if max(top, bottom) > h:
        raise ValueError(f"a halo of {max(top, bottom)} rows does not fit "
                         f"in a stripe of {h}")

    def pad(n: int, row: slice) -> torch.Tensor:
        if fill == "edge":
            return x[..., row, :].expand(*x.shape[:-2], n, x.shape[-1])
        value = float("-inf") if fill == "-inf" else 0.0
        return x.new_full((*x.shape[:-2], n, x.shape[-1]), value)

    above, below = pad(top, slice(0, 1)), pad(bottom, slice(h - 1, h))
    if sp.size == 1 or not (top or bottom):
        return above, below
    edge = torch.cat([x[..., :bottom, :], x[..., h - top:, :]], dim=-2)
    every = comm.gather_slots(edge.contiguous(), sp.group)
    got_above = every[(sp.rank - 1) % sp.size][..., bottom:, :]
    got_below = every[(sp.rank + 1) % sp.size][..., :bottom, :]
    # at the true edges the rows are the fill, and the received rows enter
    # times 0: every rank's backward then joins the collective's, whichever
    # of the two its op reads
    above = above + got_above * 0 if sp.rank == 0 else got_above
    below = below + got_below * 0 if sp.rank == sp.size - 1 else got_below
    return above, below


def halo(x: torch.Tensor, top: int, bottom: int, sp: comm.Space,
         fill="zero") -> torch.Tensor:
    """(…, h, w) → (…, top + h + bottom, w): the stripe between its
    :func:`neighbour_rows`."""
    if top == 0 and bottom == 0:
        return x
    above, below = neighbour_rows(x, top, bottom, sp, fill)
    return torch.cat([above, x, below], dim=-2)


def _check_stride(h: int, s: int, what: str) -> None:
    if h % s:
        raise ValueError(f"{what} of stride {s} on a stripe of {h} rows: "
                         "its output rows would not align (the plan gathers "
                         "such a stage)")


def _on_stripe(x: torch.Tensor, k: int, s: int, p: int, sp: comm.Space,
               run, fill: str = "zero") -> torch.Tensor:
    """``run(t, pad_h)`` (an op of kernel ``k``, stride ``s`` and padding
    ``p`` along the height) on this rank's stripe: the op with its own
    padding, and the output rows whose window crosses the stripe's edge
    again from a slab of its edge rows between its :func:`neighbour_rows`
    (:func:`halo_rows`), unpadded along the height. The backward so keeps
    the stripe itself (which the op before keeps too) and two slabs, not
    a halo'd copy; stripes too short for two slabs take the halo'd copy."""
    h = x.shape[-2]
    _check_stride(h, s, f"a {k}x{k} op")
    top, bottom = halo_rows(k, s, p)
    if top == 0 and bottom == 0:
        return run(x, p)
    n_out = h // s
    n_top = -(-p // s)                         # windows starting above
    top_rows = (n_top - 1) * s - p + k         # stripe rows they read
    first_bottom = -(-(h + p - k + 1) // s)    # windows ending below
    n_bottom = max(0, n_out - first_bottom)
    if top_rows > h or n_top + n_bottom > n_out:
        return run(halo(x, top, bottom, sp, fill), 0)
    above, below = neighbour_rows(x, top, bottom, sp, fill)
    parts = [run(torch.cat([above, x[..., :top_rows, :]], dim=-2), 0),
             run(x, p)[..., n_top:n_out - n_bottom, :]]
    if n_bottom:
        parts.append(run(torch.cat(
            [x[..., first_bottom * s - p:, :], below], dim=-2), 0))
    return torch.cat(parts, dim=-2)


def conv2d(conv: nn.Conv2d, x: torch.Tensor, sp: comm.Space) -> torch.Tensor:
    """``conv`` on this rank's stripe (:func:`_on_stripe`): zeros beyond
    the tile's true edges, as its padding."""
    def run(t, pad_h):
        return F.conv2d(t, conv.weight, conv.bias, conv.stride,
                        (pad_h, conv.padding[1]), conv.dilation, conv.groups)

    return _on_stripe(x, conv.kernel_size[0], conv.stride[0],
                      conv.padding[0], sp, run)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (its parameters, names and state-dict keys) that runs
    on stripes inside :func:`~.comm.spatial` (:func:`conv2d`) and as the
    plain conv everywhere else."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sp = comm.space()
        return super().forward(x) if sp is None else conv2d(self, x, sp)


def max_pool2d(x: torch.Tensor, k: int, s: int, p: int) -> torch.Tensor:
    """``F.max_pool2d(x, k, s, p)``; on a stripe with a −∞ halo."""
    sp = comm.space()
    if sp is None:
        return F.max_pool2d(x, k, s, p)
    return _on_stripe(x, k, s, p, sp,
                      lambda t, pad_h: F.max_pool2d(t, k, s, (pad_h, p)),
                      fill="-inf")


def upsample_linear(x: torch.Tensor, f: int) -> torch.Tensor:
    """(B, C, h, w) → (B, C, f·h, f·w), half-pixel bilinear
    (``F.interpolate(align_corners=False)``, which is JAX's linear resize
    when every axis upsamples). On a stripe: one halo row each side (the
    edge row at the true edges, where the resize clamps), resized, the
    middle f·h rows kept."""
    h, w = x.shape[-2:]
    sp = comm.space()
    if sp is None:
        return F.interpolate(x, size=(f * h, f * w), mode="bilinear",
                             align_corners=False)
    xe = halo(x, 1, 1, sp, fill="edge")
    y = F.interpolate(xe, size=(f * (h + 2), f * w), mode="bilinear",
                      align_corners=False)
    return y[..., f:f * (h + 1), :]


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """``x.mean(dim=(2, 3))``; on a stripe the space group's mean."""
    sp = comm.space()
    if sp is None or sp.size == 1:
        return x.mean(dim=(2, 3))
    total = comm.global_sum(x.sum(dim=(2, 3)), sp.group)
    return total / (sp.size * x.shape[2] * x.shape[3])
