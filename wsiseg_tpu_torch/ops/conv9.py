"""Fused SAME 3×3/1 convolutions with affine + ReLU epilogues — the port of
``wsiseg_tpu/ops/conv9.py`` and ``wsiseg_tpu/ops/pallas_conv.py``:

- :func:`conv9` — ``conv9`` (``conv9.py:137``, via ``_conv9_padded``
  ``:110``, body ``_conv9_kernel`` ``:49``): one conv, + bias, optional
  ReLU, bf16 or f32 out;
- :func:`conv_chain` — ``conv_chain`` (``conv9.py:360``, via
  ``_chain_padded`` ``:306``, body ``_chain_kernel`` ``:175``): L = 1..3
  fused convs with the ``"full"`` border semantics (out-of-image positions
  re-zeroed between layers, i.e. per-layer SAME zero padding);
- :func:`conv3x3_small` — ``conv3x3_small`` (``pallas_conv.py:43``, body
  ``_head_kernel`` ``:28``): one conv + bias, f32 out, no ReLU.

On a CUDA tensor a single conv (``conv9``, ``conv3x3_small``, a
one-layer ``conv_chain``) launches the TMA/wgmma kernel of
``csrc/conv3x3_sm90.cu`` with the tile plan of :func:`plan_conv9`; a chain
of 2–3 layers launches ``csrc/conv_chain_sm90.cu`` with the strip plan of
:func:`plan_chain`. Both are built with the stem
by :func:`wsiseg_tpu_torch.ops.stem.build_library`; the wrappers count
their launches apart in ``LAUNCHES``. On the card the kernels take bf16
activations and weights, the serving dtype; an f32 activation on a CUDA
tensor raises ``ValueError`` (the ``*_ref`` plain versions run f32 on the
CPU). CPU tensors take the plain versions.

A layer is ``(w, bias, relu)`` with ``w`` (Cout, 9, Cin), tap ``dy·3 +
dx``, and ``bias`` (Cout,) f32, as :func:`prep_layer` makes them from an
HWIO kernel and a BN scale — the host-side weight prep of the JAX
functions (``conv9.py:154-167``, ``:413-437``). Weights take the input's
dtype at each call, as the JAX kernels cast them. The TPU-only 128-lane
channel padding and the Mosaic mask modes are not carried over.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from wsiseg_tpu_torch.ops.stem import check_tensor, kernel_entry

#: kernel launches per wrapper since import (or since a caller reset them)
LAUNCHES = {"conv9": 0, "conv_chain": 0, "conv3x3_small": 0}
#: zero-padding copies made for a single conv whose Cin is not a multiple
#: of 8 (TMA needs 16-byte strides); no fold layer needs one
CHANNEL_PAD_COPIES = 0

#: shared memory a block may use on an H100
MAX_SMEM = 232448
MAX_LAYERS = 3

# conv3x3_sm90.cu's tile: 128 output pixels (1 × 128 or 2 × 64; 256 for
# BN = 128) × BN channels, K chunks of 64 input channels (one 128-byte
# swizzled row per pixel)
TILE_PX = 128
K_STEP = 64
TILE_COLS = (128, 64)
N_TILES = (16, 32, 64, 128, 256)
ERRORS = {9001: "cuTensorMapEncodeTiled not found in the CUDA driver",
          9002: "the CUDA driver refused a tensor map"}

Layer = Tuple[torch.Tensor, torch.Tensor, bool]


@torch.no_grad()
def prep_layer(kernel: torch.Tensor, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               dtype: torch.dtype = torch.bfloat16
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HWIO ``kernel`` (3, 3, Cin, Cout) and per-Cout ``scale`` → (w
    (Cout, 9, Cin), bias (Cout,) f32): ``kernel · scale`` in f32, rounded
    once to ``dtype``; a missing bias is zero."""
    kf = kernel.float()
    if scale is not None:
        kf = kf * scale.float()
    cin, cout = kf.shape[2], kf.shape[3]
    b = (torch.zeros(cout, dtype=torch.float32, device=kf.device)
         if bias is None else bias.float())
    w = kf.permute(3, 0, 1, 2).reshape(cout, 9, cin)
    return w.to(dtype).contiguous(), b.contiguous()


def _batched(x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 3:
        return x[None]
    if x.dim() != 4:
        raise ValueError(f"x must be (H, W, C) or (N, H, W, C), got "
                         f"{tuple(x.shape)}")
    return x


def _conv_ref(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              relu: bool, out_dtype: torch.dtype) -> torch.Tensor:
    """One SAME conv of NHWC ``x`` in f32 (exact products of the rounded
    operands, f32 sums), + bias, ReLU, rounded to ``out_dtype``."""
    cout, _, cin = w.shape
    k = w.to(x.dtype).float().view(cout, 3, 3, cin).permute(0, 3, 1, 2)
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), k, padding=1)
    y = y + bias.float().view(1, -1, 1, 1)
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


@torch.no_grad()
def conv9_ref(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              relu: bool = False,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of :func:`conv9`."""
    y = _conv_ref(_batched(x), w, bias, relu, out_dtype)
    return y[0] if x.dim() == 3 else y


@torch.no_grad()
def conv_chain_ref(x: torch.Tensor, layers: Sequence[Layer],
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of :func:`conv_chain`: the layers one by one, each
    with its own SAME zero padding (so out-of-image positions read zero at
    every layer), intermediates rounded to the input's dtype."""
    y = _batched(x)
    for i, (w, b, relu) in enumerate(layers):
        y = _conv_ref(y, w, b, relu,
                      out_dtype if i + 1 == len(layers) else x.dtype)
    return y[0] if x.dim() == 3 else y


@torch.no_grad()
def conv3x3_small_ref(x: torch.Tensor, kernel: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`conv3x3_small`."""
    w, b = prep_layer(kernel, None, bias, x.dtype)
    return conv9_ref(x, w, b, relu=False, out_dtype=torch.float32)


@dataclass(frozen=True)
class ConvPlan:
    """How ``conv3x3_sm90.cu`` covers one conv: tiles of ``tr × tc``
    output pixels (128; 256 for ``bn = 128``, two m64 tiles per consumer
    warpgroup) and ``bn`` output channels, K in 64-channel chunks of 9
    taps. Each of ``stages`` ring stages holds one tap's ``bn × 64``
    weight box and, for ``bn ≥ 128``, the tap's shifted ``tr × tc × 64``
    x box; for ``bn ≤ 64`` one ``(tr + 2) × (tc + 2) × 64`` halo window
    per chunk serves all nine taps (``window``)."""
    n: int
    h: int
    w: int
    cin: int
    cout: int
    cin_pad: int        # Cin rounded up to 8: TMA's strides are 16-byte
    tr: int
    tc: int
    bn: int
    stages: int

    @property
    def tiles_x(self) -> int:
        return -(-self.w // self.tc)

    @property
    def tiles_y(self) -> int:
        return -(-self.h // self.tr)

    @property
    def n_tiles(self) -> int:
        return -(-self.cout // self.bn)

    @property
    def tiles(self) -> int:
        """Output tiles; a persistent grid of at most one block per free
        block slot of each SM walks them."""
        return self.n * self.tiles_y * self.tiles_x * self.n_tiles

    @property
    def k_steps(self) -> int:
        return 9 * -(-self.cin_pad // K_STEP)

    @property
    def window(self) -> bool:
        return self.bn <= 64

    @property
    def x_box(self) -> Tuple[int, int, int, int]:
        """The NHWC x box TMA loads: the halo window of a chunk, or one
        tap's shifted tile."""
        halo = 2 if self.window else 0
        return 1, self.tr + halo, self.tc + halo, K_STEP

    @property
    def stage_bytes(self) -> int:
        x = 0 if self.window else math.prod(self.x_box) * 2
        return x + self.bn * K_STEP * 2

    @property
    def smem_bytes(self) -> int:
        # every stage starts on the swizzle's 1024-byte period: + 1024 to
        # align the first
        win = -(-math.prod(self.x_box) * 2 // 1024) * 1024 \
            if self.window else 0
        return win + self.stages * self.stage_bytes + 1024


def plan_conv9(n: int, h: int, w: int, cin: int, cout: int) -> ConvPlan:
    """The tile plan of one SAME 3×3 conv of an (n, h, w, cin) input to
    ``cout`` channels. ``bn`` is the smallest wgmma width that holds Cout,
    at most 256 (wider Couts take more N tiles); a tile is 128 pixels, 256
    for BN = 128. The strip width ``tc`` (128 or 64: each consumer
    warpgroup's 64-pixel m64 tiles lie in one window row) is the one that
    computes the fewest pixels, the wider on a tie. BN ≤ 64 fits two
    blocks per SM; BN = 128 and 256 fill one SM's shared memory with 4
    stages."""
    if min(n, h, w, cin, cout) < 1:
        raise ValueError(f"empty conv: n={n} h={h} w={w} cin={cin} "
                         f"cout={cout}")
    bn = next((b for b in N_TILES if b >= cout), N_TILES[-1])
    px = 2 * TILE_PX if bn == 128 else TILE_PX

    def computed(tc):
        tr = px // tc
        return -(-w // tc) * tc * -(-h // tr) * tr

    tc = min(TILE_COLS, key=lambda c: (computed(c), -c))
    stages = {16: 8, 32: 4, 64: 4, 128: 4, 256: 4}[bn]
    plan = ConvPlan(n, h, w, cin, cout, 8 * math.ceil(cin / 8), px // tc,
                    tc, bn, stages)
    if plan.smem_bytes > MAX_SMEM:
        raise ValueError(f"{plan} needs {plan.smem_bytes} bytes of shared "
                         f"memory per block, over {MAX_SMEM}")
    return plan


# conv_chain_sm90.cu: every layer's rows are 64 positions at one pitch
# (one m64 tile), a strip yields 64 - 2L output columns; its instantiations
# (WSISEG_CHAIN_FORMS): (L, inner width NM, last width NL) → m64 rows per
# consumer warpgroup and step (MT): as many as the accumulators (128 a
# thread) and the rings leave room for; three for block4+head took 17 %
# off its time against two (chain_parts, PERF.md §6)
CHAIN_PITCH = 64
CHAIN_FORMS = {(2, 64, 64): 2, (2, 128, 128): 2, (2, 256, 256): 1,
               (3, 64, 16): 3, (3, 128, 128): 1}
CHAIN_MAX_STAGES = 16
CHAIN_BOX_N = 128            # a weight stage's output channels at most
H100_SMS = 132
PLANE_BYTES = CHAIN_PITCH * K_STEP * 2      # one row's 64-channel plane


@dataclass(frozen=True)
class ChainPlan:
    """How ``conv_chain_sm90.cu`` covers an L-layer chain: tiles of ``seg``
    output rows × ``tc`` output columns (a strip), walked in steps of ``s``
    rows per layer. Layer l's position m is image column ``x0 - L + l + 1
    + m``; its rows are recomputed ``L - 1 - l`` rows above and below a
    segment. Inner layers (width ``nm``) keep ``ring_rows`` rows in shared
    memory; layer 0 reads ``nwin`` TMA windows of ``s + 2`` rows; weights
    stream through ``stages`` stages of one tap's ``min(N, 128) × 64``
    box (two a tap for N = 256)."""
    n: int
    h: int
    w: int
    chans: Tuple[int, ...]
    cin_pad: int
    nm: int
    nl: int
    mt: int
    seg: int
    stages: int
    nwin: int

    @property
    def layers(self) -> int:
        return len(self.chans) - 1

    @property
    def tc(self) -> int:
        return CHAIN_PITCH - 2 * self.layers

    @property
    def s(self) -> int:
        return 2 * self.mt

    @property
    def ring_rows(self) -> int:
        return self.s + 2

    @property
    def tiles_x(self) -> int:
        return -(-self.w // self.tc)

    @property
    def tiles_y(self) -> int:
        return -(-self.h // self.seg)

    @property
    def tiles(self) -> int:
        return self.n * self.tiles_x * self.tiles_y

    def steps(self, rows: int) -> int:
        return -(-(rows + 2 * self.layers - 2) // self.s)

    @property
    def slot_bytes(self) -> int:
        return self.nm // K_STEP * PLANE_BYTES

    @property
    def window_bytes(self) -> int:
        return (self.s + 2) * PLANE_BYTES

    @property
    def stage_bytes(self) -> int:
        return min(self.nm, CHAIN_BOX_N) * K_STEP * 2

    @property
    def smem_bytes(self) -> int:
        # 1024 to align the first stage; 256 past the last window for the
        # shifted reads of the positions no output needs
        return (1024 + self.stages * self.stage_bytes
                + (self.layers - 1) * self.ring_rows * self.slot_bytes
                + self.nwin * self.window_bytes + 256)

    @property
    def recompute(self) -> float:
        """Computed over required multiply-adds: each strip row is 64
        positions, every step computes ``s`` rows of every layer (rows no
        output needs included: the kernel issues every wgmma), K runs in
        64-channel chunks and N is the wgmma width."""
        rows = [self.seg] * (self.h // self.seg) + \
            ([self.h % self.seg] if self.h % self.seg else [])
        steps = sum(self.steps(r) for r in rows) * self.n * self.tiles_x
        done = 0
        for l, ci in enumerate(self.chans[:-1]):
            width = self.nl if l + 1 == self.layers else self.nm
            done += CHAIN_PITCH * 9 * K_STEP * -(-ci // K_STEP) * width
        need = self.n * self.h * self.w * 9 * sum(
            ci * co for ci, co in zip(self.chans[:-1], self.chans[1:]))
        return steps * self.s * done / need


def _chain_form(chans: Sequence[int]) -> Tuple[int, int, int]:
    L = len(chans) - 1
    mid, last = max(chans[1:-1]), chans[-1]
    for (fl, nm, nl), mt in sorted(CHAIN_FORMS.items()):
        if fl == L and nm >= mid and nl >= last:
            return nm, nl, mt
    raise ValueError(f"no conv_chain_sm90 form for channels {list(chans)}: "
                     f"inner widths up to 256, the last up to the inner "
                     f"width ({sorted(CHAIN_FORMS)})")


@functools.lru_cache(maxsize=256)
def plan_chain(n: int, h: int, w: int, chans: Tuple[int, ...]
               ) -> ChainPlan:
    """The strip plan of an L = 2, 3 layer chain of (n, h, w, chans[0])
    through ``chans[1:]``. The widths are the smallest instantiation
    (``CHAIN_FORMS``) that holds the channels; two layer-0 windows when
    layer 0 has more than one 64-channel chunk and they leave room for 4
    weight stages, else one (a single chunk's window loads while the
    later layers run); as many weight stages as fit in 232 448 bytes (at
    most 16). The segment ``seg`` minimises the waves of tiles over the
    H100's 132 SMs (one block each) times a tile's steps, the larger on a
    tie. Raises ValueError on an empty chain, a depth other than 2–3 or a
    chain that does not fit."""
    chans = tuple(int(c) for c in chans)
    if not 3 <= len(chans) <= MAX_LAYERS + 1:
        raise ValueError(f"a chain has 2..{MAX_LAYERS} layers, got "
                         f"channels {list(chans)}")
    if min(n, h, w, *chans) < 1:
        raise ValueError(f"empty chain: n={n} h={h} w={w} chans="
                         f"{list(chans)}")
    nm, nl, mt = _chain_form(chans)
    base = ChainPlan(n, h, w, chans, 8 * math.ceil(chans[0] / 8), nm, nl,
                     mt, h, 2, 1)
    best = None
    for nwin in (2, 1):
        fit = [s for s in range(2, CHAIN_MAX_STAGES + 1)
               if replace(base, stages=s, nwin=nwin).smem_bytes <= MAX_SMEM]
        if fit and (nwin == 1 or (fit[-1] >= 4 and chans[0] > K_STEP)):
            best = replace(base, stages=fit[-1], nwin=nwin)
            break
    if best is None:
        raise ValueError(f"{base} needs "
                         f"{replace(base, nwin=1).smem_bytes} bytes of "
                         f"shared memory per block, over {MAX_SMEM}")

    def cost(seg):
        p = replace(best, seg=seg)
        return -(-p.tiles // H100_SMS) * p.steps(seg), -seg

    return replace(best, seg=min(range(1, h + 1), key=cost))


def pad_channels(x: torch.Tensor, w: torch.Tensor, cin_pad: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, H, W, Cin) and w (Cout, 9, Cin) with zero channels appended up
    to ``cin_pad``: the same conv, with 16-byte channel strides. A copy of
    both; counted in ``CHANNEL_PAD_COPIES``."""
    global CHANNEL_PAD_COPIES
    extra = cin_pad - x.shape[-1]
    CHANNEL_PAD_COPIES += 1
    return (F.pad(x, (0, extra)).contiguous(),
            F.pad(w, (0, extra)).contiguous())


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned base (TMA's rule)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_bf16(x: torch.Tensor, out_dtype: torch.dtype,
                ref_name: str) -> None:
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the conv3x3 kernels take bf16 activations on the "
                         f"card, got {x.dtype}; {ref_name} is the plain "
                         "version for other dtypes")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or f32, got {out_dtype}")


def _launch_sm90(x: torch.Tensor, layer: Layer, out_dtype: torch.dtype,
                 ref_name: str) -> torch.Tensor:
    """Run conv3x3_sm90.cu on NHWC ``x``; raises on what it does not
    take."""
    _check_bf16(x, out_dtype, ref_name)
    wl, bl, relu = layer
    n, h, w, cin = x.shape
    dev = x.device
    cout = wl.shape[0]
    check_tensor(wl, "weights", torch.bfloat16, (cout, 9, cin), dev)
    check_tensor(bl, "bias", torch.float32, (cout,), dev)
    plan = plan_conv9(n, h, w, cin, cout)
    if plan.cin_pad != cin:
        x, wl = pad_channels(x, wl, plan.cin_pad)
    x, wl = _aligned(x), _aligned(wl)
    out = torch.empty((n, h, w, cout), dtype=out_dtype, device=dev)
    fn = kernel_entry("wsiseg_conv9_sm90",
                      [ctypes.c_void_p] + [ctypes.c_int] * 4
                      + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                      + [ctypes.c_void_p] + [ctypes.c_int] * 5
                      + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), n, h, w, plan.cin_pad, wl.data_ptr(),
                 bl.data_ptr(), cout, int(bool(relu)),
                 int(out_dtype == torch.float32), out.data_ptr(), plan.tr,
                 plan.tc, plan.bn, plan.stages, plan.smem_bytes,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_sm90 kernel launch failed: "
                           f"{ERRORS.get(err, f'CUDA error {err}')}")
    return out


def _pad_k(wl: torch.Tensor) -> torch.Tensor:
    """Layer weights (Cout, 9, Cin) with zero input channels up to a
    multiple of 8 (TMA's 16-byte strides); the weights as they are when
    Cin % 8 == 0."""
    extra = -wl.shape[2] % 8
    return F.pad(wl, (0, extra)) if extra else wl


def _launch_chain(x: torch.Tensor, layers: Sequence[Layer],
                  out_dtype: torch.dtype, ref_name: str) -> torch.Tensor:
    """Run conv_chain_sm90.cu (2..3 layers) on NHWC ``x``; raises on what
    it does not take."""
    _check_bf16(x, out_dtype, ref_name)
    if not 2 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"2..{MAX_LAYERS} layers, got {len(layers)}")
    n, h, w, cin = x.shape
    dev = x.device
    chans, relu_mask = [cin], 0
    for i, (wl, bl, relu) in enumerate(layers):
        cout = wl.shape[0]
        check_tensor(wl, f"layer {i} weights", torch.bfloat16,
                     (cout, 9, chans[-1]), dev)
        check_tensor(bl, f"layer {i} bias", torch.float32, (cout,), dev)
        relu_mask |= int(bool(relu)) << i
        chans.append(cout)
    plan = plan_chain(n, h, w, tuple(chans))
    ws = [wl for wl, _, _ in layers]
    if plan.cin_pad != cin:
        x, ws[0] = pad_channels(x, ws[0], plan.cin_pad)
    x = _aligned(x)
    ws = [_aligned(ws[0])] + [_aligned(_pad_k(wl)) for wl in ws[1:]]
    args = []
    for wl, (_, bl, _) in zip(ws, layers):
        args += [wl.data_ptr(), bl.data_ptr(), wl.shape[0]]
    args += [None, None, 0] * (MAX_LAYERS - len(layers))
    out = torch.empty((n, h, w, chans[-1]), dtype=out_dtype, device=dev)
    fn = kernel_entry("wsiseg_conv_chain_sm90",
                      [ctypes.c_void_p] + [ctypes.c_int] * 5
                      + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] * 3
                      + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                      + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), n, h, w, plan.cin_pad, len(layers), *args,
                 relu_mask, int(out_dtype == torch.float32), out.data_ptr(),
                 plan.nm, plan.nl, plan.mt, plan.seg, plan.stages,
                 plan.nwin, plan.smem_bytes,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_chain_sm90 kernel launch failed: "
                           f"{ERRORS.get(err, f'CUDA error {err}')}")
    return out


def _run(name: str, ref, x: torch.Tensor, layers: Sequence[Layer],
         out_dtype: torch.dtype) -> torch.Tensor:
    layers = [(w.to(x.dtype), b, relu) for w, b, relu in layers]
    if x.device.type == "cpu":
        return ref(x, layers, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no conv3x3 kernel for device {x.device}")
    xb = _batched(x)
    if len(layers) == 1:
        y = _launch_sm90(xb, layers[0], out_dtype, f"{name}_ref")
    else:
        y = _launch_chain(xb, layers, out_dtype, f"{name}_ref")
    LAUNCHES[name] += 1
    return y[0] if x.dim() == 3 else y


def conv9(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
          relu: bool = False,
          out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """SAME 3×3/1 conv of x ((N,) H, W, Cin NHWC) with prepared weights
    (:func:`prep_layer`): ``conv(x, w) + bias``, optional ReLU, f32
    accumulation, rounded to ``out_dtype``. CPU tensors take
    :func:`conv9_ref`; CUDA tensors launch ``conv3x3_sm90.cu``."""
    return _run("conv9", lambda x_, ls, od: conv9_ref(x_, *ls[0], od), x,
                [(w, bias, relu)], out_dtype)


def conv_chain(x: torch.Tensor, layers: Sequence[Layer],
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """L = 1..3 fused SAME 3×3/1 convs of x ((N,) H, W, C0 NHWC), each
    ``(w, bias, relu)`` from :func:`prep_layer`; intermediates in x's dtype
    and re-zeroed outside the image, only the last layer is written, in
    ``out_dtype``. CPU tensors take :func:`conv_chain_ref`; CUDA tensors
    launch ``conv_chain_sm90.cu`` (one layer: ``conv3x3_sm90.cu``)."""
    return _run("conv_chain", conv_chain_ref, x, layers, out_dtype)


def conv3x3_small(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME 3×3 conv + bias with an f32 output and no ReLU; ``kernel`` is
    HWIO (3, 3, Cin, Cout) and takes x's dtype. CPU tensors take
    :func:`conv3x3_small_ref`; CUDA tensors launch
    ``conv3x3_sm90.cu``."""
    w, b = prep_layer(kernel, None, bias, x.dtype)
    return _run("conv3x3_small",
                lambda x_, ls, od: conv9_ref(x_, *ls[0], od), x,
                [(w, b, False)], torch.float32)
