"""Dense whole-slide inference engine — counterpart of
``wsiseg_tpu/infer/engine.py`` (``DenseInferenceEngine``, single-device
routes). Two modes, as there:

- **grid** (``predict_slide``, ``predict_slide_streamed``): the
  reference's tile grid and overlap-add semantics, the parity oracle.
  Every stride-128 tile goes through the Y-Net in ``cfg.compute_dtype``
  (:func:`~wsiseg_tpu_torch.models.ynet.compute_copy`; Unet with the
  ``decode_fast`` tail), and the tile logits are added into an f32
  ``(H, W, C)`` canvas on the device, one tile after another
  (:mod:`wsiseg_tpu_torch.ops.stitch`). ``mode="cls"`` paints the
  classifier's logits over each tile's window instead. The level image is
  resident on the device (``stage_slide``), or tile batches are decoded
  on the host and prefetched through pinned memory
  (``predict_slide_streamed``).
- **FCN** (``predict_slide_fcn``): each output pixel computed once. The
  default is the fused whole-image route: the 255-padded level image goes
  to the device, the stem kernel + functional Y-Net produce s2d(4) logit
  planes (every family; FPN/PSPNet's native logits are laid out as the
  same planes, :func:`wsiseg_tpu_torch.models.infer_fast.decode`),
  the planar postprocess and a depth-to-space of its u8 label and heat
  planes run on the device, and each slide's full-resolution labels and
  heat are copied to the host. A group's launch never blocks the host,
  so the evaluator's next group is launched before this one is finished
  (``predict_slides_fcn``'s ``ahead``). ``engine.fcn_fold = True``
  (opt-in, as in JAX) takes the fold route instead, for Unet on
  BasicBlock encoders only: the native stem kernel, the encoder and
  ``decode_fold`` on the conv kernels, whose head emits s2d(2) planes.
  An int or tuple ``chunk``, and any route the fused one does not serve
  (cls mode, ``scan_resize`` ≠ 1), run halo-padded chunks through the
  tile forward (``_fcn_full_pass``); a slide over ``fcn_fast_max_px``
  with nothing staged is read and run one band of chunks at a time
  (``predict_slide_fcn_banded``). Scan levels other than 2 resize the
  logit canvas to level 2 before the postprocess (``_postprocess``).
  A MiT model (SegFormer's encoder, global attention) takes the fused
  route only: no halo makes a chunk of it exact, so the chunked, banded,
  fold and sharded-rows routes raise ``ValueError`` for it. Its attention
  sees every pixel of the padded image, so its slides are padded only to
  the FPN's multiples of 32: a slide whose sides are such multiples gets
  the model's own whole-image output.

Every route decides each pixel through one gate (softmax, class floors,
argmax: :func:`~wsiseg_tpu_torch.ops.threshold.gate`), quantises its heat
with :func:`~wsiseg_tpu_torch.ops.threshold.heat_u8` and builds its
results in :meth:`DenseInferenceEngine._results`. Which slides share a
forward is :meth:`DenseInferenceEngine.fcn_group_key`'s decision.
``keep_probs``/``keep_canvas`` return the probabilities and the logit
canvas in JAX's ``(H, W, C)`` layout; on the planar route both are made
on the device from the served forward's head planes. The model's weights
for the fused route, and what the engine needs to know of the model
(peak bytes a pixel, width alignment, whether chunks are exact), are
prepared once, when the engine is built
(:func:`wsiseg_tpu_torch.models.infer_fast.prepare_fast`); the fold
route's and the tile forward's at their first use.

**Sharded routes** (JAX ``engine.py:695-853, 1042-1411``) run over a
``DeviceMesh`` (:mod:`wsiseg_tpu_torch.parallel`): the port is
multi-controller, so every rank calls a route with the same plan(s) and
every rank returns the full :class:`SlideResult`, as JAX returns the
gathered result to its one host.

- ``predict_slide_sharded``: the tile grid split into per-rank blocks,
  each rank adding its tiles into a full local canvas, one all-reduce
  merging the canvases (JAX's ``psum``).
- ``predict_slide_sharded_rows`` and ``predict_slide_streamed_sharded``:
  tiles routed to row stripes by y-origin, each rank's canvas its stripe
  plus the rows its tiles overhang, the overhang moved to the ranks below
  (:func:`~wsiseg_tpu_torch.parallel.comm.shift`, JAX's ``ppermute``),
  the stripes gathered; the streamed route decodes each rank's own tile
  batches on the host.
- ``predict_slides_fcn_sharded``: slide-parallel, each rank serving its
  share of the slides through the fused route (one batched forward, as
  :meth:`_serve`), the finished results gathered.
- ``predict_slide_fcn_sharded_rows``: each rank runs the chunked FCN's
  tile forward on its own 255-padded halo stripe
  (:meth:`stage_slide_fcn_rows`); the stripes are gathered.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.data.pipeline import prefetch_to_device
from wsiseg_tpu_torch.data.wsi_tiles import SlidePlan, resize_mask_to
from wsiseg_tpu_torch.models.decoders import resize_linear
from wsiseg_tpu_torch.models.fast_decoder import S2D_HEAD_F, \
    depth_to_space, prepare_decode_fast, prepare_fold, unet_segment_fast
from wsiseg_tpu_torch.models.infer_fast import FCN_PEAK_BYTES_PER_PX, \
    check_fold, prepare_fast, segment_from_image
from wsiseg_tpu_torch.models.ynet import compute_copy
from wsiseg_tpu_torch.ops.color import normalize
from wsiseg_tpu_torch.ops.hull import convex_hull_image
from wsiseg_tpu_torch.ops.morphology import bwperim, dilate, opening
from wsiseg_tpu_torch.ops.stitch import gather_tiles, \
    scatter_add_scalar_tiles, scatter_add_tiles
from wsiseg_tpu_torch.ops.threshold import gate, heat_u8, threshold_probs, \
    threshold_probs_planar
from wsiseg_tpu_torch.parallel import comm
from wsiseg_tpu_torch.parallel.mesh import mesh_group, mesh_rank, mesh_size

#: Device bytes one slide group of the fused route may take: 64 GB of the
#: card's 80, the rest left for the weights, the allocator's slack and the
#: next group's staged images.
FCN_DEVICE_BUDGET = 64e9
#: Slides per group the cap allows for: the CLI's default
#: ``--slides_in_flight``.
FCN_GROUP_SLIDES = 4
#: Groups of the fused route finished while a later group was already
#: enqueued behind them (``predict_slides_fcn``'s ``ahead``).
AHEAD = 0
#: Whole-image dispatch cap in padded pixels per slide for the ResNet
#: families: 64e9 / (538 B/px · 4 slides) = 29.74 M px, 2.4× the bench
#: slide (4096×3072); mit_b5's is 53.87 M px (297 B/px), swin_b's 26.32 M
#: px (608 B/px). Larger slides
#: take the banded route.
FCN_FAST_MAX_PX = int(FCN_DEVICE_BUDGET
                      // (FCN_PEAK_BYTES_PER_PX * FCN_GROUP_SLIDES))


def fcn_stripe_geometry(h: int, w: int, n_dev: int) -> Tuple[int, int]:
    """Row-stripe chunk geometry shared by
    :meth:`DenseInferenceEngine.predict_slide_fcn_sharded_rows` and its
    single-device oracle ``predict_slide_fcn(chunk=(ch, cw))`` (JAX
    ``engine.py:74-89``): the stripe height covers ``h`` in ``n_dev``
    stripes, 32-aligned; the width is one full-width 512-aligned chunk."""
    per = -(-h // n_dev)
    ch = max(32, -(-per // 32) * 32)
    cw = max(512, -(-w // 512) * 512)
    return ch, cw


@dataclass
class SlideResult:
    name: str
    labels: np.ndarray        # (H2, W2) uint8 argmax classes
    heatmap: np.ndarray       # (H2, W2) float32 in [0, 1]
    num_tiles: int
    seconds: float
    probs: Optional[np.ndarray] = None    # (H2, W2, C) (keep_probs=True)
    canvas: Optional[np.ndarray] = None   # raw logit canvas (keep_canvas)

    @property
    def patches_per_sec(self) -> float:
        return self.num_tiles / self.seconds if self.seconds > 0 else 0.0


@dataclass
class StagedImage:
    """A level image on the device, with the event that marks the end of
    its host→device copy (None when nothing is pending)."""
    tensor: torch.Tensor
    ready: Optional[torch.cuda.Event] = None


@dataclass
class LaunchedGroup:
    """A fused group on its way to the host: its plans, each slide's
    labels and u8 heat in host tensors of their own, filled in the
    compute stream's order, the event recorded after their copies (None
    off a card) and the ``perf_counter`` time its launch began."""
    plans: List[SlidePlan]
    labels: List[torch.Tensor]
    heat: List[torch.Tensor]
    done: Optional[torch.cuda.Event]
    t0: float

    def wait(self) -> None:
        """Block the host until the group's copies are done."""
        if self.done is not None:
            self.done.synchronize()


def _same_plans(a: Sequence[SlidePlan], b: Sequence[SlidePlan]) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` for a CUDA
    device when none is present (entry points never fall back to the
    CPU: the caller asks for it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' (CLI: --device cpu) to run on the "
                           "CPU")
    return device


class DenseInferenceEngine:
    def __init__(self, model, cfg: Config, mode: str = "seg",
                 device="cuda", dtype: torch.dtype = torch.bfloat16):
        self.device = resolve_device(device)
        if mode not in ("seg", "cls"):
            raise ValueError(f"mode must be 'seg' or 'cls', got {mode!r}")
        self.cfg = cfg
        self.mode = mode
        #: the fused route's dtype; the tile forward runs in
        #: ``cfg.compute_dtype`` (JAX: the flax model's dtype)
        self.dtype = dtype
        self.tile_dtype = getattr(torch, cfg.compute_dtype)
        self.batch = cfg.infer_batch_size      # tiles per grid batch
        self.model = model.to(self.device).eval()
        self.fast = prepare_fast(self.model, cfg.dataset_mean,
                                 cfg.dataset_std, dtype)
        self.slides_in_flight = 1
        #: the fold route (JAX ``fcn_fold``, ``engine.py:464-471``), opt-in;
        #: Unet on BasicBlock encoders only
        self.fcn_fold = False
        #: the fused route's cap in padded pixels a slide, at the model's
        #: peak bytes a pixel (``FCN_FAST_MAX_PX`` for the ResNets)
        self.fcn_fast_max_px = int(
            FCN_DEVICE_BUDGET
            // (self.fast.peak_bytes_per_px * FCN_GROUP_SLIDES))
        self._tile_net = None
        self._h2d_stream = None
        self._h2d_lock = threading.Lock()
        #: the group an earlier ``predict_slides_fcn`` launched as its
        #: ``ahead``, not yet finished
        self._ahead: Optional[LaunchedGroup] = None

    def refresh_weights(self) -> None:
        """Take the model's current weights (after training steps changed
        them): the fast path's prepared weights, the fold's with them, are
        prepared again and the tile forward's compute copy is dropped, to
        be rebuilt at its next use. The model is put in eval mode. (JAX
        assigns ``engine.variables``.)"""
        self.model.eval()
        self.fast = prepare_fast(self.model, self.cfg.dataset_mean,
                                 self.cfg.dataset_std, self.dtype)
        self._tile_net = None

    # ---- geometry ----

    def _fcn_fast_dims(self, h: int, w: int) -> Tuple[int, int]:
        """Pad dims for the whole-image path: H a multiple of 32 (even
        dims at every pyramid stage), W a multiple of the model's
        ``FastWeights.w_align`` (256, the stem kernel's row blocks; 32 for
        a MiT model, which has no stem and whose attention sees every
        padded pixel)."""
        return h + (-h) % 32, w + (-w) % self.fast.w_align

    def _fcn_fast_ok(self) -> bool:
        """The fused whole-image route serves this engine: seg mode, no
        ``scan_resize``, any family (the CPU takes the kernels' plain
        versions)."""
        return self.mode == "seg" and self.cfg.scan_resize == 1

    def _fcn_fast_fits(self, plan: SlidePlan) -> bool:
        hp, wp = self._fcn_fast_dims(*plan.stitch_hw)
        return hp * wp <= int(self.fcn_fast_max_px)

    def fcn_group_key(self, plan: SlidePlan) -> Optional[Tuple[int, int]]:
        """The slide's padded dims when the fused planar route serves it
        (seg mode, no ``scan_resize``, stitched at level 2, within
        ``fcn_fast_max_px``): slides with one key may share a batched
        forward. ``None``: the slide is served alone."""
        if (self._fcn_fast_ok() and self._fcn_fast_fits(plan)
                and tuple(plan.stitch_hw) == tuple(plan.canvas_hw)):
            return self._fcn_fast_dims(*plan.stitch_hw)
        return None

    @staticmethod
    def _fcn_geometry(h: int, w: int, chunk, halo: int):
        """FCN chunking (JAX ``_fcn_geometry``): ``chunk=None`` → one
        chunk over the image, dims rounded up to 512 multiples; an int →
        square chunks; a (chunk_h, chunk_w) tuple → rectangular chunks.
        Returns (chunk_h, chunk_w, ny, nx)."""
        if chunk is None:
            return max(512, -(-h // 512) * 512), \
                max(512, -(-w // 512) * 512), 1, 1
        if isinstance(chunk, tuple):
            ch, cw = int(chunk[0]), int(chunk[1])
        else:
            ch = cw = int(chunk)
        return ch, cw, -(-h // ch), -(-w // cw)

    @staticmethod
    def _pad_grid(xs, ys, bs: int):
        """Tile origins padded to a batch multiple: (xs, ys, valid), each
        (n_batches, bs)."""
        n = len(xs)
        pad = (-n) % bs
        xs_p = np.concatenate([xs, np.zeros(pad, np.int32)]).reshape(-1, bs)
        ys_p = np.concatenate([ys, np.zeros(pad, np.int32)]).reshape(-1, bs)
        valid = np.concatenate([np.ones(n, np.float32),
                                np.zeros(pad, np.float32)]).reshape(-1, bs)
        return xs_p, ys_p, valid

    def _half_mask(self, plan: SlidePlan, hwf_padded) -> np.ndarray:
        """Tissue mask at s2d cell resolution (1/f of the full output):
        resized over the TRUE stitch extent, zero-padded to the padded
        cell dims."""
        hs, ws = plan.stitch_hw
        hpf, wpf = hwf_padded
        hp, _ = self._fcn_fast_dims(hs, ws)
        f = max(1, round(hp / hpf))
        m = resize_mask_to(plan.mask, (-(-hs // f), -(-ws // f)))
        return np.pad(m, ((0, hpf - m.shape[0]), (0, wpf - m.shape[1])))

    def _level_mask(self, plan: SlidePlan, hw) -> torch.Tensor:
        return torch.from_numpy(resize_mask_to(plan.mask, hw)) \
            .to(self.device)

    # ---- staging ----

    def _pad_to_fast(self, img: np.ndarray, plan: SlidePlan) -> np.ndarray:
        """Pad a scan-level image to the FCN dims with the 255 background."""
        hs, ws = plan.stitch_hw
        hp, wp = self._fcn_fast_dims(hs, ws)
        if (hp, wp) != img.shape[:2]:
            img = np.pad(img, ((0, hp - hs), (0, wp - ws), (0, 0)),
                         constant_values=255)
        return img

    def _read_level(self, plan: SlidePlan) -> np.ndarray:
        return np.asarray(plan.slide.read_level(self.cfg.scan_level))

    def _read_padded_level(self, plan: SlidePlan) -> np.ndarray:
        return self._pad_to_fast(self._read_level(plan), plan)

    def _stage(self, img: np.ndarray) -> StagedImage:
        """Upload a host image. On a card the copy goes from pinned memory
        on the engine's own copy stream, so a worker thread can stage the
        next slide while this one computes."""
        host = torch.from_numpy(np.ascontiguousarray(img))
        if self.device.type != "cuda":
            return StagedImage(host.to(self.device))
        with self._h2d_lock:
            if self._h2d_stream is None:
                self._h2d_stream = torch.cuda.Stream(self.device)
        host = host.pin_memory()
        with torch.cuda.stream(self._h2d_stream):
            dev = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._h2d_stream)
        return StagedImage(dev, ready)

    def stage_slide(self, plan: SlidePlan) -> StagedImage:
        """Read + upload a slide's scan-level image for
        :meth:`predict_slide` (the grid route's one-ahead staging)."""
        return self._stage(self._read_level(plan))

    def stage_slide_fcn(self, plan: SlidePlan) -> Optional[StagedImage]:
        """Read + pad + upload a slide's level image for the fused FCN
        route (range ``engine.stage``); ``None`` for a slide the fused
        route does not take (cls mode, ``scan_resize`` ≠ 1, over
        ``fcn_fast_max_px``)."""
        if not (self._fcn_fast_ok() and self._fcn_fast_fits(plan)):
            return None
        with record_function("engine.stage"):
            return self._stage(self._read_padded_level(plan))

    def _take(self, staged) -> torch.Tensor:
        """A staged image's tensor, the compute stream made to wait for
        its copy; a tensor is moved to the device."""
        if isinstance(staged, torch.Tensor):
            return staged.to(self.device)
        if staged.ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(staged.ready)
            staged.tensor.record_stream(cur)
        return staged.tensor

    def _pad_255(self, img: torch.Tensor, halo: int, h: int,
                 w: int) -> torch.Tensor:
        """``img`` in a 255 frame: ``halo`` on top and left, out to
        (h + 2·halo, w + 2·halo) (JAX pads on the host, the same bytes)."""
        out = torch.full((h + 2 * halo, w + 2 * halo, 3), 255,
                         dtype=torch.uint8, device=self.device)
        out[halo:halo + img.shape[0], halo:halo + img.shape[1]] = img
        return out

    # ---- tile forward (grid, cls, chunked FCN) ----

    def _tiles_net(self):
        """The Y-Net in ``cfg.compute_dtype`` and, for Unet, the
        ``decode_fast`` weights; built at first use."""
        if self._tile_net is None:
            prep = (prepare_decode_fast(self.model, self.tile_dtype)
                    if self.model.model_name == "Unet" else None)
            self._tile_net = compute_copy(self.model, self.tile_dtype), prep
        return self._tile_net

    def _normalize(self, tiles_u8: torch.Tensor) -> torch.Tensor:
        return normalize(tiles_u8.float() / 255.0, self.cfg.dataset_mean,
                         self.cfg.dataset_std)

    def _segment(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) normalized → (B, nc, H, W) f32 logits: Unet through
        ``unet_segment_fast`` (even dims), the other families through
        ``YNet.segment``, in the compute dtype."""
        net, prep = self._tiles_net()
        x = x.to(self.tile_dtype, memory_format=torch.channels_last)
        if prep is not None and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            return unet_segment_fast(net, prep, x, self.tile_dtype)
        return net.segment(x)

    def _classify(self, tiles_u8: torch.Tensor) -> torch.Tensor:
        net, _ = self._tiles_net()
        x = self._normalize(tiles_u8).permute(0, 3, 1, 2)
        return net.classify(x.to(self.tile_dtype,
                                 memory_format=torch.channels_last))

    def _seg_forward_tiles(self, tiles_u8: torch.Tensor) -> torch.Tensor:
        """(B, th, tw, 3) u8 tiles → (B, th, tw, nc) f32 logits at tile
        resolution, honoring ``scan_resize`` (reference F.interpolate,
        utils/eval.py:202-206, as ``jax.image.resize``: antialiased when
        it shrinks)."""
        cfg = self.cfg
        x = self._normalize(tiles_u8).permute(0, 3, 1, 2)
        if cfg.scan_resize != 1:
            x = resize_linear(x, cfg.tile_h // cfg.scan_resize,
                              cfg.tile_w // cfg.scan_resize)
        seg = self._segment(x)
        if seg.shape[2] != cfg.tile_h:
            seg = resize_linear(seg, cfg.tile_h, cfg.tile_w)
        return seg.permute(0, 2, 3, 1)

    def _streamed_batch(self, canvas: torch.Tensor, tiles_u8: torch.Tensor,
                        ys, xs, valid) -> torch.Tensor:
        """Forward one tile batch (seg: logits; cls: the classifier's,
        painted over each tile's window) and add it into the canvas, in
        tile order. Padding tiles (``valid`` 0, always at the end) are not
        added: JAX adds them times 0, which leaves every sum unchanged."""
        cfg = self.cfg
        k = int(np.sum(valid))
        if self.mode == "cls":
            logits = self._classify(tiles_u8)
            return scatter_add_scalar_tiles(canvas, logits[:k], ys[:k],
                                            xs[:k], cfg.tile_h, cfg.tile_w)
        seg = self._seg_forward_tiles(tiles_u8)
        return scatter_add_tiles(canvas, seg[:k], ys[:k], xs[:k])

    def _full_pass(self, level_img: torch.Tensor, canvas: torch.Tensor,
                   ys_all, xs_all, valid_all, y0: int = 0) -> torch.Tensor:
        """The whole grid, batch after batch (JAX ``_seg_full_pass`` and
        ``_cls_full_pass``, each batch its ``_seg_tile_batch``): tiles
        gathered from the device-resident level image, forwarded, added
        into the canvas, whose row 0 is the image's row ``y0``."""
        cfg = self.cfg
        for ys, xs, valid in zip(ys_all, xs_all, valid_all):
            tiles = gather_tiles(level_img, ys, xs, cfg.tile_h, cfg.tile_w)
            self._streamed_batch(canvas, tiles, ys - y0, xs, valid)
        return canvas

    def _refuse_chunks(self, route: str) -> None:
        """Raise ``ValueError`` where ``route`` would cut a slide into
        chunks or stripes for a model whose every output depends on the
        whole image (MiT's global attention; Swin's windows and edge
        padding over the whole padded image): no halo makes such a chunk
        exact."""
        if not self.fast.chunk_exact:
            raise ValueError(
                f"{route} cuts the slide into halo-padded chunks, which no "
                f"halo makes exact for {self.model.arch}, whose every output "
                f"depends on the whole padded image; "
                f"{self.model.arch} takes the fused whole-image route only "
                f"(seg mode, scan_resize 1, within fcn_fast_max_px)")

    def _fcn_full_pass(self, img_pad: torch.Tensor, chunk_h: int,
                       chunk_w: int, halo: int, ny: int,
                       nx: int) -> torch.Tensor:
        """Halo-padded (chunk_h × chunk_w) chunks of the 255-framed image
        through the tile forward, their centres written into an
        (ny·chunk_h, nx·chunk_w, nc) f32 canvas: each output pixel
        computed once."""
        self._refuse_chunks("the chunked FCN")
        out = torch.zeros((ny * chunk_h, nx * chunk_w, self.cfg.num_classes),
                          dtype=torch.float32, device=self.device)
        for i in range(ny * nx):
            cy, cx = (i // nx) * chunk_h, (i % nx) * chunk_w
            window = img_pad[cy:cy + chunk_h + 2 * halo,
                             cx:cx + chunk_w + 2 * halo]
            seg = self._segment(self._normalize(window[None])
                                .permute(0, 3, 1, 2))[0]
            out[cy:cy + chunk_h, cx:cx + chunk_w] = \
                seg[:, halo:halo + chunk_h, halo:halo + chunk_w] \
                .permute(1, 2, 0)
        return out

    # ---- postprocess ----

    def _postprocess(self, canvas: torch.Tensor, mask_u8: torch.Tensor,
                     out_hw: Optional[Tuple[int, int]] = None):
        """(H, W, nc) logit canvas → (labels u8, probs (H, W, nc), heat u8)
        on the device. A canvas stitched at a scan level other than 2 is
        first resized to level 2 (``out_hw``), per class, as
        ``jax.image.resize(..., "linear")`` (reference utils/eval.py:67-71).
        Heat: P(1) in cls mode, else P(2) + P(3), tissue-masked."""
        if out_hw is not None and tuple(canvas.shape[:2]) != tuple(out_hw):
            canvas = resize_linear(canvas.permute(2, 0, 1)[None],
                                   *out_hw)[0].permute(1, 2, 0)
        labels, probs_p = threshold_probs_planar(canvas,
                                                 self.cfg.class_probs)
        heat = probs_p[1] if self.mode == "cls" else probs_p[2] + probs_p[3]
        return labels, probs_p.permute(1, 2, 0), heat_u8(heat, mask_u8)

    def _finish(self, plan: SlidePlan, canvas: torch.Tensor, t0: float,
                keep_canvas: bool, keep_probs: bool) -> SlideResult:
        h2, w2 = plan.canvas_hw
        labels, probs, heat = self._postprocess(
            canvas, self._level_mask(plan, (h2, w2)), out_hw=(h2, w2))
        res, = self._results([plan], [labels.cpu().numpy()],
                             [heat.cpu().numpy()], time.time() - t0)
        if keep_probs:
            res.probs = probs.cpu().numpy()
        if keep_canvas:
            res.canvas = canvas.cpu().numpy()
        return res

    def _postprocess_s2d(self, y_s: torch.Tensor, mask2_u8: torch.Tensor):
        """(N, f²·nc, H/f, W/f) logits (channel pos·nc + c) and (N, H/f,
        W/f) u8 tissue masks → (labels_p, heat_p), each (N, f², H/f, W/f)
        u8 per-position planes: softmax in f32, class floors, argmax, and
        heat = P(2) + P(3) masked, quantized to u8."""
        nc = self.cfg.num_classes
        n, c, hf, wf = y_s.shape
        labels_p, pr = gate(y_s.float().reshape(n, c // nc, nc, hf, wf),
                            self.cfg.class_probs, 2)
        return labels_p, heat_u8(pr[:, :, 2] + pr[:, :, 3], mask2_u8[:, None])

    def _postprocess_full(self, y: torch.Tensor, masks: torch.Tensor):
        """The fused forward's head planes → (labels, heat), each (N, Hp,
        Wp) u8 on the device: :meth:`_postprocess_s2d`, then a
        depth-to-space of each at f = :meth:`_head_f`, ``out[f·y + a,
        f·x + b] = planes[a·f + b, y, x]``."""
        f = self._head_f()
        return tuple(depth_to_space(p, f)[:, 0]
                     for p in self._postprocess_s2d(y, masks))

    @staticmethod
    def _host_crops(plans: Sequence[SlidePlan],
                    x: torch.Tensor) -> List[torch.Tensor]:
        """Slide k's ``x[k]`` cropped to its ``stitch_hw`` on the device and
        copied into a host tensor of its own: C-contiguous, and no view of
        the group's batch or of another slide. On a card the tensor is
        pinned and the copy enqueued on the current stream without
        blocking the host: read it after that stream has passed it."""
        pin = x.is_cuda
        out = []
        for k, p in enumerate(plans):
            crop = x[k, :p.stitch_hw[0], :p.stitch_hw[1]]
            out.append(torch.empty(crop.shape, dtype=crop.dtype,
                                   pin_memory=pin).copy_(crop,
                                                         non_blocking=pin))
        return out

    # ---- fused whole-image route ----

    def _head_f(self) -> int:
        """s2d factor of the head planes: 2 on the fold route (JAX
        ``engine.py:482``), else ``S2D_HEAD_F``."""
        return 2 if self.fcn_fold else S2D_HEAD_F

    def _forward(self, imgs: torch.Tensor,
                 planar_head: bool = True) -> torch.Tensor:
        """The fused forward of (N, Hp, Wp, 3) u8 images: head planes, or
        with ``planar_head=False`` (N, nc, Hp, Wp) f32 logits."""
        if self.fcn_fold:
            check_fold(self.model)
            if self.fast.fold is None:
                self.fast.fold = prepare_fold(self.model, self.dtype)
        return segment_from_image(self.fast, imgs, planar_head=planar_head,
                                  fold=self.fcn_fold)

    def _run_fused(self, imgs: torch.Tensor, masks: torch.Tensor):
        """(N, Hp, Wp, 3) u8 + (N, Hp/f, Wp/f) u8 masks on the device →
        (labels, heat), each (N, Hp, Wp) u8 on the device, in ranges
        ``engine.forward`` and ``engine.postprocess``
        (:meth:`_postprocess_full`)."""
        with record_function("engine.forward"):
            y = self._forward(imgs)
        with record_function("engine.postprocess"):
            return self._postprocess_full(y, masks)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _inputs(self, plans: Sequence[SlidePlan], imgs=None):
        """Staged padded images and head-resolution masks of a group of
        planar slides with one padded geometry. On a card the masks go up
        from pinned memory without blocking the host."""
        dims = {self._fcn_fast_dims(*p.stitch_hw) for p in plans}
        if len(dims) != 1:
            raise ValueError(f"slides of one group must share padded "
                             f"dims, got {sorted(dims)}")
        (hp, wp), = dims
        f = self._head_f()
        masks = torch.from_numpy(np.stack(
            [self._half_mask(p, (hp // f, wp // f)) for p in plans]))
        if self.device.type == "cuda":
            masks = masks.pin_memory()
        if imgs is None:
            imgs = [self.stage_slide_fcn(p) for p in plans]
        batch = [self._take(s) for s in imgs]
        batch = batch[0][None] if len(batch) == 1 else torch.stack(batch)
        return batch, masks.to(self.device, non_blocking=True)

    def _copy_out(self, plans: Sequence[SlidePlan], labels: torch.Tensor,
                  heat: torch.Tensor, t0: float) -> LaunchedGroup:
        """Range ``engine.d2h``: each slide's cropped labels and heat
        enqueued for the host (:meth:`_host_crops`), then the event that
        marks their end."""
        with record_function("engine.d2h"):
            labels = self._host_crops(plans, labels)
            heat = self._host_crops(plans, heat)
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
        return LaunchedGroup(list(plans), labels, heat, done, t0)

    def _launch(self, plans: Sequence[SlidePlan], imgs=None
                ) -> LaunchedGroup:
        """A group enqueued through the fused route, the host blocked
        nowhere: ``engine.inputs`` (masks, staged images), ``engine.launch``
        (forward, postprocess, depth-to-space), ``engine.d2h`` (each
        slide's copies into pinned host tensors and the event after
        them, ahead of whatever the stream runs next)."""
        t0 = time.perf_counter()
        with record_function("engine.inputs"):
            batch, masks = self._inputs(plans, imgs)
        with record_function("engine.launch"):
            labels, heat = self._run_fused(batch, masks)
        return self._copy_out(plans, labels, heat, t0)

    def _collect(self, group: LaunchedGroup) -> List[SlideResult]:
        """A launched group's results: ``engine.sync`` (the host waits on
        the group's event: its forward and copies done, whatever was
        enqueued after them still running) and ``engine.tail`` (the heat
        to f32)."""
        with record_function("engine.sync"):
            group.wait()
        per = (time.perf_counter() - group.t0) / len(group.plans)
        with record_function("engine.tail"):
            return self._results(group.plans,
                                 [t.numpy() for t in group.labels],
                                 [t.numpy() for t in group.heat], per)

    def _serve(self, plans: List[SlidePlan], imgs=None) -> List[SlideResult]:
        """A group through the fused route, synchronously, in range
        ``engine.serve``: :meth:`_launch` (``engine.inputs``,
        ``engine.launch``, ``engine.d2h``), then :meth:`_collect`
        (``engine.sync``, ``engine.tail``). Nothing is left pending."""
        with record_function("engine.serve"):
            return self._collect(self._launch(plans, imgs))

    def drop_ahead(self) -> None:
        """Wait for a group that ``predict_slides_fcn`` launched ahead and
        drop it unread: afterwards nothing is pending."""
        group, self._ahead = self._ahead, None
        if group is not None:
            group.wait()

    def _results(self, plans: Sequence[SlidePlan],
                 labels: Sequence[np.ndarray], heat: Sequence[np.ndarray],
                 per: float) -> List[SlideResult]:
        """Each slide's result from its host labels and u8 heat (slide k
        at index k), ``per`` seconds each: the heat to f32 in [0, 1] in one
        pass. Every route builds its results here."""
        return [SlideResult(p.name, lab,
                            np.divide(ht, np.float32(255), dtype=np.float32),
                            len(p.grid), per)
                for p, lab, ht in zip(plans, labels, heat)]

    def _predict_fcn_fast(self, plan: SlidePlan, keep_canvas: bool,
                          keep_probs: bool, img=None) -> SlideResult:
        """The fused route for one slide (JAX ``_predict_fcn_fast``):
        :meth:`_serve`. With ``keep_probs``/``keep_canvas`` a planar slide
        runs the same device work, and the canvas is the head planes
        turned to (H, W, nc) by a depth-to-space on the device, the probs
        the one gate over it. FPN and PSPNet, whose kept heat JAX masks at
        full resolution, and a slide stitched at another scan level than 2
        take the canvas branch, through :meth:`_finish`."""
        imgs = None if img is None else [img]
        keep = keep_probs or keep_canvas
        if self.fcn_group_key(plan) is not None and not (
                keep and self.fast.native):
            if not keep:
                return self._serve([plan], imgs)[0]
            t0 = time.perf_counter()
            batch, masks = self._inputs([plan], imgs)
            y = self._forward(batch)
            res, = self._collect(self._copy_out(
                [plan], *self._postprocess_full(y, masks), t0))
            hs, ws = plan.stitch_hw
            canvas = depth_to_space(y.float(), self._head_f())[0] \
                .permute(1, 2, 0)[:hs, :ws].contiguous()
            if keep_probs:
                res.probs = threshold_probs(canvas, self.cfg.class_probs)[1] \
                    .cpu().numpy()
            if keep_canvas:
                res.canvas = canvas.cpu().numpy()
            return res
        t0 = time.time()
        hs, ws = plan.stitch_hw
        x = self._take(img if img is not None
                       else self.stage_slide_fcn(plan))[None]
        canvas = self._forward(x, planar_head=False)[0] \
            .permute(1, 2, 0)[:hs, :ws]
        return self._finish(plan, canvas, t0, keep_canvas, keep_probs)

    # ---- public API ----

    @torch.no_grad()
    def predict_slide(self, plan: SlidePlan, keep_canvas: bool = False,
                      keep_probs: bool = False,
                      level_img=None) -> SlideResult:
        """Grid-parity dense inference over one slide (cls mode: the
        classifier painted over each tile). ``level_img`` takes the
        staged level image from :meth:`stage_slide`."""
        t0 = time.time()
        img = self._take(level_img if level_img is not None
                         else self.stage_slide(plan))
        hs, ws = plan.stitch_hw
        canvas = torch.zeros((hs, ws, self.cfg.num_classes),
                             dtype=torch.float32, device=self.device)
        xs_p, ys_p, valid = self._pad_grid(plan.grid.xs, plan.grid.ys,
                                           self.batch)
        self._full_pass(img, canvas, ys_p, xs_p, valid)
        return self._finish(plan, canvas, t0, keep_canvas, keep_probs)

    def _host_batches(self, plan: SlidePlan, xs_p, ys_p, valid,
                      nthreads: int, y0: int = 0):
        """Host tile batches of the streamed routes: the slide's
        multi-threaded ``read_tiles`` when it has one, else per-tile
        ``read_region``; each batch's origins (``ys`` relative to canvas
        row ``y0``) stay host lists, which the adds slice with."""
        cfg = self.cfg
        slide = plan.slide
        ds_lvl = slide.level_downsamples[cfg.scan_level]
        reader = getattr(slide, "read_tiles", None)
        for bx, by, bv in zip(xs_p, ys_p, valid):
            if reader is not None:
                tiles = reader(bx, by, cfg.scan_level, cfg.tile_w,
                               cfg.tile_h, nthreads=nthreads)
            else:
                tiles = np.stack([
                    slide.read_region(
                        (int(x * ds_lvl), int(y * ds_lvl)),
                        cfg.scan_level, (cfg.tile_w, cfg.tile_h))
                    for x, y in zip(bx, by)])
            yield {"tiles": np.asarray(tiles), "ys": (by - y0).tolist(),
                   "xs": bx.tolist(), "valid": bv.tolist()}

    @torch.no_grad()
    def predict_slide_streamed(self, plan: SlidePlan, nthreads: int = 8,
                               keep_canvas: bool = False,
                               keep_probs: bool = False) -> SlideResult:
        """Streamed dense inference: tile batches decoded on the host
        (the slide's multi-threaded ``read_tiles`` when it has one, else
        per-tile ``read_region``) and prefetched to the device through
        pinned memory while the previous batch computes. For level-0/1
        scans whose level image should not sit on the device. Stitching
        semantics match :meth:`predict_slide` exactly."""
        cfg = self.cfg
        t0 = time.time()
        hs, ws = plan.stitch_hw
        canvas = torch.zeros((hs, ws, cfg.num_classes), dtype=torch.float32,
                             device=self.device)
        xs_p, ys_p, valid = self._pad_grid(plan.grid.xs, plan.grid.ys,
                                           self.batch)
        for b in prefetch_to_device(
                self._host_batches(plan, xs_p, ys_p, valid, nthreads),
                depth=cfg.prefetch_depth, device=self.device):
            self._streamed_batch(canvas, b["tiles"], b["ys"], b["xs"],
                                 b["valid"])
        return self._finish(plan, canvas, t0, keep_canvas, keep_probs)

    @torch.no_grad()
    def predict_slide_fcn(self, plan: SlidePlan, chunk=None, halo: int = 128,
                          keep_canvas: bool = False,
                          keep_probs: bool = False,
                          img: Optional[StagedImage] = None) -> SlideResult:
        """ScanNet-style FCN mode: each output pixel computed once.
        ``chunk=None`` runs the fused whole-image route where it serves
        (seg mode, no ``scan_resize``, within ``fcn_fast_max_px``); an int or
        tuple ``chunk`` (and cls mode, ``scan_resize`` ≠ 1) runs
        halo-padded chunks through the tile forward. A slide over
        ``fcn_fast_max_px`` with nothing staged takes the banded route;
        staged, it takes 4096-px chunks. ``img`` takes a staged padded
        image from :meth:`stage_slide_fcn`."""
        fits = self._fcn_fast_fits(plan)
        if chunk is None and self._fcn_fast_ok() and fits:
            return self._predict_fcn_fast(plan, keep_canvas, keep_probs,
                                          img=img)
        t0 = time.time()
        if (chunk is None and img is None and not fits
                and tuple(plan.stitch_hw) == tuple(plan.canvas_hw)):
            return self.predict_slide_fcn_banded(
                plan, halo=halo, keep_canvas=keep_canvas,
                keep_probs=keep_probs)
        img = self._take(img if img is not None
                         else self._stage(self._read_level(plan)))
        h, w = img.shape[:2]
        hs, ws = plan.stitch_hw
        if chunk is None and not fits:
            chunk = 4096                    # bench-scale chunks, ~12% halo
        ch, cw, ny, nx = self._fcn_geometry(h, w, chunk, halo)
        canvas = self._fcn_full_pass(self._pad_255(img, halo, ny * ch,
                                                   nx * cw),
                                     ch, cw, halo, ny, nx)[:hs, :ws]
        return self._finish(plan, canvas, t0, keep_canvas, keep_probs)

    @torch.no_grad()
    def predict_slide_fcn_banded(self, plan: SlidePlan, chunk=None,
                                 halo: int = 128, keep_canvas: bool = False,
                                 keep_probs: bool = False) -> SlideResult:
        """Chunked FCN with banded host staging: the scan-level image is
        never whole on the host. Each horizontal band of chunks is read
        (clipped ``read_region`` + 255 frame, the bytes of
        :meth:`predict_slide_fcn`'s padded image), run through
        :meth:`_fcn_full_pass` and postprocessed on the device; only the
        u8 labels and heat (and the f32 canvas or probs, when asked) are
        kept at full resolution. Labels and heat equal
        ``predict_slide_fcn(chunk=chunk, halo=halo)`` exactly. Scan level
        2 only (stitch dims == canvas dims)."""
        self._refuse_chunks("the banded FCN")
        cfg = self.cfg
        t0 = time.time()
        hs, ws = plan.stitch_hw
        if (hs, ws) != tuple(plan.canvas_hw):
            raise ValueError(
                "banded FCN requires stitch==canvas dims (scan_level==2 "
                "semantics); use predict_slide_streamed for level-0/1 "
                "oversize scans")
        if chunk is None:
            chunk = (min(4096, hs + (-hs) % 32), min(4096, ws + (-ws) % 32))
        ch, cw, ny, nx = self._fcn_geometry(hs, ws, chunk, halo)
        ds = plan.slide.level_downsamples[cfg.scan_level]
        mask_full = resize_mask_to(plan.mask, (hs, ws))
        labels = np.empty((hs, ws), np.uint8)
        heat = np.empty((hs, ws), np.uint8)
        canvas_h = (np.empty((hs, ws, cfg.num_classes), np.float32)
                    if keep_canvas else None)
        probs_h = (np.empty((hs, ws, cfg.num_classes), np.float32)
                   if keep_probs else None)
        wb = nx * cw + 2 * halo
        for iy in range(ny):
            y0 = iy * ch - halo            # band top in image rows
            band = np.full((ch + 2 * halo, wb, 3), 255, np.uint8)
            ry0, ry1 = max(0, y0), min(hs, y0 + ch + 2 * halo)
            if ry1 > ry0:
                rect = np.asarray(plan.slide.read_region(
                    (0, int(round(ry0 * ds))), cfg.scan_level,
                    (ws, ry1 - ry0)))
                band[ry0 - y0:ry1 - y0, halo:halo + ws] = rect
            rows = min(ch, hs - iy * ch)
            bc = self._fcn_full_pass(self._take(self._stage(band)), ch, cw,
                                     halo, 1, nx)[:rows, :ws]
            mrow = torch.from_numpy(
                mask_full[iy * ch:iy * ch + rows]).to(self.device)
            lb, pb, hb = self._postprocess(bc, mrow)
            sl = slice(iy * ch, iy * ch + rows)
            labels[sl] = lb.cpu().numpy()
            heat[sl] = hb.cpu().numpy()
            if keep_canvas:
                canvas_h[sl] = bc.cpu().numpy()
            if keep_probs:
                probs_h[sl] = pb.cpu().numpy()
        res, = self._results([plan], [labels], [heat], time.time() - t0)
        res.probs, res.canvas = probs_h, canvas_h
        return res

    def _one_forward(self, plans: Sequence[SlidePlan]) -> bool:
        """Two or more slides with one :meth:`fcn_group_key`: the group
        shares one batched forward."""
        keys = {self.fcn_group_key(p) for p in plans}
        return len(plans) > 1 and None not in keys and len(keys) == 1

    @torch.no_grad()
    def predict_slides_fcn(self, plans, imgs=None,
                           ahead=None) -> List[SlideResult]:
        """Serve a GROUP of same-geometry slides as one batched forward
        (slides as the batch dimension). A group whose slides do not share
        one :meth:`fcn_group_key` (one slide, mixed dims, cls mode, another
        scan level, oversize) falls back to :meth:`predict_slide_fcn` per
        slide. ``imgs`` optionally supplies staged images, index-aligned
        with ``plans``.

        ``ahead`` = (next plans, their staged images) runs the route one
        group deep, in range ``engine.serve``: the group is launched
        (:meth:`_launch`) unless an earlier call launched it as its
        ``ahead``; then the next group is launched behind it (range
        ``engine.ahead``; only a group that shares one forward); then the
        host waits for this group alone and turns its heat to f32
        (:meth:`_collect`) while the card runs the next. Between the
        calls the next group is pending on the engine. A pending group
        whose plans are not this call's (by identity) is waited for and
        dropped first (:meth:`drop_ahead`). Without ``ahead`` the call
        returns with nothing pending."""
        global AHEAD
        plans = list(plans)
        if self._ahead is not None and not _same_plans(self._ahead.plans,
                                                       plans):
            self.drop_ahead()
        mine, self._ahead = self._ahead, None
        if not self._one_forward(plans):
            return [self.predict_slide_fcn(
                p, img=None if imgs is None else imgs[k])
                for k, p in enumerate(plans)]
        with record_function("engine.serve"):
            if mine is None:
                mine = self._launch(plans, imgs)
            if ahead is not None and self._one_forward(ahead[0]):
                with record_function("engine.ahead"):
                    self._ahead = self._launch(*ahead)
                AHEAD += 1
            return self._collect(mine)

    # ---- sharded routes (every rank calls, every rank returns) ----

    def _stripes(self, plan: SlidePlan, n_dev: int, r: int):
        """Tiles routed to ``n_dev`` row stripes by y-origin (JAX
        ``engine.py:1264-1280``): (stripe rows, halo chunks a tile can
        spill into, this rank's (n_batches, bs) xs, ys and valid, padded
        to the fullest stripe's batch count)."""
        hs, _ = plan.stitch_hw
        bs = self.batch
        stripe = -(-hs // n_dev)
        n_halo = -(-(self.cfg.tile_h - 1) // stripe)
        xs, ys = plan.grid.xs, plan.grid.ys
        owner = np.minimum(ys // stripe, n_dev - 1)
        per = [np.flatnonzero(owner == d) for d in range(n_dev)]
        n_batches = max(1, -(-max(len(p) for p in per) // bs))
        cap = n_batches * bs
        mine = per[r]
        xs_s = np.zeros(cap, np.int32)
        ys_s = np.zeros(cap, np.int32)
        val_s = np.zeros(cap, np.float32)
        xs_s[:len(mine)] = xs[mine]
        ys_s[:len(mine)] = ys[mine]
        val_s[:len(mine)] = 1.0
        return (stripe, n_halo, xs_s.reshape(-1, bs), ys_s.reshape(-1, bs),
                val_s.reshape(-1, bs))

    def _merge_stripes(self, local: torch.Tensor, stripe: int, n_halo: int,
                       hs: int, group) -> torch.Tensor:
        """Halo exchange (chunk k of a rank's overhang belongs to the rank
        k below, JAX ``ppermute`` with (i, i + k)), then every stripe
        gathered: the (hs, W, C) canvas on every rank."""
        main = local[:stripe]
        for k in range(1, 1 + n_halo):
            main = main + comm.shift(
                local[stripe * k:stripe * (k + 1)].contiguous(), k, group)
        n_dev = comm.world(group)
        return comm.gather_slots(main, group).reshape(
            n_dev * stripe, *main.shape[1:])[:hs]

    @torch.no_grad()
    def predict_slide_sharded(self, plan: SlidePlan, mesh,
                              axis: str = "data", keep_canvas: bool = False,
                              keep_probs: bool = False,
                              level_img=None) -> SlideResult:
        """One slide's tile stream split over the mesh (JAX
        ``engine.py:1133-1223``): the grid padded to (n_dev, n_batches,
        bs) as JAX pads it, rank r adding block r into a full local canvas,
        one all-reduce merging the canvases (JAX's ``psum``), and every
        rank finishing the slide. Every rank reads the level image
        (``level_img``: a staged one from :meth:`stage_slide`)."""
        cfg = self.cfg
        t0 = time.time()
        n_dev, r = mesh_size(mesh, axis), mesh_rank(mesh, axis)
        bs = self.batch
        img = self._take(level_img if level_img is not None
                         else self.stage_slide(plan))
        hs, ws = plan.stitch_hw
        xs, ys = plan.grid.xs, plan.grid.ys
        n = len(xs)
        pad = (-n) % (n_dev * bs)
        shape3 = (n_dev, -1, bs)
        xs_p = np.concatenate([xs, np.zeros(pad, np.int32)]).reshape(shape3)
        ys_p = np.concatenate([ys, np.zeros(pad, np.int32)]).reshape(shape3)
        valid = np.concatenate([np.ones(n, np.float32),
                                np.zeros(pad, np.float32)]).reshape(shape3)
        canvas = torch.zeros((hs, ws, cfg.num_classes), dtype=torch.float32,
                             device=self.device)
        self._full_pass(img, canvas, ys_p[r], xs_p[r], valid[r])
        canvas = comm.global_sum(canvas, mesh_group(mesh, axis))
        return self._finish(plan, canvas, t0, keep_canvas, keep_probs)

    @torch.no_grad()
    def predict_slide_sharded_rows(self, plan: SlidePlan, mesh,
                                   axis: str = "data",
                                   keep_canvas: bool = False,
                                   keep_probs: bool = False,
                                   level_img=None) -> SlideResult:
        """One slide with a row-sharded canvas (JAX
        ``engine.py:1225-1349``): rank r owns rows [r·stripe,
        (r+1)·stripe) and keeps ``stripe·(1+n_halo)`` rows, its tiles
        added at their origins less r·stripe; the overhang moves down by
        :func:`~wsiseg_tpu_torch.parallel.comm.shift`, and the stripes are
        gathered before :meth:`_finish`."""
        cfg = self.cfg
        t0 = time.time()
        n_dev, r = mesh_size(mesh, axis), mesh_rank(mesh, axis)
        group = mesh_group(mesh, axis)
        img = self._take(level_img if level_img is not None
                         else self.stage_slide(plan))
        hs, ws = plan.stitch_hw
        stripe, n_halo, xs_s, ys_s, val_s = self._stripes(plan, n_dev, r)
        local = torch.zeros((stripe * (1 + n_halo), ws, cfg.num_classes),
                            dtype=torch.float32, device=self.device)
        self._full_pass(img, local, ys_s, xs_s, val_s, y0=r * stripe)
        canvas = self._merge_stripes(local, stripe, n_halo, hs, group)
        return self._finish(plan, canvas, t0, keep_canvas, keep_probs)

    @torch.no_grad()
    def predict_slide_streamed_sharded(self, plan: SlidePlan, mesh,
                                       axis: str = "data",
                                       nthreads: int = 8,
                                       keep_canvas: bool = False,
                                       keep_probs: bool = False
                                       ) -> SlideResult:
        """Streamed tiles and a row-sharded canvas (JAX
        ``engine.py:695-853``): each rank decodes on the host only the tile
        batches of its own stripe (:meth:`_host_batches`), prefetches them
        and adds them into its stripe-plus-overhang canvas; one halo merge
        at the end. Stitching equals :meth:`predict_slide`'s."""
        cfg = self.cfg
        t0 = time.time()
        n_dev, r = mesh_size(mesh, axis), mesh_rank(mesh, axis)
        hs, ws = plan.stitch_hw
        stripe, n_halo, xs_s, ys_s, val_s = self._stripes(plan, n_dev, r)
        local = torch.zeros((stripe * (1 + n_halo), ws, cfg.num_classes),
                            dtype=torch.float32, device=self.device)
        for b in prefetch_to_device(
                self._host_batches(plan, xs_s, ys_s, val_s, nthreads,
                                   y0=r * stripe),
                depth=cfg.prefetch_depth, device=self.device):
            self._streamed_batch(local, b["tiles"], b["ys"], b["xs"],
                                 b["valid"])
        canvas = self._merge_stripes(local, stripe, n_halo, hs,
                                     mesh_group(mesh, axis))
        return self._finish(plan, canvas, t0, keep_canvas, keep_probs)

    @torch.no_grad()
    def predict_slides_fcn_sharded(self, plans, mesh, axis: str = "data",
                                   imgs=None) -> List[SlideResult]:
        """Slide-parallel serving (JAX ``engine.py:1042-1131``): rank r
        serves slides [r·per, (r+1)·per) through the fused route (one
        batched forward and each slide's copies, as :meth:`_serve`), and
        the finished results are gathered to every rank
        (:func:`~wsiseg_tpu_torch.parallel.comm.gather_objects`). Needs
        k·n_dev slides of one :meth:`fcn_group_key`. ``imgs`` optionally
        supplies padded host images (numpy) or staged images,
        index-aligned with ``plans``."""
        plans = list(plans)
        n_dev, r = mesh_size(mesh, axis), mesh_rank(mesh, axis)
        keys = {self.fcn_group_key(p) for p in plans}
        if not plans or len(plans) % n_dev or None in keys or len(keys) != 1:
            raise ValueError(
                "slide-parallel serving needs k*n_dev slides of identical "
                "padded geometry on the planar fast path; use "
                "predict_slides_fcn / predict_slide_fcn otherwise")
        per = len(plans) // n_dev
        mine = range(r * per, (r + 1) * per)
        staged = None
        if imgs is not None:
            staged = [self._stage(imgs[k]) if isinstance(imgs[k], np.ndarray)
                      else imgs[k] for k in mine]
        own = [plans[k] for k in mine]
        res = self._collect(self._launch(own, staged))
        every = comm.gather_objects(res, mesh_group(mesh, axis))
        return [x for part in every for x in part]

    def stage_slide_fcn_rows(self, plan: SlidePlan, mesh, axis: str = "data",
                             halo: int = 128):
        """This rank's input stripe for :meth:`predict_slide_fcn_sharded_rows`
        (JAX ``engine.py:1391-1411``, where the host builds every stripe):
        rows [r·ch − halo, (r+1)·ch + halo) of the level image read from
        the slide and framed in 255 as JAX pads the whole image, then
        uploaded. Returns (staged stripe, ch, cw)."""
        cfg = self.cfg
        n_dev, r = mesh_size(mesh, axis), mesh_rank(mesh, axis)
        w, h = plan.slide.level_dimensions[cfg.scan_level]
        ch, cw = fcn_stripe_geometry(h, w, n_dev)
        y0 = r * ch - halo                  # the stripe's top image row
        band = np.full((ch + 2 * halo, cw + 2 * halo, 3), 255, np.uint8)
        ry0, ry1 = max(0, y0), min(h, y0 + ch + 2 * halo)
        if ry1 > ry0:
            ds = plan.slide.level_downsamples[cfg.scan_level]
            band[ry0 - y0:ry1 - y0, halo:halo + w] = np.asarray(
                plan.slide.read_region((0, int(round(ry0 * ds))),
                                       cfg.scan_level, (w, ry1 - ry0)))
        return self._stage(band), ch, cw

    @torch.no_grad()
    def predict_slide_fcn_sharded_rows(self, plan: SlidePlan, mesh,
                                       axis: str = "data", halo: int = 128,
                                       keep_canvas: bool = False,
                                       keep_probs: bool = False,
                                       staged=None) -> SlideResult:
        """Row-striped FCN (JAX ``engine.py:1355-1389``): each rank runs
        the chunked FCN's tile forward (:meth:`_fcn_full_pass`'s) on its
        halo stripe and crops ``[halo:halo+ch, halo:halo+cw]``; the
        stripes are gathered and every rank finishes the slide. Equals
        ``predict_slide_fcn(chunk=fcn_stripe_geometry(h, w, n_dev))``.
        ``staged`` takes :meth:`stage_slide_fcn_rows`'s result."""
        self._refuse_chunks("the sharded-rows FCN")
        t0 = time.time()
        if staged is None:
            staged = self.stage_slide_fcn_rows(plan, mesh, axis, halo)
        stripe, ch, cw = staged
        x = self._take(stripe)
        seg = self._segment(self._normalize(x[None]).permute(0, 3, 1, 2))[0]
        out = seg[:, halo:halo + ch, halo:halo + cw].permute(1, 2, 0) \
            .float().contiguous()
        every = comm.gather_slots(out, mesh_group(mesh, axis))
        hs, ws = plan.stitch_hw
        canvas = every.reshape(-1, cw, out.shape[-1])[:hs, :ws]
        return self._finish(plan, canvas, t0, keep_canvas, keep_probs)

    @torch.no_grad()
    def device_throughput(self, plan: SlidePlan, mode: str = "fcn",
                          iters: int = 3, chunk=None, halo: int = 128,
                          slides_in_flight: int = 1) -> Dict[str, float]:
        """Steady-state throughput with the slide resident on the device,
        reported PER SLIDE in grid-equivalent patches (len(plan.grid)):
        ``{"patches_per_sec", "sec_per_slide"}``.

        - ``mode="fcn"`` (``chunk=None``, fused route): forward,
          postprocess and depth-to-space, ``slides_in_flight`` slides per
          batch (a slide with no :meth:`fcn_group_key`: the canvas branch
          and :meth:`_postprocess`).
        - ``mode="fcn"`` with a ``chunk`` (or off the fused route):
          :meth:`_fcn_full_pass` + :meth:`_postprocess`.
        - ``mode="grid"``: :meth:`_full_pass` (seg or cls) +
          :meth:`_postprocess`.

        ``slides_in_flight > 1`` is refused off the fused planar route.
        The default mode is ``"fcn"`` (JAX: ``"grid"``, and ``"fcn_raw"``,
        which adds the TPU stem's packing: the port's stem reads the u8
        image as it is)."""
        if mode not in ("fcn", "grid"):
            raise ValueError(f"mode must be 'fcn' or 'grid', got {mode!r}")
        cfg = self.cfg
        n = len(plan.grid)
        h2, w2 = plan.canvas_hw
        hs, ws = plan.stitch_hw
        mask = self._level_mask(plan, (h2, w2))
        n_per_iter = 1

        if mode == "fcn" and chunk is None and self._fcn_fast_ok():
            if self.fcn_group_key(plan) is not None:
                n_per_iter = max(1, int(slides_in_flight))
                imgs, masks = self._inputs([plan])
                imgs = imgs.expand(n_per_iter, -1, -1, -1).contiguous()
                masks = masks.expand(n_per_iter, -1, -1).contiguous()

                def run():
                    return self._run_fused(imgs, masks)
            else:
                img = self._take(self._stage(
                    self._read_padded_level(plan)))[None]

                def run():
                    cv = self._forward(img, planar_head=False)[0] \
                        .permute(1, 2, 0)[:hs, :ws]
                    return self._postprocess(cv, mask, out_hw=(h2, w2))
        elif mode == "fcn":
            img = self._take(self.stage_slide(plan))
            h, w = img.shape[:2]
            ch, cw, ny, nx = self._fcn_geometry(h, w, chunk, halo)
            img_pad = self._pad_255(img, halo, ny * ch, nx * cw)

            def run():
                cv = self._fcn_full_pass(img_pad, ch, cw, halo, ny,
                                         nx)[:hs, :ws]
                return self._postprocess(cv, mask, out_hw=(h2, w2))
        else:
            level_img = self._take(self.stage_slide(plan))
            xs_p, ys_p, valid = self._pad_grid(plan.grid.xs, plan.grid.ys,
                                               self.batch)

            def run():
                canvas = torch.zeros((hs, ws, cfg.num_classes),
                                     dtype=torch.float32, device=self.device)
                self._full_pass(level_img, canvas, ys_p, xs_p, valid)
                return self._postprocess(canvas, mask, out_hw=(h2, w2))

        if slides_in_flight > 1 and n_per_iter == 1:
            raise ValueError(
                "slides_in_flight > 1 requires the fused planar fcn route "
                "(fcn_group_key(plan) is not None); refusing to "
                "report a single-slide number as the multi-slide "
                "configuration")
        run()                                    # warm-up
        self._sync()
        t0 = time.time()
        for _ in range(iters):
            run()
        self._sync()
        dt = (time.time() - t0) / (iters * n_per_iter)
        return {"patches_per_sec": n / dt if dt > 0 else 0.0,
                "sec_per_slide": dt}


@torch.no_grad()
def extract_tumor_bed(labels: np.ndarray, open_size: int = 20,
                      dilate_size: int = 20, device="cuda"):
    """Tumor bed from class labels (JAX ``extract_tumor_bed``, reference
    utils/eval.py:89-96): classes ≥ 2, a 20×20 opening on ``device``, the
    filled convex hull on the host, then its perimeter dilated by 20×20
    on ``device``.

    Returns (tb_filled (H, W) uint8, tb_perimeter (H, W) uint8), numpy."""
    device = resolve_device(device)
    tb = torch.from_numpy(np.ascontiguousarray(labels)).to(device) >= 2
    tb = opening(tb.to(torch.uint8), open_size)
    tb_filled = convex_hull_image(tb.cpu().numpy())
    perim = dilate(bwperim(torch.tensor(tb_filled, device=device)),
                   dilate_size)
    return tb_filled, perim.cpu().numpy()
