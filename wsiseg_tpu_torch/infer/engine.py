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
  same planes, :meth:`~DenseInferenceEngine._postprocess_native_planes`),
  the planar postprocess runs on the device, labels are packed 2 bits
  each, and the host interleaves the u8 planes. ``engine.fcn_fold = True``
  (opt-in, as in JAX) takes the fold route instead, for Unet on
  BasicBlock encoders only: the native stem kernel, the encoder and
  ``decode_fold`` on the conv kernels, whose head emits s2d(2) planes.
  An int or tuple ``chunk``, and any route the fused one does not serve
  (cls mode, ``scan_resize`` ≠ 1), run halo-padded chunks through the
  tile forward (``_fcn_full_pass``); a slide over ``fcn_fast_max_px``
  with nothing staged is read and run one band of chunks at a time
  (``predict_slide_fcn_banded``). Scan levels other than 2 resize the
  logit canvas to level 2 before the postprocess (``_postprocess``).

``keep_probs``/``keep_canvas`` return the probabilities and the logit
canvas in JAX's ``(H, W, C)`` layout. The model's weights for the fused
route are converted once, when the engine is built
(:func:`wsiseg_tpu_torch.models.infer_fast.prepare_fast`); the fold
route's and the tile forward's at their first use. Sharded (mesh) routes
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.data.pipeline import prefetch_to_device
from wsiseg_tpu_torch.data.wsi_tiles import SlidePlan
from wsiseg_tpu_torch.models.decoders import resize_linear
from wsiseg_tpu_torch.models.fast_decoder import S2D_HEAD_F, \
    prepare_decode_fast, prepare_fold, space_to_depth, unet_segment_fast
from wsiseg_tpu_torch.models.infer_fast import NATIVE_DECODERS, check_fold, \
    prepare_fast, segment_from_image
from wsiseg_tpu_torch.models.ynet import compute_copy
from wsiseg_tpu_torch.ops.color import normalize
from wsiseg_tpu_torch.ops.hull import convex_hull_image
from wsiseg_tpu_torch.ops.morphology import bwperim, dilate, opening
from wsiseg_tpu_torch.ops.stitch import gather_tiles, \
    scatter_add_scalar_tiles, scatter_add_tiles
from wsiseg_tpu_torch.ops.threshold import threshold_probs_planar

MULTI_GPU_ITEM = "not ported yet: ROADMAP.md, queue 1, 'Multi-GPU'"

#: Peak device bytes per padded pixel of the fused whole-image route, for
#: the widest family one card serves: resnet50 Linknet, 6.7607 GB around
#: ``device_throughput`` at one 3072×4096 slide = 537.3 B/px (resnet18
#: Unet 341.1; NVIDIA H100 80GB HBM3, ``chip_smoke.py``, PERF.md §5).
FCN_PEAK_BYTES_PER_PX = 538
#: Device bytes one slide group of the fused route may take: 64 GB of the
#: card's 80, the rest left for the weights, the allocator's slack and the
#: next group's staged images.
FCN_DEVICE_BUDGET = 64e9
#: Slides per group the cap allows for: the CLI's default
#: ``--slides_in_flight``.
FCN_GROUP_SLIDES = 4
#: Whole-image dispatch cap in padded pixels per slide:
#: 64e9 / (538 B/px · 4 slides) = 29.74 M px, 2.4× the bench slide
#: (4096×3072). Larger slides take the banded route.
FCN_FAST_MAX_PX = int(FCN_DEVICE_BUDGET
                      // (FCN_PEAK_BYTES_PER_PX * FCN_GROUP_SLIDES))


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
        self.fcn_fast_max_px = FCN_FAST_MAX_PX
        self._tile_net = None
        self._h2d_stream = None
        self._h2d_lock = threading.Lock()

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

    @staticmethod
    def _fcn_fast_dims(h: int, w: int) -> Tuple[int, int]:
        """Pad dims for the whole-image path: H a multiple of 32 (even
        dims at every pyramid stage), W a multiple of 256."""
        return h + (-h) % 32, w + (-w) % 256

    def _fcn_fast_ok(self) -> bool:
        """The fused whole-image route serves: seg mode, no
        ``scan_resize``, any family (the CPU takes the kernels' plain
        versions)."""
        return self.mode == "seg" and self.cfg.scan_resize == 1

    def _fcn_fast_fits(self, plan: SlidePlan) -> bool:
        hp, wp = self._fcn_fast_dims(*plan.stitch_hw)
        return hp * wp <= int(self.fcn_fast_max_px)

    def _fcn_planar_ok(self, plan: SlidePlan) -> bool:
        """Planar-s2d head applies when no canvas rescale is needed
        (stitch dims == canvas dims, i.e. scan_level 2)."""
        return (tuple(plan.stitch_hw) == tuple(plan.canvas_hw)
                and self.mode == "seg")

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

    @staticmethod
    def _resize_mask_to(mask: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
        """Nearest resize equal to PIL's ``Image.resize(NEAREST)``: source
        index ``int(s/2 + k·s)`` accumulated in double, s = in/out."""
        if mask.shape == tuple(hw):
            return mask.astype(np.uint8)

        def index(n_in: int, n_out: int) -> np.ndarray:
            s = n_in / n_out
            steps = np.full(n_out, s)
            steps[0] = s * 0.5
            return np.cumsum(steps).astype(np.int64)

        m = mask.astype(np.uint8)
        return m[index(m.shape[0], hw[0])][:, index(m.shape[1], hw[1])]

    def _half_mask(self, plan: SlidePlan, hwf_padded) -> np.ndarray:
        """Tissue mask at s2d cell resolution (1/f of the full output):
        resized over the TRUE stitch extent, zero-padded to the padded
        cell dims."""
        hs, ws = plan.stitch_hw
        hpf, wpf = hwf_padded
        hp, _ = self._fcn_fast_dims(hs, ws)
        f = max(1, round(hp / hpf))
        m = self._resize_mask_to(plan.mask, (-(-hs // f), -(-ws // f)))
        return np.pad(m, ((0, hpf - m.shape[0]), (0, wpf - m.shape[1])))

    def _level_mask(self, plan: SlidePlan, hw) -> torch.Tensor:
        return torch.from_numpy(self._resize_mask_to(plan.mask, hw)) \
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

    def stage_slide_fcn(self, plan: SlidePlan) -> StagedImage:
        """Read + pad + upload a slide's level image for the fused FCN
        route."""
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
                   ys_all, xs_all, valid_all) -> torch.Tensor:
        """The whole grid, batch after batch (JAX ``_seg_full_pass`` and
        ``_cls_full_pass``, each batch its ``_seg_tile_batch``): tiles
        gathered from the device-resident level image, forwarded, added
        into the canvas."""
        cfg = self.cfg
        for ys, xs, valid in zip(ys_all, xs_all, valid_all):
            tiles = gather_tiles(level_img, ys, xs, cfg.tile_h, cfg.tile_w)
            self._streamed_batch(canvas, tiles, ys, xs, valid)
        return canvas

    def _fcn_full_pass(self, img_pad: torch.Tensor, chunk_h: int,
                       chunk_w: int, halo: int, ny: int,
                       nx: int) -> torch.Tensor:
        """Halo-padded (chunk_h × chunk_w) chunks of the 255-framed image
        through the tile forward, their centres written into an
        (ny·chunk_h, nx·chunk_w, nc) f32 canvas: each output pixel
        computed once."""
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
        heat = heat * (mask_u8 > 0)
        heat_u8 = torch.clamp(torch.round(heat * 255.0), 0, 255) \
            .to(torch.uint8)
        return labels, probs_p.permute(1, 2, 0), heat_u8

    def _finish(self, plan: SlidePlan, canvas: torch.Tensor, n_tiles: int,
                t0: float, keep_canvas: bool,
                keep_probs: bool) -> SlideResult:
        h2, w2 = plan.canvas_hw
        labels, probs, heat_u8 = self._postprocess(
            canvas, self._level_mask(plan, (h2, w2)), out_hw=(h2, w2))
        labels = labels.cpu().numpy()
        heat = heat_u8.cpu().numpy().astype(np.float32) / 255.0
        kept_probs = probs.cpu().numpy() if keep_probs else None
        kept_canvas = canvas.cpu().numpy() if keep_canvas else None
        return SlideResult(plan.name, labels, heat, n_tiles,
                           time.time() - t0, probs=kept_probs,
                           canvas=kept_canvas)

    def _postprocess_s2d(self, y_s: torch.Tensor, mask2_u8: torch.Tensor):
        """(N, f²·nc, H/f, W/f) logits (channel pos·nc + c) and (N, H/f,
        W/f) u8 tissue masks → (labels_p, heat_p), each (N, f², H/f, W/f)
        u8 per-position planes: softmax in f32, class floors, argmax, and
        heat = P(2) + P(3) masked, quantized to u8."""
        nc = self.cfg.num_classes
        n, c, hf, wf = y_s.shape
        g = y_s.float().reshape(n, c // nc, nc, hf, wf)
        pr = torch.softmax(g, dim=2)
        floors = torch.tensor(self.cfg.class_probs, dtype=torch.float32,
                              device=pr.device).view(1, 1, nc, 1, 1)
        pr = torch.where(pr < floors, torch.zeros_like(pr), pr)
        labels_p = torch.argmax(pr, dim=2).to(torch.uint8)
        heat = (pr[:, :, 2] + pr[:, :, 3]) * (mask2_u8 > 0)[:, None]
        heat_p = torch.clamp(torch.round(heat * 255.0), 0, 255) \
            .to(torch.uint8)
        return labels_p, heat_p

    def _postprocess_native_planes(self, seg: torch.Tensor,
                                   mask4_u8: torch.Tensor):
        """(N, nc, H, W) native logits (FPN, PSPNet) → the planes of
        :meth:`_postprocess_s2d` at f = ``S2D_HEAD_F``: the logits laid out
        as s2d(4) planes (channel pos·nc + c), then the same postprocess.
        Plane a·4 + b is x[a::4, b::4], as :meth:`_interleave4` expects,
        and the tissue mask applies at 1/4 resolution, as in JAX
        (``engine.py:302-329``, which takes the softmax at full resolution
        first: the same values, per pixel)."""
        return self._postprocess_s2d(space_to_depth(seg, S2D_HEAD_F),
                                     mask4_u8)

    def _postprocess_planes(self, y: torch.Tensor, masks: torch.Tensor):
        """The fused forward's head output → (labels, heat) planes: native
        logits (FPN, PSPNet) through :meth:`_postprocess_native_planes`,
        head planes through :meth:`_postprocess_s2d`."""
        if self.fast.family in NATIVE_DECODERS:
            return self._postprocess_native_planes(y, masks)
        return self._postprocess_s2d(y, masks)

    def _pack_labels(self, labels_p: torch.Tensor) -> torch.Tensor:
        """Labels fit 2 bits (nc ≤ 4): 4 position planes per byte, plane
        j + m·f²/4 in bits 2m — 4× less device→host traffic."""
        f2 = labels_p.shape[1]
        if self.cfg.num_classes > 4 or f2 % 4:
            return labels_p
        g = f2 // 4
        return (labels_p[:, :g] | (labels_p[:, g:2 * g] << 2)
                | (labels_p[:, 2 * g:3 * g] << 4) | (labels_p[:, 3 * g:] << 6))

    @staticmethod
    def _unpack_labels(packed: np.ndarray, f2: int) -> np.ndarray:
        """Host inverse of :meth:`_pack_labels` for one slide."""
        if packed.shape[0] == f2:
            return packed
        return np.concatenate([(packed >> (2 * m)) & 3 for m in range(4)])

    @staticmethod
    def _interleave4(planes: np.ndarray, hs: int, ws: int) -> np.ndarray:
        """(f², H/f, W/f) position planes → (hs, ws) full resolution."""
        n, hf, wf = planes.shape
        f = int(round(n ** 0.5))
        out = np.empty((f * hf, f * wf), planes.dtype)
        for a in range(f):
            for b in range(f):
                out[a::f, b::f] = planes[a * f + b]
        return out[:hs, :ws]

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
        (packed labels, heat planes) on the device."""
        labels_p, heat_p = self._postprocess_planes(self._forward(imgs),
                                                    masks)
        return self._pack_labels(labels_p), heat_p

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _inputs(self, plans: Sequence[SlidePlan], imgs=None):
        """Staged padded images and head-resolution masks of a group of
        planar slides with one padded geometry."""
        dims = {self._fcn_fast_dims(*p.stitch_hw) for p in plans}
        if len(dims) != 1:
            raise ValueError(f"slides of one group must share padded "
                             f"dims, got {sorted(dims)}")
        (hp, wp), = dims
        f = self._head_f()
        masks = torch.from_numpy(np.stack(
            [self._half_mask(p, (hp // f, wp // f)) for p in plans]))
        if imgs is None:
            imgs = [self.stage_slide_fcn(p) for p in plans]
        batch = [self._take(s) for s in imgs]
        batch = batch[0][None] if len(batch) == 1 else torch.stack(batch)
        return batch, masks.to(self.device)

    def _serve(self, plans: List[SlidePlan], imgs=None) -> List[SlideResult]:
        t0 = time.time()
        batch, masks = self._inputs(plans, imgs)
        labels, heat = self._run_fused(batch, masks)
        labels, heat = labels.cpu().numpy(), heat.cpu().numpy()
        per = (time.time() - t0) / len(plans)
        f2 = self._head_f() ** 2
        results = []
        for k, p in enumerate(plans):
            hs, ws = p.stitch_hw
            lab = self._interleave4(self._unpack_labels(labels[k], f2),
                                    hs, ws)
            ht = self._interleave4(heat[k], hs, ws).astype(np.float32) / 255.0
            results.append(SlideResult(p.name, lab, ht, len(p.grid), per))
        return results

    def _predict_fcn_fast(self, plan: SlidePlan, keep_canvas: bool,
                          keep_probs: bool, img=None) -> SlideResult:
        """The fused route for one slide (JAX ``_predict_fcn_fast``). With
        ``keep_probs``/``keep_canvas`` the head planes also come back and
        the host interleaves each class (FPN and PSPNet, whose logits are
        native, take the canvas branch instead); a slide stitched at
        another scan level than 2 takes the canvas branch too, through
        :meth:`_finish`."""
        keep = keep_probs or keep_canvas
        if self._fcn_planar_ok(plan) and not (
                self.fast.family in NATIVE_DECODERS and keep):
            if not keep:
                return self._serve([plan], None if img is None else [img])[0]
            t0 = time.time()
            batch, masks = self._inputs([plan],
                                        None if img is None else [img])
            y_s = self._forward(batch)
            labels_p, heat_p = self._postprocess_planes(y_s, masks)
            hs, ws = plan.stitch_hw
            labels = self._interleave4(labels_p[0].cpu().numpy(), hs, ws)
            heat = self._interleave4(heat_p[0].cpu().numpy(), hs,
                                     ws).astype(np.float32) / 255.0
            yp = y_s[0].float().cpu().numpy()         # (f²·nc, H/f, W/f)
            nc = self.cfg.num_classes
            full = np.stack([self._interleave4(yp[c::nc], hs, ws)
                             for c in range(nc)], axis=-1)
            probs = None
            if keep_probs:
                ex = np.exp(full - full.max(-1, keepdims=True))
                pr = ex / ex.sum(-1, keepdims=True)
                fl = np.asarray(self.cfg.class_probs, np.float32)
                probs = np.where(pr < fl, 0.0, pr)
            return SlideResult(plan.name, labels, heat, len(plan.grid),
                               time.time() - t0, probs=probs,
                               canvas=full if keep_canvas else None)
        t0 = time.time()
        hs, ws = plan.stitch_hw
        x = self._take(img if img is not None
                       else self.stage_slide_fcn(plan))[None]
        canvas = self._forward(x, planar_head=False)[0] \
            .permute(1, 2, 0)[:hs, :ws]
        return self._finish(plan, canvas, len(plan.grid), t0, keep_canvas,
                            keep_probs)

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
        return self._finish(plan, canvas, len(plan.grid), t0, keep_canvas,
                            keep_probs)

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
        slide = plan.slide
        ds_lvl = slide.level_downsamples[cfg.scan_level]
        reader = getattr(slide, "read_tiles", None)

        def host_batches():
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
                # origins stay host lists: the adds slice with them
                yield {"tiles": np.asarray(tiles), "ys": by.tolist(),
                       "xs": bx.tolist(), "valid": bv.tolist()}

        for b in prefetch_to_device(host_batches(), depth=cfg.prefetch_depth,
                                    device=self.device):
            self._streamed_batch(canvas, b["tiles"], b["ys"], b["xs"],
                                 b["valid"])
        return self._finish(plan, canvas, len(plan.grid), t0, keep_canvas,
                            keep_probs)

    @torch.no_grad()
    def predict_slide_fcn(self, plan: SlidePlan, chunk=None, halo: int = 128,
                          keep_canvas: bool = False,
                          keep_probs: bool = False,
                          img: Optional[StagedImage] = None) -> SlideResult:
        """ScanNet-style FCN mode: each output pixel computed once.
        ``chunk=None`` runs the fused whole-image route where it serves
        (:meth:`_fcn_fast_ok`, within ``fcn_fast_max_px``); an int or
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
        return self._finish(plan, canvas, len(plan.grid), t0, keep_canvas,
                            keep_probs)

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
        mask_full = self._resize_mask_to(plan.mask, (hs, ws))
        labels = np.empty((hs, ws), np.uint8)
        heat_u8 = np.empty((hs, ws), np.uint8)
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
            heat_u8[sl] = hb.cpu().numpy()
            if keep_canvas:
                canvas_h[sl] = bc.cpu().numpy()
            if keep_probs:
                probs_h[sl] = pb.cpu().numpy()
        return SlideResult(plan.name, labels,
                           heat_u8.astype(np.float32) / 255.0,
                           len(plan.grid), time.time() - t0,
                           probs=probs_h, canvas=canvas_h)

    @torch.no_grad()
    def predict_slides_fcn(self, plans, imgs=None) -> List[SlideResult]:
        """Serve a GROUP of same-geometry slides as one batched forward
        (slides as the batch dimension). A group the fused planar route
        cannot serve as one (one slide, mixed dims, cls mode, another scan
        level, oversize) falls back to :meth:`predict_slide_fcn` per
        slide. ``imgs`` optionally supplies staged images, index-aligned
        with ``plans``."""
        plans = list(plans)
        dims = {self._fcn_fast_dims(*p.stitch_hw) for p in plans}
        if (len(plans) == 1 or len(dims) != 1 or not self._fcn_fast_ok()
                or not all(self._fcn_planar_ok(p) and self._fcn_fast_fits(p)
                           for p in plans)):
            return [self.predict_slide_fcn(
                p, img=None if imgs is None else imgs[k])
                for k, p in enumerate(plans)]
        return self._serve(plans, imgs)

    @torch.no_grad()
    def device_throughput(self, plan: SlidePlan, mode: str = "fcn",
                          iters: int = 3, chunk=None, halo: int = 128,
                          slides_in_flight: int = 1) -> Dict[str, float]:
        """Steady-state throughput with the slide resident on the device,
        reported PER SLIDE in grid-equivalent patches (len(plan.grid)):
        ``{"patches_per_sec", "sec_per_slide"}``.

        - ``mode="fcn"`` (``chunk=None``, fused route): forward +
          postprocess + label packing, ``slides_in_flight`` slides per
          batch (another scan level than 2: the canvas branch and
          :meth:`_postprocess`). ``mode="fcn_raw"`` is the same timed
          work: JAX's variant adds the TPU stem's device-side packing,
          and the port's stem reads the raw u8 image already.
        - ``mode="fcn"`` with a ``chunk`` (or off the fused route):
          :meth:`_fcn_full_pass` + :meth:`_postprocess`.
        - ``mode="grid"``: :meth:`_full_pass` (seg or cls) +
          :meth:`_postprocess`.

        ``slides_in_flight > 1`` is refused off the fused planar route.
        The default mode is ``"fcn"`` (JAX: ``"grid"``)."""
        cfg = self.cfg
        n = len(plan.grid)
        h2, w2 = plan.canvas_hw
        hs, ws = plan.stitch_hw
        mask = self._level_mask(plan, (h2, w2))
        n_per_iter = 1

        if mode in ("fcn", "fcn_raw") and chunk is None \
                and self._fcn_fast_ok():
            if self._fcn_planar_ok(plan):
                n_per_iter = max(1, int(slides_in_flight))
                imgs, masks = self._inputs([plan])
                imgs = imgs.expand(n_per_iter, -1, -1, -1).contiguous()
                masks = masks.expand(n_per_iter, -1, -1).contiguous()

                def run():
                    return self._run_fused(imgs, masks)
            else:
                img = self._take(self.stage_slide_fcn(plan))[None]

                def run():
                    cv = self._forward(img, planar_head=False)[0] \
                        .permute(1, 2, 0)[:hs, :ws]
                    return self._postprocess(cv, mask, out_hw=(h2, w2))
        elif mode == "fcn_raw":
            raise ValueError(
                "mode='fcn_raw' times the fused route, which does not serve "
                "this engine (cls mode or scan_resize != 1); run "
                "mode='fcn' instead")
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
                "(_fcn_fast_ok() and _fcn_planar_ok(plan)); refusing to "
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
