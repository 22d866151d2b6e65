"""Dense whole-slide inference engine, fused-planar FCN path — counterpart
of ``wsiseg_tpu/infer/engine.py`` (``DenseInferenceEngine``, the
``predict_slide_fcn`` → ``_predict_fcn_fast`` → ``_fused_planar_run``
chain, multi-slide ``predict_slides_fcn`` and ``device_throughput``).

Per slide (or group of slides, as a batch dimension): the 255-padded
level image goes to the device, the fused stem kernel + functional Y-Net
produce s2d(4) logit planes, the planar postprocess (softmax, class
floors, argmax, tissue-masked heat) runs on the device, labels are packed
2 bits each, and only the u8 planes come back; the host interleaves them
to full resolution.

``engine.fcn_fold = True`` (opt-in, as in JAX) takes the fold route
instead: the native stem kernel, the encoder, and ``decode_fold`` on the
conv kernels, whose head emits s2d(2) planes — the postprocess, label
packing (four planes in one byte) and interleave then run at f = 2.

The model's weights are converted once, when the engine is built
(:func:`wsiseg_tpu_torch.models.infer_fast.prepare_fast`; the fold
route's at its first use). Routes the JAX
engine has and this port does not yet (grid and cls modes, chunked,
banded and oversize FCN, ``keep_probs``/``keep_canvas``, scan levels
other than 2) raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.data.wsi_tiles import SlidePlan
from wsiseg_tpu_torch.models.fast_decoder import S2D_HEAD_F, prepare_fold
from wsiseg_tpu_torch.models.infer_fast import prepare_fast, \
    segment_from_image

ROUTES_ITEM = ("not ported yet: ROADMAP.md, queue 1, 'grid, cls and "
               "streamed modes with oversize/banded routing'")

#: whole-image dispatch cap in padded pixels. Inherited from the JAX
#: engine, where it was sized for a TPU; not yet restated from the
#: port's measured device memory per pixel on the H100 (PERF.md).
FCN_FAST_MAX_PX = 32_000_000


@dataclass
class SlideResult:
    name: str
    labels: np.ndarray        # (H2, W2) uint8 argmax classes
    heatmap: np.ndarray       # (H2, W2) float32 in [0, 1]
    num_tiles: int
    seconds: float

    @property
    def patches_per_sec(self) -> float:
        return self.num_tiles / self.seconds if self.seconds > 0 else 0.0


@dataclass
class StagedImage:
    """A padded level image on the device, with the event that marks the
    end of its host→device copy (None when nothing is pending)."""
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
        if mode != "seg":
            raise NotImplementedError(f"mode {mode!r} is {ROUTES_ITEM}")
        if cfg.scan_level != 2 or cfg.scan_resize != 1:
            raise NotImplementedError(
                f"scan_level {cfg.scan_level} / scan_resize "
                f"{cfg.scan_resize} is {ROUTES_ITEM}")
        self.cfg = cfg
        self.mode = mode
        self.dtype = dtype
        self.model = model.to(self.device).eval()
        self.fast = prepare_fast(self.model, cfg.dataset_mean,
                                 cfg.dataset_std, dtype)
        self.slides_in_flight = 1
        #: the fold route (JAX ``fcn_fold``, ``engine.py:464-471``), opt-in
        self.fcn_fold = False
        self.fcn_fast_max_px = FCN_FAST_MAX_PX
        self._h2d_stream = None
        self._h2d_lock = threading.Lock()

    # ---- geometry ----

    @staticmethod
    def _fcn_fast_dims(h: int, w: int) -> Tuple[int, int]:
        """Pad dims for the whole-image path: H a multiple of 32 (even
        dims at every pyramid stage), W a multiple of 256."""
        return h + (-h) % 32, w + (-w) % 256

    def _fcn_fast_fits(self, plan: SlidePlan) -> bool:
        hp, wp = self._fcn_fast_dims(*plan.stitch_hw)
        return hp * wp <= int(self.fcn_fast_max_px)

    def _fcn_planar_ok(self, plan: SlidePlan) -> bool:
        """Planar-s2d head applies when no canvas rescale is needed
        (stitch dims == canvas dims, i.e. scan_level 2)."""
        return (tuple(plan.stitch_hw) == tuple(plan.canvas_hw)
                and self.mode == "seg")

    def _check_plan(self, plan: SlidePlan) -> None:
        if not self._fcn_planar_ok(plan):
            raise NotImplementedError(
                f"{plan.name}: non-planar FCN (stitch {plan.stitch_hw} != "
                f"canvas {plan.canvas_hw}) is {ROUTES_ITEM}")
        if not self._fcn_fast_fits(plan):
            raise NotImplementedError(
                f"{plan.name}: {plan.stitch_hw} exceeds fcn_fast_max_px "
                f"{self.fcn_fast_max_px}; the banded route is {ROUTES_ITEM}")

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

    # ---- staging ----

    def _pad_to_fast(self, img: np.ndarray, plan: SlidePlan) -> np.ndarray:
        """Pad a scan-level image to the FCN dims with the 255 background."""
        hs, ws = plan.stitch_hw
        hp, wp = self._fcn_fast_dims(hs, ws)
        if (hp, wp) != img.shape[:2]:
            img = np.pad(img, ((0, hp - hs), (0, wp - ws), (0, 0)),
                         constant_values=255)
        return img

    def _read_padded_level(self, plan: SlidePlan) -> np.ndarray:
        return self._pad_to_fast(
            np.asarray(plan.slide.read_level(self.cfg.scan_level)), plan)

    def stage_slide_fcn(self, plan: SlidePlan) -> StagedImage:
        """Read + pad + upload a slide's level image. On a card the copy
        goes from pinned memory on the engine's own copy stream, so a
        worker thread can stage slide k+1 while slide k computes."""
        host = torch.from_numpy(np.ascontiguousarray(
            self._read_padded_level(plan)))
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

    def _take(self, staged: StagedImage) -> torch.Tensor:
        """Make the compute stream wait for a staged copy."""
        if staged.ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(staged.ready)
            staged.tensor.record_stream(cur)
        return staged.tensor

    # ---- device passes ----

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

    def _head_f(self) -> int:
        """s2d factor of the head planes: 2 on the fold route (JAX
        ``engine.py:482``), else ``S2D_HEAD_F``."""
        return 2 if self.fcn_fold else S2D_HEAD_F

    @torch.no_grad()
    def _run_fused(self, imgs: torch.Tensor, masks: torch.Tensor):
        """(N, Hp, Wp, 3) u8 + (N, Hp/f, Wp/f) u8 masks on the device →
        (packed labels, heat planes) on the device."""
        if self.fcn_fold and self.fast.fold is None:
            self.fast.fold = prepare_fold(self.model, self.dtype)
        y_s = segment_from_image(self.fast, imgs, planar_head=True,
                                 fold=self.fcn_fold)
        labels_p, heat_p = self._postprocess_s2d(y_s, masks)
        return self._pack_labels(labels_p), heat_p

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _inputs(self, plans: Sequence[SlidePlan], imgs=None):
        dims = {self._fcn_fast_dims(*p.stitch_hw) for p in plans}
        if len(dims) != 1:
            raise ValueError(f"slides of one group must share padded "
                             f"dims, got {sorted(dims)}")
        for p in plans:
            self._check_plan(p)
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

    # ---- public API ----

    def predict_slide_fcn(self, plan: SlidePlan, chunk=None,
                          keep_canvas: bool = False,
                          keep_probs: bool = False,
                          img: Optional[StagedImage] = None) -> SlideResult:
        """ScanNet-style FCN mode: the whole padded level image as one
        forward, each output pixel computed once. ``img`` takes a staged
        image from :meth:`stage_slide_fcn`."""
        if chunk is not None or keep_canvas or keep_probs:
            raise NotImplementedError(
                f"chunked FCN and keep_probs/keep_canvas are {ROUTES_ITEM}")
        return self._serve([plan], None if img is None else [img])[0]

    def predict_slides_fcn(self, plans, imgs=None) -> List[SlideResult]:
        """Serve a GROUP of same-geometry slides as one batched forward
        (slides as the batch dimension). ``imgs`` optionally supplies
        staged images, index-aligned with ``plans``."""
        return self._serve(list(plans), imgs)

    def device_throughput(self, plan: SlidePlan, mode: str = "fcn",
                          iters: int = 3, chunk=None,
                          slides_in_flight: int = 1) -> Dict[str, float]:
        """Steady-state throughput with the slide resident on the device:
        forward + postprocess + label packing, ``slides_in_flight`` slides
        per batch, reported PER SLIDE. ``{"patches_per_sec",
        "sec_per_slide"}`` in grid-equivalent patches (len(plan.grid))."""
        if mode != "fcn" or chunk is not None:
            raise NotImplementedError(f"device_throughput(mode={mode!r}, "
                                      f"chunk={chunk}) is {ROUTES_ITEM}")
        nsf = max(1, int(slides_in_flight))
        imgs, masks = self._inputs([plan])
        imgs, masks = imgs.expand(nsf, -1, -1, -1).contiguous(), \
            masks.expand(nsf, -1, -1).contiguous()
        self._run_fused(imgs, masks)             # warm-up
        self._sync()
        t0 = time.time()
        for _ in range(iters):
            self._run_fused(imgs, masks)
        self._sync()
        dt = (time.time() - t0) / (iters * nsf)
        return {"patches_per_sec": len(plan.grid) / dt if dt > 0 else 0.0,
                "sec_per_slide": dt}
