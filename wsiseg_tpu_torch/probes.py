"""Hopper micro-benchmarks of the questions the TPU probes asked, asked again
on the H100: for ``csrc/conv3x3_sm90.cu`` the conv9 probes
(``scripts/probe_dot.py``, ``probe_mosaic.py``, ``probe_dot2.py``,
``probe_dot3.py``, ``probe_dma64.py``), for ``csrc/stem_sm90.cu`` the stem
probes (``scripts/exp_r6e.py``, ``probe_retile.py``); the kernels are in
``csrc/probes.cu`` and, for probe 5, ``csrc/stem_sm90.cu`` itself:

    python3 -m wsiseg_tpu_torch.probes

1. :func:`probe_wgmma` — wgmma on shared-memory-resident tiles, K = 9 taps
   × 128 channels on a 128-pixel strip, N = 16 ... 256: nine TMA-staged tap
   tiles (``taps``), one halo window read by shifted descriptors with
   (``halo``) and without (``halo_base0``) the descriptor's base offset,
   and tap 0 alone (``floor``, 1/9 of the work).
2. :func:`probe_load` — the conv's per-K-step load floor at 1536×2048,
   128→64: its TMA producer and a ring of 1, 2 or 4 stages, no math.
3. :func:`probe_store` — the output-store floor, (8×1024, 64) bf16 blocks
   into a (1536, 2048, 64) tensor, ``st.global`` against TMA stores.
4. :func:`probe_window` — TMA windows at negative and past-the-edge
   coordinates from NHWC tensors with C = 32 and 64, zero-filled.
5. :func:`probe_stem_assembly` (P1, stem v3) — the pool-mode stem at
   exp_r6e's geometry in its three A-operand assembly forms (per c1 row,
   once per block with shifted copies, once per block read by shifted
   descriptors): bit-identical to each other, each within one bf16 ulp of
   the plain version, each timed.
6. :func:`probe_pool_epilogue` (P2c, ``probe_retile``) — the fused pool
   epilogue's primitives on wgmma accumulator fragments: the parity-half
   max, the one-cell shift by shuffles or through shared memory, the mask
   of a row's first cell; at the TPU probe's (128, 128) shape and at slide
   scale, 1536 rows of 1024 cells × 128.

Each has a plain PyTorch version (``*_ref``) that its output is held
against. On a CUDA tensor a probe launches its kernel or raises; probes
have no CPU mode (they measure the card). Prints one line per case and a
JSON line of results; needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import math
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from wsiseg_tpu_torch.ops import stem
from wsiseg_tpu_torch.ops.conv9 import ERRORS
from wsiseg_tpu_torch.ops.stem import kernel_entry

#: kernel launches per probe since import (or since a caller reset them)
LAUNCHES = {"probe_wgmma": 0, "probe_load": 0, "probe_store": 0,
            "probe_window": 0, "probe_stem_assembly": 0,
            "probe_pool_epilogue": 0}
WGMMA_MODES = {"taps": 0, "halo": 1, "halo_base0": 2, "floor": 3}
WGMMA_WIDTHS = (16, 32, 64, 128, 256)
WIN_COLS = 130
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12         # dense bf16 tensor cores, same source
# the TPU probes' shapes: probe_dot's 384 steps of 8×1024 px; probe_dot2's
# and probe_dot3's 1536×2048 layer
DOT_PX = 384 * 8 * 1024
LAYER_HW = (1536, 2048)
# exp_r6e's image and the slide-scale pool epilogue: c1 rows × cells
STEM_HW = (3072, 4096)
POOL_CELLS = (1536, 1024)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
TOL = 2.0 ** -7                  # one bf16 ulp, relative
_P, _I = ctypes.c_void_p, ctypes.c_int


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{ERRORS.get(err, f'CUDA error {err}')}")


def _on_cuda(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda" or t.dtype != torch.bfloat16 \
                or not t.is_contiguous():
            raise ValueError(f"probes take contiguous bf16 CUDA tensors, got "
                             f"{t.dtype} on {t.device}")


def probe_wgmma(win: torch.Tensor, b: torch.Tensor, mode: str,
                grid: int = 1, reps: int = 1) -> torch.Tensor:
    """win (3, 130, 64), b (N, 64) bf16 → block 0's (128, N) f32
    accumulator after ``reps`` passes of K = 9 taps × 128 channels."""
    _on_cuda(win, b)
    bn = b.shape[0]
    if tuple(win.shape) != (3, WIN_COLS, 64) or bn not in WGMMA_WIDTHS:
        raise ValueError(f"win (3, 130, 64) and b (N ∈ {WGMMA_WIDTHS}, 64), "
                         f"got {tuple(win.shape)}, {tuple(b.shape)}")
    out = torch.empty((128, bn), dtype=torch.float32, device=win.device)
    fn = kernel_entry("wsiseg_probe_wgmma", [_P, _P, _I, _I, _I, _I, _P, _P])
    with torch.cuda.device(win.device):
        _check(fn(win.data_ptr(), b.data_ptr(), bn, WGMMA_MODES[mode], grid,
                  reps, out.data_ptr(), _stream(win)), "probe_wgmma")
    LAUNCHES["probe_wgmma"] += 1
    return out


def probe_wgmma_ref(win: torch.Tensor, b: torch.Tensor, mode: str,
                    reps: int = 1) -> torch.Tensor:
    """Plain version: 2·reps·Σ_taps win[dy, dx:dx + 128] · bᵀ in f32."""
    taps = 1 if mode == "floor" else 9
    a = sum(win[t // 3, t % 3:t % 3 + 128].float() for t in range(taps))
    return 2.0 * reps * (a @ b.float().t())


def probe_wgmma_flops(bn: int, mode: str, grid: int, reps: int) -> float:
    taps = 1 if mode == "floor" else 9
    return 2.0 * grid * reps * 128 * bn * 128 * taps


def probe_load(x: torch.Tensor, wt: torch.Tensor, stages: int
               ) -> torch.Tensor:
    """x (N, H, W, C), W % 128 == 0, wt (64, 9, C) → per 1 × 128 tile the
    sum over its K steps of channels 0–7 of the step's first pixel."""
    _on_cuda(x, wt)
    n, h, w, c = x.shape
    out = torch.empty(n * h * w // 128, dtype=torch.float32, device=x.device)
    fn = kernel_entry("wsiseg_probe_load", [_P] + [_I] * 4 + [_P, _I, _P, _P])
    with torch.cuda.device(x.device):
        _check(fn(x.data_ptr(), n, h, w, c, wt.data_ptr(), stages,
                  out.data_ptr(), _stream(x)), "probe_load")
    LAUNCHES["probe_load"] += 1
    return out


def probe_load_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`probe_load`."""
    n, h, w, c = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((n, h, w // 128), device=x.device)
    for c0 in range(0, c, 64):
        for t in range(9):
            dy, dx = divmod(t, 3)
            acc += xp[:, dy:dy + h, dx:dx + w:128, c0:c0 + 8].sum(-1)
    return acc.reshape(-1)


def probe_store(out: torch.Tensor, br: int, wc: int, use_tma: bool
                ) -> torch.Tensor:
    """Fill out (H, W, 64) bf16 with :func:`probe_store_ref`'s pattern in
    br × wc blocks, by st.global or TMA stores."""
    _on_cuda(out)
    h, w, _ = out.shape
    fn = kernel_entry("wsiseg_probe_store", [_P] + [_I] * 5 + [_P])
    with torch.cuda.device(out.device):
        _check(fn(out.data_ptr(), h, w, br, wc, int(use_tma),
                  _stream(out)), "probe_store")
    LAUNCHES["probe_store"] += 1
    return out


def probe_store_ref(h: int, w: int, device) -> torch.Tensor:
    """out[y, x, c] = ((y·W + x)·7 + c) mod 256, exact in bf16."""
    y = torch.arange(h, device=device).view(h, 1, 1)
    x = torch.arange(w, device=device).view(1, w, 1)
    c = torch.arange(64, device=device).view(1, 1, 64)
    return (((y * w + x) * 7 + c) % 256).to(torch.bfloat16)


def probe_window(x: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, C ≤ 64) → (N, H + 2, W + 2, 64) through TMA windows."""
    _on_cuda(x)
    n, h, w, c = x.shape
    out = torch.empty((n, h + 2, w + 2, 64), dtype=torch.bfloat16,
                      device=x.device)
    fn = kernel_entry("wsiseg_probe_window", [_P] + [_I] * 4 + [_P, _P])
    with torch.cuda.device(x.device):
        _check(fn(x.data_ptr(), n, h, w, c, out.data_ptr(), _stream(x)),
               "probe_window")
    LAUNCHES["probe_window"] += 1
    return out


def probe_window_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: one zero pixel around, zero channels up to 64."""
    return F.pad(x, (0, 64 - x.shape[-1], 1, 1, 1, 1))


def probe_stem_assembly(img: torch.Tensor, w_cells: torch.Tensor,
                        bias: torch.Tensor, pad_rgb, form: str):
    """The pool-mode stem kernel (``csrc/stem_sm90.cu``) in assembly form
    ``form`` of :data:`wsiseg_tpu_torch.ops.stem.FORMS` → (s2d(c1), pool)."""
    out = stem.launch_cells(img, w_cells, bias, pad_rgb, True, form)
    LAUNCHES["probe_stem_assembly"] += 1
    return out


def probe_pool_epilogue(x: torch.Tensor, mask: torch.Tensor, shift: int,
                        staged: bool):
    """x (R, C, 128) bf16, C % 64 == 0, mask (C,) bf16 → (o = x, p (R, C,
    64)) as :func:`probe_pool_epilogue_ref`; the one-cell shift by shuffles
    or (``staged``) through shared memory."""
    _on_cuda(x, mask)
    r, c, _ = x.shape
    if x.shape[2] != 128 or c % 64 or tuple(mask.shape) != (c,):
        raise ValueError(f"x (R, C % 64 == 0, 128), mask (C,), got "
                         f"{tuple(x.shape)}, {tuple(mask.shape)}")
    o = torch.empty_like(x)
    p = torch.empty((r, c, 64), dtype=torch.bfloat16, device=x.device)
    fn = kernel_entry("wsiseg_probe_pool", [_P, _P] + [_I] * 4 + [_P] * 3)
    with torch.cuda.device(x.device):
        _check(fn(x.data_ptr(), mask.data_ptr(), r, c, shift, int(staged),
                  o.data_ptr(), p.data_ptr(), _stream(x)),
               "probe_pool_epilogue")
    LAUNCHES["probe_pool_epilogue"] += 1
    return o, p


def probe_pool_epilogue_ref(x: torch.Tensor, mask: torch.Tensor, shift: int):
    """Plain version: o = x; p = max(max(prev·mask, e), o) with e, o the
    halves x[..., :64], x[..., 64:] and prev = o (shift 0, probe_retile's
    kernel) or o of the cell before, zero before a row's first (shift 1,
    the stem pool's column shift); the product rounded to bf16."""
    e, o = x[..., :64], x[..., 64:]
    prev = o if shift == 0 else F.pad(o, (0, 0, 1, 0))[..., :-1, :]
    pm = (prev.float() * mask.float().view(-1, 1)).to(x.dtype)
    return x.clone(), torch.maximum(torch.maximum(pm, e), o)


def stem_library_call(x: torch.Tensor, w_folded: torch.Tensor,
                      bias: torch.Tensor, pad_rgb):
    """The stem's yardstick: one bf16 channels_last ``F.conv2d`` of its
    7×7/2 conv (+ bias) on the pre-padded image; normalize is folded into
    the weights, the u8 → bf16 cast and ReLU/pool are not in it."""
    n, h, wd, _ = x.shape
    canvas = torch.tensor(pad_rgb, dtype=torch.bfloat16,
                          device=x.device).view(1, 3, 1, 1).repeat(
                              n, 1, h + 6, wd + 6)
    canvas[:, :, 3:3 + h, 3:3 + wd] = x.permute(0, 3, 1, 2)
    canvas = canvas.contiguous(memory_format=torch.channels_last)
    k = w_folded.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    bb = bias.to(torch.bfloat16)
    return lambda: F.conv2d(canvas, k, bb, stride=2)


def stem_cost(h: int, w: int, pool: bool):
    """(operations, bytes) of the stem on one (h, w) image: the conv's
    useful operations (147 taps), the u8 image and weights read once, the
    outputs written once (s2d(c1) and pool, or c1)."""
    c1 = (h // 2) * (w // 2) * 64 * 2
    out = c1 + c1 // 4 if pool else c1
    return (2.0 * (h // 2) * (w // 2) * 147 * 64,
            h * w * 3 + out + 147 * 64 * 2 + 64 * 4)


def stem_weights(dev):
    """Seeded random stem weights and BN, folded: (w_folded, bias)."""
    r = np.random.RandomState(0)
    kernel = torch.from_numpy(r.randn(64, 3, 7, 7).astype(np.float32) * 0.05)
    vecs = [torch.from_numpy(v.astype(np.float32)) for v in (
        r.rand(64) + 0.5, r.randn(64) * 0.1, r.randn(64) * 0.1,
        r.rand(64) + 0.5)]
    return stem.fold_stem_weights(kernel.to(dev), *(v.to(dev) for v in vecs),
                                  MEAN, STD)


def _ulp_close(got: torch.Tensor, want: torch.Tensor) -> float:
    g, r = got.float(), want.float()
    torch.testing.assert_close(g, r, rtol=TOL, atol=TOL * r.abs().max().item())
    return (g - r).abs().max().item()


def cuda_ms(fn: Callable[[], object], iters: int = 20) -> float:
    """Median ms of ``fn`` over ``iters`` CUDA-event-timed calls, after
    warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(flops: float, nbytes: float) -> dict:
    """Least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the bf16 tensor-core peak."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return {"bound_ms": 1e3 * max(t_b, t_f),
            "bound_by": "bytes" if t_b >= t_f else "operations"}


def _randn(rng, shape, dev, scale=1.0) -> torch.Tensor:
    return torch.from_numpy((rng.randn(*shape) * scale).astype(
        np.float32)).to(dev).to(torch.bfloat16)


def run_probes(dev, log: Callable[[str], None] = print) -> Dict[str, dict]:
    """Every probe once against its plain version (those launches are the
    ``launches`` of each result), then timed at the TPU probes' shapes.
    Raises if a probe disagrees with its plain version; the halo form that
    disagrees is reported, not raised (it is the question probe 1 asks)."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    rng = np.random.RandomState(5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res: Dict[str, dict] = {}

    # 1: every wgmma width in the staged-taps form; halo/floor at 64
    win = _randn(rng, (3, WIN_COLS, 64), dev)
    bs = {bn: _randn(rng, (bn, 64), dev, 0.125) for bn in WGMMA_WIDTHS}
    errs, halo_ok = [], {}
    cases = [(bn, "taps") for bn in WGMMA_WIDTHS] + [
        (64, m) for m in ("halo", "halo_base0", "floor")]
    for bn, mode in cases:
        got = probe_wgmma(win, bs[bn], mode)
        want = probe_wgmma_ref(win, bs[bn], mode)
        ok = torch.allclose(got, want, rtol=1e-3,
                            atol=1e-3 * want.abs().max().item())
        err = (got - want).abs().max().item()
        if mode.startswith("halo"):
            halo_ok[mode] = bool(ok)
        elif not ok:
            raise AssertionError(f"probe_wgmma N={bn} {mode}: max|d| {err}")
        else:
            errs.append(err)
        log(f"[probe 1] wgmma m64n{bn}k16 {mode}: max|d| {err:.6g} "
            f"({'matches' if ok else 'DIFFERS from'} the plain version)")
    launches = {"probe_wgmma": LAUNCHES["probe_wgmma"]}
    reps = math.ceil(DOT_PX / 128 / sms)
    rates = {}
    for bn in (64, 128, 256):
        for mode in ("taps", "halo", "halo_base0", "floor"):
            if mode.startswith("halo") and not halo_ok[mode]:
                continue
            ms = cuda_ms(lambda: probe_wgmma(win, bs[bn], mode, sms, reps),
                         5)
            tf = probe_wgmma_flops(bn, mode, sms, reps) / ms / 1e9
            rates[f"n{bn}_{mode}"] = {"ms": ms, "tflops": tf}
            log(f"[probe 1] {sms} blocks × {reps} strips, 128→{bn}, "
                f"{mode}: {ms:.4f} ms, {tf:.1f} TFLOP/s")
    b64 = bs[64]
    plain_ms = cuda_ms(lambda: [probe_wgmma_ref(win, b64, "taps")
                                for _ in range(reps)], 5)
    # the library yardstick: the same multiply-adds as one torch.matmul, the
    # nine tap tiles of both 64-channel steps as one K = 1152 operand per
    # strip, all sms·reps strips stacked (read from device memory, where the
    # kernel keeps its tiles resident)
    taps = torch.cat([win[t // 3, t % 3:t % 3 + 128] for t in range(9)], 1)
    a_lib = taps.repeat(sms * reps, 2)
    b_lib = b64.t().repeat(18, 1)
    lib_ms = cuda_ms(lambda: torch.matmul(a_lib, b_lib), 5)
    del a_lib
    log(f"[probe 1] torch.matmul of the same multiply-adds "
        f"({sms * reps * 128}x1152 @ 1152x64): {lib_ms:.4f} ms")
    res["probe_wgmma"] = dict(
        max_abs_err=max(errs), ms=rates["n64_taps"]["ms"],
        plain_ms=plain_ms, library_ms=lib_ms, halo_ok=halo_ok, rates=rates,
        **bound(probe_wgmma_flops(64, "taps", sms, reps), 0.0))

    # 2: load floor at 1536×2048, 128→64
    h, w = LAYER_HW
    x = _randn(rng, (1, h, w, 128), dev)
    wt = _randn(rng, (64, 9, 128), dev)
    want = probe_load_ref(x)
    err = 0.0
    for stages in (1, 2, 4):
        got = probe_load(x, wt, stages)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
        err = max(err, (got - want).abs().max().item())
    launches["probe_load"] = LAUNCHES["probe_load"]
    steps = h * w // 128 * 18
    stage_bytes = (128 + 64) * 64 * 2
    times = {}
    for stages in (1, 2, 4):
        ms = cuda_ms(lambda: probe_load(x, wt, stages))
        times[stages] = ms
        log(f"[probe 2] load floor {h}x{w} 128→64, {stages} stage(s): "
            f"{ms:.4f} ms, {ms * 1e3 * sms / steps:.4f} µs per K step per "
            f"SM, {steps * stage_bytes / ms / 1e6:.1f} GB/s into shared "
            "memory")
    res["probe_load"] = dict(
        max_abs_err=err, ms=times[4], plain_ms=cuda_ms(
            lambda: probe_load_ref(x)), library_ms=None, stages_ms=times,
        **bound(0.0, x.numel() * 2 + wt.numel() * 2 + want.numel() * 4))

    # 3: store floor, (8×1024, 64) blocks into (1536, 2048, 64)
    want = probe_store_ref(h, w, dev)
    out = torch.empty((h, w, 64), dtype=torch.bfloat16, device=dev)
    times = {}
    for use_tma in (False, True):
        out.zero_()
        probe_store(out, 8, 1024, use_tma)
        if not torch.equal(out, want):
            raise AssertionError(f"probe_store use_tma={use_tma} differs")
    launches["probe_store"] = LAUNCHES["probe_store"]
    for use_tma in (False, True):
        name = "tma" if use_tma else "st.global"
        ms = cuda_ms(lambda: probe_store(out, 8, 1024, use_tma))
        times[name] = ms
        log(f"[probe 3] store floor (8x1024, 64) blocks into ({h}, {w}, 64) "
            f"by {name}: {ms:.4f} ms, {out.numel() * 2 / ms / 1e6:.1f} GB/s")
    # the library yardstick: copy_ of the finished pattern into the output
    res["probe_store"] = dict(
        max_abs_err=0.0, ms=times["st.global"],
        plain_ms=cuda_ms(lambda: probe_store_ref(h, w, dev)),
        library_ms=cuda_ms(lambda: out.copy_(want)), variants_ms=times,
        **bound(0.0, out.numel() * 2))

    # 4: windows with zero fill, C = 32 and 64, ragged and full size
    full = {c: _randn(rng, (1, h, w, c), dev) for c in (32, 64)}
    for xs in [_randn(rng, (2, 13, 45, 32), dev),
               _randn(rng, (1, 9, 300, 64), dev), *full.values()]:
        if not torch.equal(probe_window(xs), probe_window_ref(xs)):
            raise AssertionError(f"probe_window {tuple(xs.shape)} differs")
    launches["probe_window"] = LAUNCHES["probe_window"]
    times = {}
    for c, xs in full.items():
        ms = cuda_ms(lambda: probe_window(xs))
        lib = cuda_ms(lambda: probe_window_ref(xs))
        nbytes = xs.numel() * 2 + (h + 2) * (w + 2) * 64 * 2
        times[c] = {"ms": ms, "library_ms": lib, **bound(0.0, nbytes)}
        log(f"[probe 4] TMA windows {h}x{w} C={c} → zero-padded ({h + 2}, "
            f"{w + 2}, 64): equal to torch slicing; {ms:.4f} ms "
            f"({nbytes / ms / 1e6:.1f} GB/s), F.pad {lib:.4f} ms")
    res["probe_window"] = dict(max_abs_err=0.0, plain_ms=times[32][
        "library_ms"], by_c=times, **times[32])
    del full, xs

    # 5: the stem's assembly forms at exp_r6e's geometry
    h, w = STEM_HW
    img = torch.from_numpy(np.random.RandomState(0).randint(
        0, 255, (1, h, w, 3), np.uint8)).to(dev)
    wf, bias = stem_weights(dev)
    pad = stem.pad_value(MEAN)
    w_cells = stem.prepare_stem_cells(wf)
    want = stem.stem_pool_conv_ref(img, wf, bias, pad)
    outs = {f: probe_stem_assembly(img, w_cells, bias, pad, f)
            for f in stem.FORMS}
    torch.cuda.synchronize()
    first = outs[stem.FORMS[0]]
    for f, got in outs.items():
        if not all(torch.equal(a, b) for a, b in zip(got, first)):
            raise AssertionError(f"probe_stem_assembly: form {f} is not "
                                 f"bit-identical to {stem.FORMS[0]}")
    err = max(_ulp_close(g, r) for g, r in zip(first, want))
    del outs, first, want
    launches["probe_stem_assembly"] = LAUNCHES["probe_stem_assembly"]
    forms = {}
    for f in stem.FORMS:
        ms = cuda_ms(lambda: probe_stem_assembly(img, w_cells, bias, pad, f))
        forms[f] = {"ms": ms,
                    "wgs": stem.plan_stem(1, h, w, True, f, sms).wgs}
        log(f"[probe 5] stem assembly {f} ({forms[f]['wgs']} warpgroups a "
            f"block) {h}x{w}: {ms:.4f} ms, bit-identical across forms, "
            f"max|d| {err:.6g} against the plain version")
    best = min(forms, key=lambda f: forms[f]["ms"])
    log(f"[probe 5] fastest form: {best} (served: {stem.SERVED_FORM})")
    res["probe_stem_assembly"] = dict(
        max_abs_err=err, ms=forms[best]["ms"], forms=forms, fastest=best,
        plain_ms=cuda_ms(lambda: stem.stem_pool_conv_ref(img, wf, bias, pad),
                         5),
        library_ms=cuda_ms(stem_library_call(img, wf, bias, pad)),
        **bound(*stem_cost(h, w, True)))
    del img

    # 6: the pool epilogue at probe_retile's (128, 128) and at slide scale
    small = torch.from_numpy(rng.rand(1, 128, 128).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    m = torch.ones(128, dtype=torch.bfloat16, device=dev)
    m[0] = 0
    for shift in (0, 1):
        for staged in (False, True):
            want = probe_pool_epilogue_ref(small, m, shift)
            got = probe_pool_epilogue(small, m, shift, staged)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"probe_pool_epilogue (128, 128) shift "
                                     f"{shift} staged {staged} differs")
    rows, cells = POOL_CELLS
    x = torch.from_numpy(rng.rand(rows, cells, 128).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    m = torch.ones(cells, dtype=torch.bfloat16, device=dev)
    m[0] = 0
    want = probe_pool_epilogue_ref(x, m, 1)
    for staged in (False, True):
        got = probe_pool_epilogue(x, m, 1, staged)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"probe_pool_epilogue {rows}x{cells} "
                                 f"staged {staged} differs")
    del got, want
    launches["probe_pool_epilogue"] = LAUNCHES["probe_pool_epilogue"]
    nbytes = x.numel() * 2 * 2 + rows * cells * 64 * 2
    times = {}
    for name, shift, staged in (("shuffle", 1, False), ("staged", 1, True),
                                ("no_shift", 0, False)):
        times[name] = cuda_ms(lambda: probe_pool_epilogue(x, m, shift,
                                                          staged))
        log(f"[probe 6] pool epilogue {rows}x{cells} cells x 128, "
            f"{name}: {times[name]:.4f} ms "
            f"({nbytes / times[name] / 1e6:.1f} GB/s); equal to the plain "
            "version at (128, 128) and at this size")
    res["probe_pool_epilogue"] = dict(
        max_abs_err=0.0, ms=times["shuffle"], variants_ms=times,
        plain_ms=cuda_ms(lambda: probe_pool_epilogue_ref(x, m, 1), 5),
        library_ms=None, **bound(0.0, nbytes))
    for k, r in res.items():
        r["launches"] = launches[k]
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the probes need a CUDA device")
    dev = torch.device("cuda", 0)
    res = run_probes(dev)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "probes": res}))


if __name__ == "__main__":
    main()
