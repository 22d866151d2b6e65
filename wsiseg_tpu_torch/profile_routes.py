"""Where the device time goes on the whole-slide routes, on one CUDA
device:

    python -m wsiseg_tpu_torch.profile_routes [--slides 1] [--iters 3] \
        [--model_name Unet] [--arch_encoder resnet18]

For the default route and, where the model has one (Unet on resnet18/34),
the fold route (``engine.fcn_fold``), at the bench geometry (a 4096×3072
level-2 synthetic slide, 4 classes, bf16, random weights from
``torch.Generator().manual_seed(0)``; resnet18 Unet unless the flags name
another decoder family or encoder):

- CUDA-event ms per stage of the forward (stem, encoder, decoder,
  postprocess + label packing), median of ``--iters``;
- ``torch.profiler`` over ``--iters`` steady engine runs: wall ms, summed
  kernel ms, the device's busy share, and kernel ms by class — the port's
  own kernels (``stem_sm90_kernel``, ``conv9_sm90_kernel``,
  ``conv_chain_sm90_kernel``), library
  convolutions and GEMMs, and everything else (eager elementwise passes,
  copies, reductions);
- peak device memory of one run.

Prints one JSON line per route. Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from wsiseg_tpu_torch.config import KNOWN_ENCODERS, KNOWN_MODELS

BENCH_HW = (3072, 4096)
OWN = ("stem_sm90_kernel", "conv9_sm90_kernel", "conv_chain_sm90_kernel")
LIBRARY = ("conv", "cudnn", "xmma", "gemm", "cutlass", "implicit")


def _classify(name: str) -> str:
    low = name.lower()
    if any(k in name for k in OWN):
        return "own_kernels"
    if any(k in low for k in LIBRARY):
        return "library_conv"
    return "other"


def _events_ms(fn, iters: int) -> float:
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


@torch.no_grad()
def _stages(engine, imgs, masks, iters: int) -> dict:
    """CUDA-event ms of each forward stage, each stage timed on the
    previous stage's real output."""
    from wsiseg_tpu_torch.models.fast_decoder import decode_fold
    from wsiseg_tpu_torch.models.fast_encoder import encode_stages
    from wsiseg_tpu_torch.models.infer_fast import decode
    from wsiseg_tpu_torch.ops.stem import stem_conv, stem_pool_conv

    fw = engine.fast
    out = {}
    if engine.fcn_fold:
        c1 = stem_conv(imgs, fw.stem_w, fw.stem_b, fw.pad_rgb,
                       fw.stem_cells)
        out["stem"] = _events_ms(lambda: stem_conv(
            imgs, fw.stem_w, fw.stem_b, fw.pad_rgb, fw.stem_cells), iters)
        c1n = c1.permute(0, 3, 1, 2)
        feats = encode_stages(fw.enc, None, fw.dtype, c1=c1n)
        out["encoder"] = _events_ms(lambda: encode_stages(
            fw.enc, None, fw.dtype, c1=c1n), iters)
        y = decode_fold(fw.fold, feats, fw.dtype, use_chain=False,
                        planar_head=True)
        out["decoder"] = _events_ms(lambda: decode_fold(
            fw.fold, feats, fw.dtype, use_chain=False, planar_head=True),
            iters)
    else:
        c1s2d, pool = stem_pool_conv(imgs, fw.stem_w, fw.stem_b, fw.pad_rgb,
                                     fw.stem_cells)
        out["stem"] = _events_ms(lambda: stem_pool_conv(
            imgs, fw.stem_w, fw.stem_b, fw.pad_rgb, fw.stem_cells), iters)
        pooled = pool.permute(0, 3, 1, 2)
        feats = encode_stages(fw.enc, pooled, fw.dtype)
        out["encoder"] = _events_ms(lambda: encode_stages(
            fw.enc, pooled, fw.dtype), iters)
        skip = c1s2d.permute(0, 3, 1, 2)
        y = decode(fw, feats, skip)
        out["decoder"] = _events_ms(lambda: decode(fw, feats, skip), iters)

    def post():
        labels, heat = engine._postprocess_planes(y, masks)
        return engine._pack_labels(labels), heat

    out["postprocess"] = _events_ms(post, iters)
    return out


def profile_route(fold: bool, n_slides: int, iters: int,
                  model_name: str = "Unet",
                  arch_encoder: str = "resnet18") -> dict:
    from wsiseg_tpu_torch.config import default_config
    from wsiseg_tpu_torch.data.wsi_tiles import plan_slide
    from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
    from wsiseg_tpu_torch.models.ynet import init_ynet
    from wsiseg_tpu_torch.slides import VirtualPyramidSlide
    from wsiseg_tpu_torch.data.bench_slide import level2_image

    cfg = default_config(wsi_mask_pth="", model_name=model_name,
                         arch_encoder=arch_encoder)
    engine = DenseInferenceEngine(
        init_ynet(cfg, torch.Generator().manual_seed(0)), cfg)
    engine.fcn_fold = fold
    slide = VirtualPyramidSlide({2: level2_image(*BENCH_HW, seed=20)},
                                num_levels=3)
    plan = plan_slide("bench", slide, cfg)
    imgs, masks = engine._inputs([plan])
    imgs = imgs.expand(n_slides, -1, -1, -1).contiguous()
    masks = masks.expand(n_slides, -1, -1).contiguous()
    engine._run_fused(imgs, masks)                 # warm-up (and fold prep)
    torch.cuda.synchronize()
    stages = _stages(engine, imgs, masks, iters)

    torch.cuda.reset_peak_memory_stats()
    engine._run_fused(imgs, masks)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            engine._run_fused(imgs, masks)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_class = {"own_kernels": 0.0, "library_conv": 0.0, "other": 0.0}
    top = []
    for ev in prof.key_averages():
        # kernels only: operator rows carry their kernels' time again
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3 / iters
        by_class[_classify(ev.key)] += ms
        top.append((ms, ev.key[:60]))
    kernel_ms = sum(by_class.values())
    return {
        "route": "fold" if fold else "default", "slides": n_slides,
        "model_name": model_name, "arch_encoder": arch_encoder,
        "stage_ms": stages, "stage_sum_ms": sum(stages.values()),
        "wall_ms_per_run": wall_ms / iters,
        "kernel_ms_per_run": kernel_ms,
        "busy_share": kernel_ms / (wall_ms / iters) if wall_ms else None,
        "kernel_ms_by_class": by_class, "kernel_names": len(top),
        "top_kernels": sorted(top, reverse=True)[:8],
        "peak_memory_gb": peak / 1e9,
        "device": torch.cuda.get_device_name(0),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--slides", type=int, default=1)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--model_name", default="Unet", choices=KNOWN_MODELS)
    p.add_argument("--arch_encoder", default="resnet18",
                   choices=KNOWN_ENCODERS)
    ns = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_routes needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fold_ok = ns.model_name == "Unet" and ns.arch_encoder in ("resnet18",
                                                              "resnet34")
    for fold in (False, True) if fold_ok else (False,):
        print(json.dumps(profile_route(fold, ns.slides, ns.iters,
                                       ns.model_name, ns.arch_encoder)),
              flush=True)


if __name__ == "__main__":
    main()
