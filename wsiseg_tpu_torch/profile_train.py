"""Where the device time of a training step goes, on one CUDA device:

    python -m wsiseg_tpu_torch.profile_train [--batch 30] [--tile 512] \
        [--iters 5] [--model_name Unet] [--arch_encoder resnet18]

The hybrid step of ``python -m wsiseg_tpu_torch train`` (bf16 autocast,
f32 parameters, adam, ``channels_last``; random weights from
``torch.Generator().manual_seed(0)``) on a batch resident on the card,
after 3 warm-up steps:

- CUDA-event ms of the whole step, and of its forward alone (under
  ``torch.no_grad`` in train mode), median of ``--iters``;
- ``torch.profiler`` over ``--iters`` steps: wall ms, summed kernel ms,
  the device's busy share, and kernel ms by class — library convolutions
  and GEMMs, BatchNorm, the optimizer, and everything else (eager
  elementwise passes, copies, reductions, the losses);
- peak device memory of one step.

Prints one JSON line. Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from wsiseg_tpu_torch.config import KNOWN_ENCODERS, KNOWN_MODELS
from wsiseg_tpu_torch.utils import profiling

CLASSES = (("library_conv", ("conv", "cudnn", "xmma", "gemm", "cutlass",
                             "implicit", "sm90_")),
           ("batch_norm", ("batch_norm", "batchnorm", "bn_")),
           ("optimizer", ("adam", "multi_tensor", "foreach")))


def _classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
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


def profile_step(batch: int, tile: int, iters: int, model_name: str,
                 arch_encoder: str) -> dict:
    from wsiseg_tpu_torch.cli.common import make_preprocess, setup_ynet
    from wsiseg_tpu_torch.config import default_config
    from wsiseg_tpu_torch.train.steps import (autocast,
                                              make_hybrid_train_step)

    dev = torch.device("cuda", 0)
    cfg = default_config(tile_w=tile, tile_h=tile, model_name=model_name,
                         arch_encoder=arch_encoder)
    state, _ = setup_ynet(cfg, dev)
    step = make_hybrid_train_step(state.model, cfg)
    r = np.random.RandomState(0)
    task = np.arange(batch) % 4
    host = {"image": r.randint(0, 256, (batch, tile, tile, 3)).astype(
                np.uint8),
            "seg_label": r.randint(0, cfg.num_classes,
                                   (batch, tile, tile)).astype(np.int32),
            "cls_label": np.where(task == 0, 1, -1).astype(np.int32),
            "reg_label": r.rand(batch).astype(np.float32),
            "is_cls": (task == 0).astype(np.float32),
            "is_reg": (task == 2).astype(np.float32),
            "is_seg": (task % 2 == 1).astype(np.float32)}
    b = make_preprocess(cfg)({k: torch.from_numpy(v).to(dev)
                              for k, v in host.items()},
                             torch.Generator(device=dev).manual_seed(0))
    for _ in range(3):
        step(state, b)
    torch.cuda.synchronize()
    step_ms = _events_ms(lambda: step(state, b), iters)

    def forward():
        with torch.no_grad(), autocast(cfg, dev):
            state.model(b["image"].permute(0, 3, 1, 2))

    forward_ms = _events_ms(forward, iters)
    torch.cuda.reset_peak_memory_stats()
    step(state, b)
    torch.cuda.synchronize()
    peak = profiling.device_memory_stats()["peak_bytes_in_use"]

    with profiling.trace(None) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step(state, b)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_class = {c: 0.0 for c, _ in CLASSES}
    by_class["other"] = 0.0
    top = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3 / iters
        by_class[_classify(ev.key)] += ms
        top.append((ms, ev.key[:60]))
    kernel_ms = sum(by_class.values())
    return {
        "model_name": model_name, "arch_encoder": arch_encoder,
        "batch": batch, "tile": tile, "step_ms": step_ms,
        "patches_per_sec": batch / step_ms * 1e3, "forward_ms": forward_ms,
        "wall_ms_per_step": wall_ms / iters, "kernel_ms_per_step": kernel_ms,
        "busy_share": kernel_ms / (wall_ms / iters) if wall_ms else None,
        "kernel_ms_by_class": by_class, "top_kernels":
            sorted(top, reverse=True)[:8],
        "peak_memory_gb": peak / 1e9, "device": torch.cuda.get_device_name(0),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=30)
    p.add_argument("--tile", type=int, default=512)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--model_name", default="Unet", choices=KNOWN_MODELS)
    p.add_argument("--arch_encoder", default="resnet18",
                   choices=KNOWN_ENCODERS)
    ns = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(profile_step(ns.batch, ns.tile, ns.iters,
                                  ns.model_name, ns.arch_encoder)),
          flush=True)


if __name__ == "__main__":
    main()
