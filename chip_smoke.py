"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the serving path from ``wsiseg_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, drives
``python -m wsiseg_tpu_torch eval-tumorbed`` end to end, compares a small
slide's labels between the kernel path (GPU) and the plain path (CPU),
and serves three bench-geometry slides (4096×3072 at level 2, resnet18
Unet, 4 classes, bf16) through ``predict_tumorbed``. Weights are random,
drawn from a seeded ``torch.Generator``.

Prints one line per phase, then a JSON line of per-kernel results, the
card's ``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero, without that line, on
any failure or when no CUDA device is present. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from PIL import Image

BENCH_HW = (3072, 4096)          # level-2 (H, W) of the bench geometry
RAGGED_HW = (96, 256)
GROUP = 4                        # slides per stem launch in the group case
STEM_TOL = 2.0 ** -7             # one bf16 ulp, relative


def level2_image(height: int, width: int, seed: int) -> np.ndarray:
    """Tissue-like level-2 image with dense foreground (bench.py's
    synthetic slide: 40 purple blobs on 244-white plus ±15 noise)."""
    rng = np.random.RandomState(seed)
    img = np.full((height, width, 3), 244, dtype=np.uint8)
    for _ in range(40):
        cy, cx = rng.randint(0, height), rng.randint(0, width)
        ry = rng.randint(height // 12, height // 4)
        rx = rng.randint(width // 12, width // 4)
        y0, y1 = max(0, cy - ry), min(height, cy + ry + 1)
        x0, x1 = max(0, cx - rx), min(width, cx + rx + 1)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        blob = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0
        color = np.array([120 + rng.randint(-30, 30),
                          40 + rng.randint(-20, 40),
                          150 + rng.randint(-30, 40)])
        img[y0:y1, x0:x1][blob] = np.clip(color, 0, 255).astype(np.uint8)
    noise = rng.randint(-15, 15, size=img.shape).astype(np.int16)
    return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def cuda_ms(fn, iters: int = 20) -> float:
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


def phase_identify() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[1] card: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)
    return smi


def phase_build() -> None:
    from wsiseg_tpu_torch.ops import stem
    t0 = time.time()
    lib = stem.build_library()
    stem._library()
    print(f"[2] built {lib.name} in {time.time() - t0:.2f} s", flush=True)


def phase_stem(dev) -> dict:
    """K1 against its plain version on the card: one bench-geometry slide,
    a group of GROUP different slides in one launch, and a ragged size."""
    from wsiseg_tpu.config import default_config
    from wsiseg_tpu_torch.ops import stem

    cfg = default_config()
    r = np.random.RandomState(0)
    kernel = torch.from_numpy(r.randn(64, 3, 7, 7).astype(np.float32) * 0.05)
    vecs = [torch.from_numpy(v.astype(np.float32)) for v in (
        r.rand(64) + 0.5, r.randn(64) * 0.1, r.randn(64) * 0.1,
        r.rand(64) + 0.5)]
    w, b = stem.fold_stem_weights(kernel.to(dev), *(v.to(dev) for v in vecs),
                                  cfg.dataset_mean, cfg.dataset_std)
    pad = stem.pad_value(cfg.dataset_mean)
    out = {}
    # the group is what one launch gets under the CLI's default
    # --slides_in_flight 4
    group = [level2_image(*BENCH_HW, seed=1 + k) for k in range(GROUP)]
    cases = {
        "bench": group[:1],
        "bench_group": group,
        "ragged": [r.randint(0, 256, (*RAGGED_HW, 3)).astype(np.uint8)],
    }
    for name, imgs in cases.items():
        x = torch.from_numpy(np.stack(imgs)).to(dev)
        n, h, wd = x.shape[:3]
        got = stem.stem_pool_conv(x, w, b, pad)
        ref = stem.stem_pool_conv_ref(x, w, b, pad)
        torch.cuda.synchronize()
        err = 0.0
        for g, rf in zip(got, ref):
            g, rf = g.float(), rf.float()
            amax = rf.abs().max().item()
            torch.testing.assert_close(g, rf, rtol=STEM_TOL,
                                       atol=STEM_TOL * amax)
            err = max(err, (g - rf).abs().max().item())
        ms = cuda_ms(lambda: stem.stem_pool_conv(x, w, b, pad))
        plain_ms = cuda_ms(lambda: stem.stem_pool_conv_ref(x, w, b, pad))
        print(f"[3] stem {name} {n}x{h}x{wd}: max|d| {err:.6g} (tol "
              f"{STEM_TOL:.6g}·max|ref|), kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms", flush=True)
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return out


def phase_cli(dev, tmp: str) -> int:
    """The eval-tumorbed CLI on two .npy slides, then the GPU (kernel)
    vs CPU (plain) labels of one of them."""
    from wsiseg_tpu.config import default_config
    from wsiseg_tpu.slides import ArraySlide
    from wsiseg_tpu_torch.__main__ import main
    from wsiseg_tpu_torch.data.wsi_tiles import plan_slide
    from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
    from wsiseg_tpu_torch.models.ynet import init_ynet
    from wsiseg_tpu_torch.ops import stem
    from wsiseg_tpu_torch.train.state import save_checkpoint

    # 256-px tiles: the reference tile grid (which only sets num_tiles
    # here) needs tiles smaller than the 512×384 level-2 image
    cfg = default_config(tile_w=256, tile_h=256)
    slides_dir = os.path.join(tmp, "slides")
    os.makedirs(slides_dir)
    for k in range(2):
        l2 = level2_image(384, 512, seed=10 + k)
        np.save(os.path.join(slides_dir, f"s{k}.npy"),
                np.repeat(np.repeat(l2, 16, axis=0), 16, axis=1))
    ckpt = os.path.join(tmp, "ckpt")
    model = init_ynet(cfg, torch.Generator().manual_seed(0))
    save_checkpoint(model, ckpt, cfg.arch_encoder, 0)
    out_dir = os.path.join(tmp, "out")

    stem.LAUNCHES = 0
    res = main(["eval-tumorbed", "--raw_val_pth", slides_dir,
                "--eval_model_pth", ckpt, "--val_save_pth", out_dir,
                "--wsi_mask_pth", "", "--tile_w", "256", "--tile_h", "256"])
    launches = stem.LAUNCHES
    assert launches > 0, "CLI run never launched the stem kernel"
    assert sorted(res) == ["s0.npy", "s1.npy"], sorted(res)
    for rec in res.values():
        hm = np.asarray(Image.open(rec["heatmap"]))
        assert hm.shape == (384, 512), hm.shape
        assert np.asarray(Image.open(rec["overlay"])).shape == (384, 512, 3)

    slide = ArraySlide(np.load(os.path.join(slides_dir, "s0.npy")))
    plan = plan_slide("s0", slide, cfg)
    gpu = DenseInferenceEngine(model, cfg, device=dev).predict_slide_fcn(plan)
    cpu_model = init_ynet(cfg, torch.Generator().manual_seed(0))
    cpu = DenseInferenceEngine(cpu_model, cfg,
                               device="cpu").predict_slide_fcn(plan)
    agree = float((gpu.labels == cpu.labels).mean())
    heat_ok = float((np.abs(gpu.heatmap - cpu.heatmap)
                     <= 2 / 255 + 1e-6).mean())
    print(f"[4] CLI: 2 slides, heatmaps (384, 512), {launches} stem "
          f"launches; GPU-vs-CPU labels agree {agree:.6f}, heat "
          f"|d|<=2/255 on {heat_ok:.6f}", flush=True)
    assert agree >= 0.99, agree
    assert heat_ok >= 0.99, heat_ok
    return launches


def phase_serve(dev, tmp: str) -> int:
    """predict_tumorbed on three bench-geometry slides, two in flight."""
    from wsiseg_tpu.config import default_config
    from wsiseg_tpu.slides import VirtualPyramidSlide
    from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection
    from wsiseg_tpu_torch.infer import writers
    from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
    from wsiseg_tpu_torch.infer.evaluators import predict_tumorbed
    from wsiseg_tpu_torch.models.ynet import init_ynet
    from wsiseg_tpu_torch.ops import stem

    h, w = BENCH_HW
    cfg = default_config(val_save_pth=os.path.join(tmp, "serve"),
                         wsi_mask_pth="")
    images = [level2_image(h, w, seed=20 + k) for k in range(3)]
    slides = [(f"bench{k}", VirtualPyramidSlide({2: img}, num_levels=3))
              for k, img in enumerate(images)]
    coll = SlideCollection(slides, cfg)
    assert len(coll) == 3
    engine = DenseInferenceEngine(
        init_ynet(cfg, torch.Generator().manual_seed(0)), cfg, device=dev)
    engine.slides_in_flight = 2

    stem.LAUNCHES = 0
    t0 = time.time()
    res = predict_tumorbed(engine, coll, ep=0, log=lambda s: None)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = stem.LAUNCHES
    assert launches > 0, "serving never launched the stem kernel"
    means = []
    for rec in res.values():
        hm = np.asarray(Image.open(rec["heatmap"]))
        assert hm.shape == (h, w), hm.shape
        assert np.isfinite(rec["seconds"]) and rec["seconds"] > 0
        means.append(float(hm.mean()))
    # the evaluator's PNG writers alone, on one served heatmap
    t0 = time.time()
    writers.save_heatmap(cfg, "png", "bench", hm / 255.0)
    writers.save_overlay(cfg, "png", "bench", images[-1], hm / 255.0)
    png_s = time.time() - t0
    plan = next(iter(coll.items()))[1]
    one = engine.device_throughput(plan, mode="fcn", iters=3)
    two = engine.device_throughput(plan, mode="fcn", iters=3,
                                   slides_in_flight=2)
    print(f"[5] served 3 slides {w}x{h} in {wall:.3f} s "
          f"({wall / 3:.4f} s/slide incl. first-call set-up; per-slide "
          f"{[round(r['seconds'], 4) for r in res.values()]}), stem "
          f"launches {launches}, mean heat u8 {[round(m, 3) for m in means]}"
          f"; PNG writers {png_s:.4f} s/slide"
          f"; device_throughput fcn: 1 slide {one['sec_per_slide']:.5f} "
          f"s/slide ({one['patches_per_sec']:.1f} p/s), 2 in flight "
          f"{two['sec_per_slide']:.5f} s/slide "
          f"({two['patches_per_sec']:.1f} p/s)", flush=True)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs an NVIDIA GPU")
    import wsiseg_tpu_torch  # noqa: F401  (fails before any output)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = phase_identify()
    phase_build()
    stem_res = phase_stem(dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli(dev, tmp)
        launches = phase_serve(dev, tmp)
    bench = stem_res["bench"]
    print(json.dumps({"kernels": [{
        "name": "stem_pool_conv", "route": "cuda",
        "source": "wsiseg_tpu_torch/csrc/stem.cu",
        "replaces": "wsiseg_tpu/ops/pallas_stem.py:244",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in stem_res.values()),
        "ms": bench["ms"], "plain_ms": bench["plain_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
