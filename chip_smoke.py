"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel from ``wsiseg_tpu_torch/csrc`` (one ``nvcc`` per
source, all started together), prints ptxas's register/spill report of
the TMA/wgmma conv (``csrc/conv3x3_sm90.cu``), the fused chain
(``csrc/conv_chain_sm90.cu``) and the wgmma stem (``csrc/stem_sm90.cu``)
and their ``HGMMA`` (and the convs' ``UTMALDG``) instruction counts from
``cuobjdump -sass``, and holds each kernel
against its plain PyTorch version on the card at the serving path's
shapes and batches and at ragged shapes: the two stem modes (K1
``stem_pool_conv``, K2 ``stem_conv``, ``stem_sm90.cu``; K2 also at a
width with W % 4 == 2), the single conv (K3 ``conv9``, K5
``conv3x3_small``, ``conv3x3_sm90.cu``) and the fused chain (K4
``conv_chain``, ``conv_chain_sm90.cu``, with each group's recompute
factor beside K3's per-layer sum and ``F.conv2d``'s); then the Hopper probes of
``wsiseg_tpu_torch.probes`` (the conv's P2a/P2b, the stem's P1 assembly
forms and P2c pool epilogue) once each against their plain versions, and
timed. Then it drives the port's paths with every launch count set to 0
just before and read just after:

- ``python -m wsiseg_tpu_torch eval-tumorbed`` on two small slides (default
  route), then a small slide's labels and heat, kernels (GPU) against
  plain versions (CPU), on the default and the fold route, and fold
  against default on the GPU;
- ``predict_tumorbed`` on three bench-geometry slides (4096×3072 at level
  2, resnet18 Unet, 4 classes, bf16) on the default route, and on two with
  ``engine.fcn_fold = True``, each with ``device_throughput``;
- the profiling helpers (phase ``[6l]``, ``wsiseg_tpu_torch.utils.
  profiling``) on the default route's engine: ``device_throughput``
  inside ``trace`` (the trace holds K1's ``stem_sm90`` symbol) and
  ``timed``, the allocator's peak within the card, the card's bf16 peak
  from the table, and the analytic FLOPs a slide with the achieved
  TFLOP/s;
- each decoder family (Unet, Linknet, FPN, PSPNet) on the resnet50
  encoder, full width and depth: ``predict_tumorbed`` on two
  bench-geometry slides as one group (one K1 launch), ``device_throughput``
  and peak device memory at 1 and 2 slides in flight, and a 512×384
  slide's labels and heat, kernels (GPU) against plain versions (CPU);
- the grid route (the reference-parity oracle) at the bench geometry:
  ``device_throughput(mode="grid")`` over its 608 tiles, peak device
  memory, one ``predict_tumorbed`` through the evaluator's grid branch,
  and decode_fast's s2d(2) tail against ``YNet.segment`` on one tile
  batch;
- every other route of the engine on a 1024×768 slide (a level-1
  pyramid for scan level 1), GPU against CPU: grid, cls, scan level 1,
  scan_resize 2, chunked and banded FCN, streamed, and
  keep_probs/keep_canvas on the fused route, plain and with
  ``fcn_fold``; on the card streamed equals resident, banded equals
  chunked, and an oversize slide takes the banded route;
- training (phase ``[6g]``), which launches none of the kernels: a
  float64 hybrid step GPU against CPU, the full-width step's time,
  patches/s and peak memory at 512², batch 30, and ``python -m
  wsiseg_tpu_torch train`` host-fed and with ``--device_cache``, each
  resumed with ``--continue_train``;
- the proposal/HR workload (phase ``[6h]``), which launches none of the
  kernels either: SLIC (1024×768 thumbnail of the bench image), k-means
  and label propagation, each GPU against CPU; the resnet18 region
  ensemble in bf16 at batch 30 × 16 × 64², GPU against CPU, and its
  regions/s; ``run_slic_pipeline`` on a virtual pyramid (level 1
  16384×12288) with its wall split and k-means proposals GPU against
  CPU; the ``slic``, ``scannet`` and ``train-hr`` CLIs; a float64 HR
  step GPU against CPU and the full-width bf16 step;
- the preprocess generators and paper tools (phase ``[6i]``), which
  launch none of the kernels: every tool that runs a device op, on the
  card and again with ``--device cpu`` at the reference's settings on a
  4096×3072 level 2 (SLIC mode on 1024×768), the outputs compared file
  by file;
- multi-rank (phase ``[6j]``): at world size 1 over NCCL, slide-parallel
  FCN on a bench-geometry slide (K1) and row-striped FCN, each equal to
  its single-device route; then ranks sharing the card over gloo: the
  dryrun's checks 1–5 on four, and on two the f64 data-parallel hybrid
  step against the single-device step and ``--mesh 2`` epochs of
  ``train-cellularity``, ``train-p``, ``train-ssr`` and ``train-hr``,
  and ``--mesh 1x2`` epochs of ``train`` and ``train-hr``;
- spatial training (phase ``[6k]``), which launches none of the
  kernels: four ranks sharing the card over gloo, on (2, 2) and (1, 4)
  (data, space) meshes, each against the single-device step on the card:
  the f64 sgd hybrid step (resnet18 Unet, 64², batch 4), the f32 step at
  512², batch 4, and 2048² tiles, batch 2, bf16, adam, 3 steps on (1, 4)
  with each rank's peak memory beside the single-device step's;
- ``decode_fold(use_chain=True)`` at bench geometry (the chain kernel);
- ``conv3x3_small`` at its documented head shape (the kernel has no
  caller in the serving path; its phase is its path).

Weights are random, drawn from a seeded ``torch.Generator``.

Prints one line per phase, then a JSON line of per-kernel results, the
card's ``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero, without that line, on
any failure or when no CUDA device is present. Imports nothing of JAX.
"""

from __future__ import annotations

import csv
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from wsiseg_tpu_torch.data.bench_slide import level2_image
from wsiseg_tpu_torch.ops.stitch import gather_tiles, scatter_add_tiles
from wsiseg_tpu_torch.probes import (bound, cuda_ms, stem_cost,
                                     stem_library_call, stem_weights)

BENCH_HW = (3072, 4096)          # level-2 (H, W) of the bench geometry
RAGGED_HW = (96, 256)
GROUP = 4                        # slides per stem launch in the group case
SERVE_IN_FLIGHT = 2              # slides per launch in the serve phases
FAMILIES = ("Unet", "Linknet", "FPN", "PSPNet")
FAMILY_ARCH = "resnet50"
TOL = 2.0 ** -7                  # one bf16 ulp, relative
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)

# the fold decoder's layer groups at 3072×4096: (name, H, W, [Cin, Cout
# per layer...], last layer's ReLU, output dtype)
FOLD_GROUPS = [
    ("block0", 192, 256, [768, 256, 256], True, torch.bfloat16),
    ("block1", 384, 512, [384, 128, 128], True, torch.bfloat16),
    ("block2", 384, 512, [384, 256, 256], True, torch.bfloat16),
    ("block3", 768, 1024, [320, 128, 128], True, torch.bfloat16),
    ("block4+head", 1536, 2048, [32, 64, 64, 16], False, torch.float32),
]
RAGGED_CHAIN = ("ragged", 83, 131, [32, 64, 64, 16], False, torch.float32)
HEAD_SHAPE = (1664, 2176, 64, 16)     # pallas_conv.py's documented shape


def reset_counts() -> None:
    from wsiseg_tpu_torch.ops import conv9, stem
    stem.LAUNCHES = 0
    stem.STEM_CONV_LAUNCHES = 0
    for k in conv9.LAUNCHES:
        conv9.LAUNCHES[k] = 0


def read_counts() -> dict:
    from wsiseg_tpu_torch.ops import conv9, stem
    return {"stem_pool_conv": stem.LAUNCHES,
            "stem_conv": stem.STEM_CONV_LAUNCHES, **conv9.LAUNCHES}


def assert_close(got: torch.Tensor, ref: torch.Tensor) -> float:
    """rtol 2^-7, atol 2^-7·max|ref|; returns max|got - ref|."""
    g, r = got.float(), ref.float()
    torch.testing.assert_close(g, r, rtol=TOL, atol=TOL * r.abs().max().item())
    return (g - r).abs().max().item()


def phase_identify() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[1] card: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)
    return smi


def _cuobjdump() -> str:
    """cuobjdump from the CUDA toolkit, or the copy Triton carries."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    cands = ["/usr/local/cuda/bin/cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec and spec.origin:
        cands.append(os.path.join(os.path.dirname(spec.origin), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError(f"no cuobjdump on PATH or in {cands}")


def sass_counts(lib, kernel: str) -> dict:
    """wgmma (HGMMA) and TMA load (UTMALDG) instructions in the SASS of
    every function of the library whose name contains ``kernel``."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    opcodes = ("HGMMA", "UTMALDG")
    counts, inside = dict.fromkeys(opcodes, 0), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            for op in opcodes:
                counts[op] += bool(re.search(rf"\b{op}\b", line))
    return counts


def ptxas_lines(report: str, kernel: str, tag_re: str, tag_fmt: str) -> list:
    """ptxas -v's registers, spills and shared memory per instantiation
    of ``kernel``, each tagged by its template arguments (``tag_re``'s
    groups into ``tag_fmt``)."""
    out, name, spill = [], None, ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if kernel in line else None
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "registers" in line:
            args = re.search(tag_re, name)
            tag = tag_fmt.format(*args.groups()) if args else name
            out.append(f"{tag}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def phase_build() -> dict:
    from wsiseg_tpu_torch.ops import stem
    t0 = time.time()
    lib = stem.build_library()
    stem._library()
    print(f"[2] built {lib.name} in {time.time() - t0:.2f} s", flush=True)
    for line in ptxas_lines(stem.ptxas_report("conv3x3_sm90"),
                            "conv9_sm90_kernel", r"ILi(\d+)ELb([01])E",
                            "BN={} f32_out={}"):
        print(f"[2] ptxas conv9_sm90_kernel {line}", flush=True)
    counts = sass_counts(lib, "conv9_sm90_kernel")
    print(f"[2] cuobjdump -sass conv9_sm90_kernel (all instantiations): "
          f"{counts}", flush=True)
    assert all(counts.values()), f"conv9_sm90_kernel lacks {counts}"
    for line in ptxas_lines(stem.ptxas_report("conv_chain_sm90"),
                            "conv_chain_sm90_kernel",
                            r"ILi(\d)ELi(\d+)ELi(\d+)ELi(\d)ELb([01])E",
                            "L={} NM={} NL={} MT={} f32_out={}"):
        print(f"[2] ptxas conv_chain_sm90_kernel {line}", flush=True)
        assert "0 bytes spill stores" in line, f"spills: {line}"
    # a wgmma issued under a runtime condition makes ptxas serialise every
    # wgmma of the kernel (C7520), which cost the chain 1.4-1.5x
    serial = {src: [ln for ln in stem.ptxas_report(src).splitlines()
                    if "C7520" in ln or "serialized" in ln]
              for src in ("conv_chain_sm90", "conv3x3_sm90", "stem_sm90")}
    print(f"[2] ptxas notes on serialised wgmma: "
          f"{ {k: len(v) for k, v in serial.items()} }", flush=True)
    assert not serial["conv_chain_sm90"], serial["conv_chain_sm90"][0]
    chain_counts = sass_counts(lib, "conv_chain_sm90_kernel")
    print(f"[2] cuobjdump -sass conv_chain_sm90_kernel (all "
          f"instantiations): {chain_counts}", flush=True)
    assert all(chain_counts.values()), \
        f"conv_chain_sm90_kernel lacks {chain_counts}"
    for line in ptxas_lines(stem.ptxas_report("stem_sm90"),
                            "stem_sm90_kernel", r"ILi(\d)ELb([01])E",
                            "form={} pool={}"):
        print(f"[2] ptxas stem_sm90_kernel {line}", flush=True)
    stem_counts = sass_counts(lib, "stem_sm90_kernel")
    print(f"[2] cuobjdump -sass stem_sm90_kernel (all instantiations): "
          f"{stem_counts}", flush=True)
    assert stem_counts["HGMMA"] > 0, \
        f"stem_sm90_kernel is not on tensor cores: {stem_counts}"
    return counts


def phase_stems(dev) -> dict:
    """K1 and K2 (``stem_sm90.cu``) against their plain versions on the
    card: one bench-geometry slide, a group of GROUP different slides in one
    launch, a ragged size, and for K2 a width with W % 4 == 2."""
    from wsiseg_tpu_torch.ops import stem

    w, b = stem_weights(dev)
    cells = stem.prepare_stem_cells(w)
    pad = stem.pad_value(MEAN)
    r = np.random.RandomState(0)
    # the group is what one launch gets under the CLI's default
    # --slides_in_flight 4
    group = [level2_image(*BENCH_HW, seed=1 + k) for k in range(GROUP)]
    cases = {
        "bench": group[:1],
        "bench_group": group,
        "ragged": [r.randint(0, 256, (*RAGGED_HW, 3)).astype(np.uint8)],
        "w_mod4_2": [r.randint(0, 256, (100, 262, 3)).astype(np.uint8)
                     for _ in range(2)],
    }
    kernels = {"stem_pool_conv": (stem.stem_pool_conv,
                                  stem.stem_pool_conv_ref),
               "stem_conv": (stem.stem_conv, stem.stem_conv_ref)}
    out = {name: {} for name in kernels}
    for case, imgs in cases.items():
        x = torch.from_numpy(np.stack(imgs)).to(dev)
        n, h, wd = x.shape[:3]
        for name, (kern, ref) in kernels.items():
            if case == "w_mod4_2" and name == "stem_pool_conv":
                continue
            got, want = kern(x, w, b, pad, cells), ref(x, w, b, pad)
            torch.cuda.synchronize()
            if name == "stem_conv":
                got, want = [got], [want]
            err = max(assert_close(g, rf) for g, rf in zip(got, want))
            ms = cuda_ms(lambda: kern(x, w, b, pad, cells))
            plain_ms = cuda_ms(lambda: ref(x, w, b, pad))
            lib_ms = cuda_ms(stem_library_call(x, w, b, pad))
            print(f"[3] {name} {case} {n}x{h}x{wd}: max|d| {err:.6g} (tol "
                  f"{TOL:.6g}·max|ref|), kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, F.conv2d {lib_ms:.4f} ms",
                  flush=True)
            out[name][case] = {"max_abs_err": err, "ms": ms,
                               "plain_ms": plain_ms, "library_ms": lib_ms}
    # bound of one bench slide: u8 image in, weights, outputs out
    for name in kernels:
        out[name]["bound"] = bound(*stem_cost(*BENCH_HW,
                                              name == "stem_pool_conv"))
    return out


def _layers(rng, chans, last_relu, dev):
    from wsiseg_tpu_torch.ops import conv9
    layers = []
    for i, (ci, co) in enumerate(zip(chans[:-1], chans[1:])):
        k = torch.from_numpy(rng.randn(3, 3, ci, co).astype(np.float32)
                             * np.sqrt(2.0 / (9 * ci)))
        s = torch.from_numpy(rng.rand(co).astype(np.float32) + 0.5)
        b = torch.from_numpy(rng.randn(co).astype(np.float32) * 0.1)
        w, bb = conv9.prep_layer(k.to(dev), s.to(dev), b.to(dev))
        layers.append((w, bb, True if i + 2 < len(chans) else last_relu))
    return layers


def _conv_library_call(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """The yardstick: one bf16 channels_last ``F.conv2d`` of the same conv
    (+ bias; the ReLU is not in it)."""
    cout, _, cin = w.shape
    xn = x.permute(0, 3, 1, 2)                    # channels_last view
    k = w.view(cout, 3, 3, cin).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    bb = b.to(torch.bfloat16)
    return lambda: F.conv2d(xn, k, bb, padding=1)


def _conv_cost(h, w, chans, out_bytes, n=1):
    """(flops, bytes) of a chain: input read once, weights, last output."""
    flops = sum(2.0 * n * h * w * 9 * ci * co
                for ci, co in zip(chans[:-1], chans[1:]))
    wbytes = sum(9 * ci * co * 2 + co * 4
                 for ci, co in zip(chans[:-1], chans[1:]))
    return flops, n * h * w * chans[0] * 2 + wbytes \
        + n * h * w * chans[-1] * out_bytes


def phase_convs(dev) -> dict:
    """K3 (each fold layer alone), K4 (each fold group as one chain) and
    K5 (the documented head shape) against their plain versions, at bench
    geometry and at a ragged shape, with kernel, plain and F.conv2d
    times; K3 and K4 again on a batch of SERVE_IN_FLIGHT slides per fold
    group, the batch the fold serve phase launches them on."""
    from wsiseg_tpu_torch.ops import conv9

    rng = np.random.RandomState(1)
    acc = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "flops": 0.0, "bytes": 0.0}
           for k in ("conv9", "conv_chain", "conv3x3_small")}

    def add(name, err, ms, plain_ms, lib_ms, cost, bench):
        if bench:
            for k, v in zip(("ms", "plain_ms", "library_ms", "flops",
                             "bytes"), (ms, plain_ms, lib_ms, *cost)):
                acc[name][k] += v
        acc[name]["max_abs_err"] = max(acc[name]["max_abs_err"], err)

    for gname, h, w, chans, last_relu, od in FOLD_GROUPS + [RAGGED_CHAIN]:
        bench = gname != "ragged"
        x = torch.from_numpy(rng.randn(1, h, w, chans[0]).astype(
            np.float32)).to(dev).to(torch.bfloat16)
        layers = _layers(rng, chans, last_relu, dev)
        got = conv9.conv_chain(x, layers, od)
        err = assert_close(got, conv9.conv_chain_ref(x, layers, od))
        ms = cuda_ms(lambda: conv9.conv_chain(x, layers, od))
        plain_ms = cuda_ms(lambda: conv9.conv_chain_ref(x, layers, od))
        lib = [_conv_library_call(
            x if i == 0 else torch.zeros(1, h, w, chans[i], device=dev,
                                         dtype=torch.bfloat16), wl, bl)
            for i, (wl, bl, _) in enumerate(layers)]
        lib_ms = sum(cuda_ms(f) for f in lib)
        cost = _conv_cost(h, w, chans, 4 if od == torch.float32 else 2)
        add("conv_chain", err, ms, plain_ms, lib_ms, cost, bench)
        chain_ms, chain_lib = ms, lib_ms
        print(f"[4] conv_chain {gname} {h}x{w} {chans}: max|d| {err:.6g}, "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, F.conv2d sum "
              f"{lib_ms:.4f} ms, bound "
              f"{bound(*cost)['bound_ms']:.4f} ms", flush=True)
        # K3: each layer alone, on its own input (the group input for the
        # first layer, the chain's bf16 intermediate after that)
        xi, k3_ms = x, 0.0
        for i, (wl, bl, relu) in enumerate(layers):
            last = i + 1 == len(layers)
            odi = od if last else torch.bfloat16
            got = conv9.conv9(xi, wl, bl, relu, odi)
            want = conv9.conv9_ref(xi, wl, bl, relu, odi)
            err = assert_close(got, want)
            ms = cuda_ms(lambda: conv9.conv9(xi, wl, bl, relu, odi))
            plain_ms = cuda_ms(lambda: conv9.conv9_ref(xi, wl, bl, relu, odi))
            lib_ms = cuda_ms(_conv_library_call(xi, wl, bl))
            cost = _conv_cost(h, w, chans[i:i + 2],
                              4 if odi == torch.float32 else 2)
            add("conv9", err, ms, plain_ms, lib_ms, cost, bench)
            k3_ms += ms
            b = bound(*cost)
            print(f"[4] conv9 {gname}.{i} {h}x{w} {chans[i]}->"
                  f"{chans[i + 1]}: max|d| {err:.6g}, kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, F.conv2d {lib_ms:.4f} ms, bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}; kernel at "
                  f"{100 * b['bound_ms'] / ms:.1f} % of it)", flush=True)
            if not last:
                xi = got
        b = bound(*_conv_cost(h, w, chans, 4 if od == torch.float32 else 2))
        factor = conv9.plan_chain(1, h, w, tuple(chans)).recompute
        print(f"[4] group {gname}: conv_chain {chain_ms:.4f} ms, K3 "
              f"per-layer sum {k3_ms:.4f} ms, F.conv2d sum {chain_lib:.4f} "
              f"ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}; chain at "
              f"{100 * b['bound_ms'] / chain_ms:.1f} %), recompute factor "
              f"{factor:.4f}", flush=True)
        if not bench:
            continue
        # the fold serve phase's slide group: SERVE_IN_FLIGHT different
        # slides in one launch of each kernel
        xb = torch.from_numpy(rng.randn(SERVE_IN_FLIGHT, h, w, chans[0])
                              .astype(np.float32)).to(dev).to(torch.bfloat16)
        errs = {"conv_chain": [assert_close(
            conv9.conv_chain(xb, layers, od),
            conv9.conv_chain_ref(xb, layers, od))], "conv9": []}
        for i, (wl, bl, relu) in enumerate(layers):
            odi = od if i + 1 == len(layers) else torch.bfloat16
            got = conv9.conv9(xb, wl, bl, relu, odi)
            errs["conv9"].append(assert_close(
                got, conv9.conv9_ref(xb, wl, bl, relu, odi)))
            xb = got
        for name, e in errs.items():
            add(name, max(e), 0.0, 0.0, 0.0, (0.0, 0.0), False)
        print(f"[4] {gname} at N={SERVE_IN_FLIGHT}: conv_chain max|d| "
              f"{errs['conv_chain'][0]:.6g}, conv9 max|d| per layer "
              f"{[float(f'{e:.6g}') for e in errs['conv9']]}", flush=True)
    for hname, (h, w, ci, co) in (("head", HEAD_SHAPE),
                                   ("ragged", (37, 45, 40, 70))):
        x = torch.from_numpy(rng.randn(1, h, w, ci).astype(np.float32)).to(
            dev).to(torch.bfloat16)
        k = torch.from_numpy(rng.randn(3, 3, ci, co).astype(np.float32)
                             / np.sqrt(9 * ci)).to(dev)
        b = torch.from_numpy(rng.randn(co).astype(np.float32)).to(dev)
        err = assert_close(conv9.conv3x3_small(x, k, b),
                           conv9.conv3x3_small_ref(x, k, b))
        ms = cuda_ms(lambda: conv9.conv3x3_small(x, k, b))
        plain_ms = cuda_ms(lambda: conv9.conv3x3_small_ref(x, k, b))
        w9, b9 = conv9.prep_layer(k, None, b)
        lib_ms = cuda_ms(_conv_library_call(x, w9, b9))
        cost = _conv_cost(h, w, [ci, co], 4)
        add("conv3x3_small", err, ms, plain_ms, lib_ms, cost,
            hname == "head")
        print(f"[4] conv3x3_small {hname} {h}x{w} {ci}->{co}: max|d| "
              f"{err:.6g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"F.conv2d {lib_ms:.4f} ms, bound "
              f"{bound(*cost)['bound_ms']:.4f} ms", flush=True)
    for v in acc.values():
        v.update(bound(v.pop("flops"), v.pop("bytes")))
    return acc


def phase_probes(dev) -> dict:
    """The Hopper probes (csrc/probes.cu) once each against their plain
    versions, then timed at the TPU probes' shapes."""
    from wsiseg_tpu_torch import probes
    return probes.run_probes(
        dev, lambda msg: print(f"[4b] {msg}", flush=True))


def phase_cli(dev, tmp: str) -> None:
    """The eval-tumorbed CLI on two .npy slides, then one slide's labels
    and heat: GPU (kernels) against CPU (plain versions) on the default
    and the fold route, and fold against default on the GPU."""
    from wsiseg_tpu_torch.__main__ import main
    from wsiseg_tpu_torch.config import default_config
    from wsiseg_tpu_torch.data.wsi_tiles import plan_slide
    from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
    from wsiseg_tpu_torch.models.ynet import init_ynet
    from wsiseg_tpu_torch.slides import ArraySlide
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

    reset_counts()
    res = main(["eval-tumorbed", "--raw_val_pth", slides_dir,
                "--eval_model_pth", ckpt, "--val_save_pth", out_dir,
                "--wsi_mask_pth", "", "--tile_w", "256", "--tile_h", "256"])
    launches = read_counts()["stem_pool_conv"]
    assert launches > 0, "CLI run never launched the stem kernel"
    assert sorted(res) == ["s0.npy", "s1.npy"], sorted(res)
    for rec in res.values():
        hm = np.asarray(Image.open(rec["heatmap"]))
        assert hm.shape == (384, 512), hm.shape
        assert np.asarray(Image.open(rec["overlay"])).shape == (384, 512, 3)

    slide = ArraySlide(np.load(os.path.join(slides_dir, "s0.npy")))
    plan = plan_slide("s0", slide, cfg)
    gpu = DenseInferenceEngine(model, cfg, device=dev)
    cpu = DenseInferenceEngine(init_ynet(cfg, torch.Generator().manual_seed(
        0)), cfg, device="cpu")
    out = {}
    for route in ("default", "fold"):
        gpu.fcn_fold = cpu.fcn_fold = route == "fold"
        out[route] = gpu.predict_slide_fcn(plan), cpu.predict_slide_fcn(plan)

    def agree(a, b):
        return (float((a.labels == b.labels).mean()),
                float((np.abs(a.heatmap - b.heatmap) <= 2 / 255 + 1e-6)
                      .mean()))

    pairs = {"default GPU-vs-CPU": out["default"],
             "fold GPU-vs-CPU": out["fold"],
             "fold-vs-default GPU": (out["fold"][0], out["default"][0])}
    msg = []
    for name, (a, b) in pairs.items():
        lab, heat = agree(a, b)
        msg.append(f"{name} labels {lab:.6f} heat<=2/255 {heat:.6f}")
        assert lab >= 0.99 and heat >= 0.99, (name, lab, heat)
    print(f"[5] CLI: 2 slides, heatmaps (384, 512), {launches} stem "
          f"launches; " + "; ".join(msg), flush=True)


def _eval_limits(gt: np.ndarray) -> dict:
    """GPU-against-CPU limits of ``eval``'s per-slide metrics. Labels
    agree on >= 99 % of the N pixels (phase 5's limit; >= 99.8 % measured
    on these slides), so at most k = 0.01·N flip. A flipped pixel moves
    ``acc`` by at most 1/n_gt (n_gt: GT foreground) and ``iou_fg`` by at
    most 1/n_union <= 1/n_gt; ``s`` = 1 - A/D moves its numerator and
    denominator by at most 3 each, with D >= 1.5·n_gt, so by at most
    4/n_gt while A <= D. The tumor bed is an opening and a hull, not local
    in the labels: ``iou_tb`` gets 0.05."""
    lim = 0.01 * gt.size / max(int((gt > 0).sum()), 1)
    return {"acc": lim, "acc_masked": lim, "iou_fg": lim, "s": 4 * lim,
            "s_masked": 4 * lim, "iou_tb": 0.05}


EVAL_KEYS = ("acc", "s", "acc_masked", "s_masked", "iou_fg", "iou_tb",
             "num_tiles", "seconds", "patches_per_sec")


def _write_gt(pth: str, gt: np.ndarray) -> None:
    """``<slide>_mask.png`` and ``<slide>_tumor_bed.png`` beside a slide,
    as preprocess/mk_gt.py writes them."""
    Image.fromarray(gt).save(pth + "_mask.png")
    Image.fromarray((gt >= 2).astype(np.uint8) * 255).save(
        pth + "_tumor_bed.png")


def phase_eval_cli(dev, tmp: str) -> int:
    """``python -m wsiseg_tpu_torch eval`` on phase 5's two .npy slides
    and checkpoint, with GT rasters from ``SyntheticSlide.ground_truth(2)``
    beside each: K1 launched, every metric key present, half-size color
    masks; then the same slides with ``--device cpu``, each metric within
    ``_eval_limits``. Returns the K1 launches of the card's run."""
    from wsiseg_tpu_torch.__main__ import main
    from wsiseg_tpu_torch.slides import SyntheticSlide

    slides_dir = os.path.join(tmp, "slides")
    names = sorted(f for f in os.listdir(slides_dir) if f.endswith(".npy"))
    limits = {}
    for k, name in enumerate(names):
        gt = SyntheticSlide(width=2048, height=1536, num_levels=3,
                            seed=k).ground_truth(2).astype(np.uint8)
        _write_gt(os.path.join(slides_dir, name), gt)
        limits[name] = _eval_limits(gt)
    args = ["eval", "--raw_val_pth", slides_dir, "--eval_model_pth",
            os.path.join(tmp, "ckpt"), "--wsi_mask_pth", "", "--tile_w",
            "256", "--tile_h", "256"]
    out, secs = {}, {}
    for device, flag in (("cuda", []), ("cpu", ["--device", "cpu"])):
        val = os.path.join(tmp, f"eval_{device}")
        reset_counts()
        t0 = time.time()
        out[device] = main(args + ["--val_save_pth", val] + flag)
        torch.cuda.synchronize()
        secs[device] = time.time() - t0
        if device == "cuda":
            launches = read_counts()["stem_pool_conv"]
            assert launches > 0, "eval never launched the stem kernel"
            for name in names:
                png = np.asarray(Image.open(os.path.join(
                    val, "0", f"{name}_128.png")))
                assert png.shape == (192, 256, 3), png.shape
    gpu, cpu = out["cuda"], out["cpu"]
    assert set(gpu) == set(cpu) == set(names) | {"_mean_tb_iou"}, set(gpu)
    msg = []
    for name in names:
        for key in EVAL_KEYS:
            assert key in gpu[name] and np.isfinite(gpu[name][key]), \
                (name, key)
        d = {k: abs(gpu[name][k] - cpu[name][k]) for k in limits[name]}
        msg.append(f"{name} " + ", ".join(
            f"{k} {gpu[name][k]:.4f}/{cpu[name][k]:.4f} (|d| {v:.4g} <= "
            f"{limits[name][k]:.4g})" for k, v in d.items()))
        bad = {k: v for k, v in d.items() if not v <= limits[name][k]}
        assert not bad, (name, bad, limits[name])
    print(f"[5b] eval CLI: 2 slides, color masks (192, 256, 3), {launches} "
          f"stem launches, GPU {secs['cuda']:.3f} s / CPU {secs['cpu']:.3f} "
          f"s; GPU/CPU: " + "; ".join(msg), flush=True)
    return launches


def phase_serve(dev, tmp: str, fold: bool, n_slides: int):
    """predict_tumorbed on bench-geometry slides, two in flight, on the
    default or the fold route; then device_throughput with 1 and 2 slides
    in flight. Returns the launch counts, the engine and the first slide's
    plan."""
    from wsiseg_tpu_torch.config import default_config
    from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection
    from wsiseg_tpu_torch.infer import writers
    from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
    from wsiseg_tpu_torch.infer.evaluators import predict_tumorbed
    from wsiseg_tpu_torch.models.ynet import init_ynet
    from wsiseg_tpu_torch.slides import VirtualPyramidSlide

    route = "fold" if fold else "default"
    h, w = BENCH_HW
    cfg = default_config(val_save_pth=os.path.join(tmp, f"serve_{route}"),
                         wsi_mask_pth="")
    images = [level2_image(h, w, seed=20 + k) for k in range(n_slides)]
    slides = [(f"bench{k}", VirtualPyramidSlide({2: img}, num_levels=3))
              for k, img in enumerate(images)]
    coll = SlideCollection(slides, cfg)
    assert len(coll) == n_slides
    engine = DenseInferenceEngine(
        init_ynet(cfg, torch.Generator().manual_seed(0)), cfg, device=dev)
    engine.slides_in_flight = SERVE_IN_FLIGHT
    engine.fcn_fold = fold

    reset_counts()
    t0 = time.time()
    res = predict_tumorbed(engine, coll, ep=0, fcn=True,
                               log=lambda s: None)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    if fold:
        assert counts["stem_conv"] > 0, "fold route never launched stem_conv"
        groups = -(-n_slides // SERVE_IN_FLIGHT)
        assert counts["conv9"] == 11 * groups, \
            f"fold route: {counts['conv9']} conv9 launches for {groups} " \
            "slide group(s), not 11 each"
        assert counts["stem_pool_conv"] == 0, counts
    else:
        assert counts["stem_pool_conv"] > 0, \
            "serving never launched the stem kernel"
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    one = engine.device_throughput(plan, mode="fcn", iters=3)
    peak = torch.cuda.max_memory_allocated()
    two = engine.device_throughput(plan, mode="fcn", iters=3,
                                   slides_in_flight=SERVE_IN_FLIGHT)
    print(f"[6] {route} route: served {n_slides} slides {w}x{h} in "
          f"{wall:.3f} s ({wall / n_slides:.4f} s/slide incl. first-call "
          f"set-up; per-slide {[round(r['seconds'], 4) for r in res.values()]}"
          f"), launches {counts}, mean heat u8 "
          f"{[round(m, 3) for m in means]}; PNG writers {png_s:.4f} s/slide"
          f"; device_throughput fcn: 1 slide {one['sec_per_slide']:.5f} "
          f"s/slide ({one['patches_per_sec']:.1f} p/s), 2 in flight "
          f"{two['sec_per_slide']:.5f} s/slide "
          f"({two['patches_per_sec']:.1f} p/s); peak at 1 slide "
          f"{peak / 1e9:.4f} GB = {peak / (h * w):.1f} B per padded px",
          flush=True)
    return counts, engine, plan


def phase_profiling(engine, plan, tmp: str, smi: str) -> int:
    """``wsiseg_tpu_torch.utils.profiling`` on the default route's engine
    and bench-geometry plan (``[6l]``; resnet18 Unet, a 4096×3072 level
    2, bf16): ``device_throughput`` inside ``profiling.trace`` (the
    written trace must hold K1's symbol, and K1 must have launched) and
    inside ``profiling.timed``; the allocator's peak within the card's
    memory; the card found in ``PEAK_TFLOPS``; and the analytic FLOPs of
    one slide over its device seconds, with their share of the table's
    peak (no limit on it). Returns the phase's K1 launches."""
    from wsiseg_tpu_torch.utils import profiling

    t0 = time.time()
    h, w = BENCH_HW
    log_dir = os.path.join(tmp, "trace")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with profiling.trace(log_dir):
        engine.device_throughput(plan, mode="fcn", iters=1)
    in_trace = read_counts()["stem_pool_conv"]
    assert in_trace >= 1, "[6l] K1 never launched inside the trace"
    (path,) = [os.path.join(log_dir, f) for f in os.listdir(log_dir)
               if f.endswith(".pt.trace.json")]
    with open(path) as f:
        trace_text = f.read()
    assert "stem_sm90" in trace_text, "[6l] the trace lacks K1's symbol"
    timed = []
    with profiling.timed("device_throughput", log=timed.append):
        thr = engine.device_throughput(plan, mode="fcn", iters=3)
    launches = read_counts()["stem_pool_conv"]
    mem = profiling.device_memory_stats()
    assert 0 < mem["peak_bytes_in_use"] <= mem["bytes_limit"], mem
    peak = profiling.detect_peak_tflops()
    flops = profiling.dense_forward_flops("resnet18", h, w)
    tflops = flops / thr["sec_per_slide"] / 1e12
    print(f"[6l] profiling: trace {len(trace_text) / 1e6:.2f} MB holds "
          f"stem_sm90 ({in_trace} K1 launches inside); timed "
          f"{timed[0]}; peak {mem['peak_bytes_in_use'] / 1e9:.4f} GB of "
          f"{mem['bytes_limit'] / 1e9:.4f} GB; dense_forward_flops"
          f"('resnet18', {h}, {w}) = {flops:.0f} FLOPs at "
          f"{thr['sec_per_slide']:.5f} device s/slide = {tflops:.4f} "
          f"TFLOP/s, {100 * tflops / peak:.2f} % of the table's "
          f"{peak:.0f} TFLOP/s; [6l] {time.time() - t0:.1f} s | {smi}",
          flush=True)
    return launches


def phase_families(dev, tmp: str) -> int:
    """Each decoder family on the resnet50 encoder (random weights, full
    width and depth): ``predict_tumorbed`` on SERVE_IN_FLIGHT
    bench-geometry slides served as one group — K1 launched once, no other
    kernel — with 3072×4096 heatmaps; ``device_throughput`` and
    ``torch.cuda.max_memory_allocated`` at 1 and SERVE_IN_FLIGHT slides in
    flight; then a 512×384 slide's labels and heat, GPU (kernels) against
    CPU (plain versions). Returns the K1 launches of the serves."""
    from wsiseg_tpu_torch.config import default_config
    from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection, plan_slide
    from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
    from wsiseg_tpu_torch.infer.evaluators import predict_tumorbed
    from wsiseg_tpu_torch.models.ynet import init_ynet
    from wsiseg_tpu_torch.slides import VirtualPyramidSlide

    h, w = BENCH_HW
    images = [level2_image(h, w, seed=40 + k) for k in range(SERVE_IN_FLIGHT)]
    small = VirtualPyramidSlide({2: level2_image(384, 512, seed=12)},
                                num_levels=3)
    launches = 0
    for family in FAMILIES:
        cfg = default_config(
            val_save_pth=os.path.join(tmp, f"family_{family}"),
            wsi_mask_pth="", model_name=family, arch_encoder=FAMILY_ARCH,
            tile_w=256, tile_h=256)
        engine = DenseInferenceEngine(
            init_ynet(cfg, torch.Generator().manual_seed(0)), cfg, device=dev)
        engine.slides_in_flight = SERVE_IN_FLIGHT
        coll = SlideCollection(
            [(f"{family}{k}", VirtualPyramidSlide({2: img}, num_levels=3))
             for k, img in enumerate(images)], cfg)
        reset_counts()
        t0 = time.time()
        res = predict_tumorbed(engine, coll, ep=0, fcn=True,
                                   log=lambda s: None)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts()
        assert counts["stem_pool_conv"] == 1 and sum(counts.values()) == 1, \
            f"{family}: one slide group must launch K1 once, got {counts}"
        launches += counts["stem_pool_conv"]
        for rec in res.values():
            hm = np.asarray(Image.open(rec["heatmap"]))
            assert hm.shape == (h, w), hm.shape
        plan = next(iter(coll.items()))[1]
        tput = {}
        for nsf in (1, SERVE_IN_FLIGHT):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            sec = engine.device_throughput(plan, mode="fcn", iters=3,
                                           slides_in_flight=nsf)[
                "sec_per_slide"]
            tput[nsf] = (sec, torch.cuda.max_memory_allocated() / 1e9)
        cpu = DenseInferenceEngine(
            init_ynet(cfg, torch.Generator().manual_seed(0)), cfg,
            device="cpu")
        splan = plan_slide("small", small, cfg)
        a, b = engine.predict_slide_fcn(splan), cpu.predict_slide_fcn(splan)
        lab = float((a.labels == b.labels).mean())
        heat = float((np.abs(a.heatmap - b.heatmap) <= 2 / 255 + 1e-6)
                     .mean())
        print(f"[6b] family {family} {FAMILY_ARCH}: served {len(res)} slides "
              f"{w}x{h} in {wall:.3f} s, launches {counts}; "
              f"device_throughput fcn: " + ", ".join(
                  f"{n} in flight {sec:.5f} s/slide, peak {gb:.4f} GB"
                  for n, (sec, gb) in tput.items())
              + f" ({tput[1][1] * 1e9 / (h * w):.1f} B per padded px at "
              f"1 slide); 512x384 GPU-vs-CPU labels {lab:.6f} heat<=2/255 "
              f"{heat:.6f}", flush=True)
        assert lab >= 0.99 and heat >= 0.99, (family, lab, heat)
        del engine, cpu
        torch.cuda.empty_cache()
    return launches


def phase_grid(dev, tmp: str, smi: str) -> dict:
    """The grid route, the reference-parity oracle, at the bench geometry
    (resnet18 Unet, 4 classes, bf16): ``device_throughput(mode="grid")``
    on the 4096×3072 slide (608 tiles of 512² at stride 128, batches of
    ``cfg.infer_batch_size``) with the peak device memory around it, and
    one ``predict_tumorbed`` through ``_pipelined_results``' grid branch
    (the evaluator's default). The tile forward is the plain model in the
    compute dtype, as in JAX: no kernel of the port is launched. Then
    decode_fast's s2d(2) tail (``unet_segment_fast``) against
    ``YNet.segment`` on one tile batch, timed."""
    from wsiseg_tpu_torch.config import default_config
    from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection
    from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
    from wsiseg_tpu_torch.infer.evaluators import predict_tumorbed
    from wsiseg_tpu_torch.models.fast_decoder import unet_segment_fast
    from wsiseg_tpu_torch.models.ynet import init_ynet
    from wsiseg_tpu_torch.slides import VirtualPyramidSlide

    h, w = BENCH_HW
    cfg = default_config(val_save_pth=os.path.join(tmp, "grid"),
                         wsi_mask_pth="")
    coll = SlideCollection([("bench_grid", VirtualPyramidSlide(
        {2: level2_image(h, w, seed=20)}, num_levels=3))], cfg)
    plan = coll.plans["bench_grid"]
    engine = DenseInferenceEngine(
        init_ynet(cfg, torch.Generator().manual_seed(0)), cfg, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tp = engine.device_throughput(plan, mode="grid", iters=2)
    peak = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.time()
    res = predict_tumorbed(engine, coll, ep=0, log=lambda s: None)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    assert sum(counts.values()) == 0, \
        f"the grid route runs the plain model, yet launched {counts}"
    rec = res["bench_grid"]
    assert rec["num_tiles"] == len(plan.grid) > 0
    hm = np.asarray(Image.open(rec["heatmap"]))
    assert hm.shape == (h, w), hm.shape
    stages = _grid_stages(engine, plan)
    net, prep = engine._tiles_net()
    bs = cfg.infer_batch_size
    x = torch.randn(bs, 3, cfg.tile_h, cfg.tile_w,
                    generator=torch.Generator().manual_seed(1)).to(
        dev, torch.bfloat16, memory_format=torch.channels_last)
    with torch.no_grad():
        fast = unet_segment_fast(net, prep, x, torch.bfloat16)
        plain = net.segment(x)
        err = (fast - plain).abs().max().item()
        assert err <= 2 ** -4 * plain.abs().max().item(), err
        fast_ms = cuda_ms(lambda: unet_segment_fast(net, prep, x,
                                                    torch.bfloat16), 5)
        seg_ms = cuda_ms(lambda: net.segment(x), 5)
    print(f"[6c] grid route at {w}x{h}: {len(plan.grid)} tiles in batches "
          f"of {bs}; device_throughput grid {tp['sec_per_slide']:.5f} "
          f"s/slide ({tp['patches_per_sec']:.1f} p/s), peak "
          f"{peak:.4f} GB; predict_tumorbed (grid branch) e2e {wall:.3f} "
          f"s/slide (engine {rec['seconds']:.4f} s), mean heat u8 "
          f"{hm.mean():.3f}; launches {counts}; one {bs}x{cfg.tile_h}x"
          f"{cfg.tile_w} bf16 tile batch: unet_segment_fast (decode_fast "
          f"s2d(2) tail) {fast_ms:.3f} ms, YNet.segment {seg_ms:.3f} ms, "
          f"max|d| {err:.4g}; per batch (ms): " + ", ".join(
              f"{k} {v:.3f}" for k, v in stages.items())
          + f" | {smi}", flush=True)
    return counts


def _bench_gt(img: np.ndarray) -> np.ndarray:
    """A class-coded GT raster for a bench-geometry image: the blobs
    (tissue) in classes 1-3 by their colour, the white background 0."""
    tissue = img[..., 1] < 150
    return (tissue * (1 + (img[..., 2] > 160) + (img[..., 0] > 130))
            ).astype(np.uint8)


def _host_ms(fn):
    """(result, ms) of one call, the card synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def phase_eval_full(dev, tmp: str, smi: str) -> int:
    """``predict_wsis`` (what ``eval`` runs per slide) on one
    bench-geometry slide with GT rasters beside it: resnet18 Unet, bf16,
    the FCN route (one K1 launch), every metric key, a half-size color
    mask, the wall seconds and peak device memory. Then the per-slide
    split on the served labels: the engine, the tumor bed's device
    morphology (opening; perimeter and dilation) and host hull,
    ``pred_to_mask``, the color mask's composite and writer, the GT
    loading and the metrics; and ``extract_tumor_bed`` and
    ``pred_to_mask`` (plain and perim) on the card held exactly equal to
    the CPU on the same labels. Returns the K1 launches of the
    ``predict_wsis`` run."""
    from wsiseg_tpu_torch.config import default_config
    from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection
    from wsiseg_tpu_torch.infer import metrics as M
    from wsiseg_tpu_torch.infer import writers
    from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine, \
        extract_tumor_bed
    from wsiseg_tpu_torch.infer.evaluators import _load_gt_artifacts, \
        plan_mask_resized, predict_wsis
    from wsiseg_tpu_torch.models.ynet import init_ynet
    from wsiseg_tpu_torch.ops.hull import convex_hull_image
    from wsiseg_tpu_torch.ops.morphology import bwperim, dilate, opening
    from wsiseg_tpu_torch.ops.threshold import pred_to_mask
    from wsiseg_tpu_torch.slides import VirtualPyramidSlide

    h, w = BENCH_HW
    cfg = default_config(val_save_pth=os.path.join(tmp, "eval_full"),
                         wsi_mask_pth="")
    img = level2_image(h, w, seed=50)
    spath = os.path.join(tmp, "bench_eval")
    _write_gt(spath, _bench_gt(img))
    coll = SlideCollection([("bench_eval", VirtualPyramidSlide(
        {2: img}, num_levels=3), spath)], cfg)
    plan = coll.plans["bench_eval"]
    engine = DenseInferenceEngine(
        init_ynet(cfg, torch.Generator().manual_seed(0)), cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    res = predict_wsis(engine, coll, ep=0, fcn=True, log=lambda s: None)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    assert counts["stem_pool_conv"] == 1 and sum(counts.values()) == 1, \
        counts
    rec = res["bench_eval"]
    for key in EVAL_KEYS:
        assert key in rec and np.isfinite(rec[key]), key
    png = np.asarray(Image.open(os.path.join(
        cfg.val_save_pth, "0", f"bench_eval_{cfg.tile_stride_w}.png")))
    assert png.shape == (h // 2, w // 2, 3), png.shape

    labels = engine.predict_slide_fcn(plan).labels
    lab = torch.from_numpy(labels).to(dev)
    extract_tumor_bed(labels, device=dev)                     # warm-up
    tb, open_ms = _host_ms(lambda: opening((lab >= 2).to(torch.uint8), 20))
    tb_host = tb.cpu().numpy()
    t0 = time.perf_counter()
    filled = convex_hull_image(tb_host)
    hull_ms = 1e3 * (time.perf_counter() - t0)
    _, perim_ms = _host_ms(lambda: dilate(bwperim(torch.tensor(
        filled, device=dev)), 20).cpu())
    (tb_filled, tb_perim), tb_ms = _host_ms(
        lambda: extract_tumor_bed(labels, device=dev))
    rgb_t, p2m_ms = _host_ms(lambda: pred_to_mask(lab, cfg.num_classes))
    mask2 = plan_mask_resized(plan, (h, w))
    t0 = time.perf_counter()
    rgb = mask2[..., None] * rgb_t.cpu().numpy()
    rgb[tb_perim > 0] = [255, 255, 255]
    compose_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    writers.save_color_mask(cfg, "split", "bench_eval", rgb)
    writer_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gts = _load_gt_artifacts(plan, (h, w))
    gt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pm = mask2 * labels
    _ = (M.masked_pixel_accuracy(labels, gts["gt"]),
         M.spie_score(labels, gts["gt"]), M.masked_pixel_accuracy(
             pm, gts["gt"]), M.spie_score(pm, gts["gt"]),
         M.foreground_iou(pm, gts["gt"]), M.iou(tb_filled, gts["tb_gt"]))
    metrics_s = time.perf_counter() - t0

    # the card against the CPU on the same labels: exactly equal
    t0 = time.time()
    cpu_tb = extract_tumor_bed(labels, device="cpu")
    assert (cpu_tb[0] == tb_filled).all() and (cpu_tb[1] == tb_perim).all()
    assert (tb_host == opening(torch.from_numpy(labels >= 2).to(
        torch.uint8), 20).numpy()).all()
    for perim in (False, True):
        g = pred_to_mask(lab, cfg.num_classes, perim=perim).cpu()
        c = pred_to_mask(torch.from_numpy(labels), cfg.num_classes,
                         perim=perim)
        assert torch.equal(g, c), f"pred_to_mask(perim={perim}) differs"
    cpu_s = time.time() - t0
    print(f"[6e] eval (predict_wsis, FCN) at {w}x{h}: {wall:.3f} s/slide "
          f"wall incl. first call, engine {rec['seconds']:.4f} s, peak "
          f"{peak:.4f} GB, launches {counts}; acc {rec['acc']:.4f} s "
          f"{rec['s']:.4f} iou_fg {rec['iou_fg']:.4f} iou_tb "
          f"{rec['iou_tb']:.4f}, tumor bed {int(tb_filled.sum())} px; split "
          f"on the served labels: extract_tumor_bed {tb_ms:.2f} ms = "
          f"opening {open_ms:.2f} ms (device) + hull {hull_ms:.2f} ms "
          f"(host) + perimeter and dilation {perim_ms:.2f} ms (device, with "
          f"H2D/D2H) + transfers; pred_to_mask {p2m_ms:.2f} ms; color mask "
          f"composite {compose_s:.4f} s + writer {writer_s:.4f} s; GT "
          f"loading {gt_s:.4f} s; metrics {metrics_s:.4f} s; GPU == CPU "
          f"exactly for extract_tumor_bed and pred_to_mask (plain, perim) "
          f"(CPU side {cpu_s:.2f} s) | {smi}", flush=True)
    return counts["stem_pool_conv"]


SPIE_TOL = 2.0 ** -5             # see phase_patch_evals


def phase_patch_evals(dev, tmp: str) -> None:
    """``python -m wsiseg_tpu_torch eval-spie`` on four patch TIFs (resnet18
    Unet, random weights, tile 512, bf16) on the card and with ``--device
    cpu``,
    then ``predict_reg`` and ``predict_cls`` on one batch of four 512²
    patches on both. The patch net is the plain model in the compute
    dtype (no kernel of the port). bf16 limit: each prediction and logit
    within SPIE_TOL·max(1, |CPU|): four bf16 ulps at magnitude 1
    (2^-7 each), for two bf16 paths (cuDNN, the CPU's convs) that round
    each of ~20 layers apart and meet again in one GAP and two dense
    layers. Classes must be equal where the CPU's top-2 logit margin
    exceeds twice the limit."""
    import contextlib

    from wsiseg_tpu_torch.__main__ import main
    from wsiseg_tpu_torch.config import default_config
    from wsiseg_tpu_torch.infer import evaluators
    from wsiseg_tpu_torch.models.ynet import init_ynet
    from wsiseg_tpu_torch.train.state import save_checkpoint

    rng = np.random.RandomState(60)
    root = os.path.join(tmp, "spie")
    patches = os.path.join(root, "patches")
    os.makedirs(patches)
    src = level2_image(1024, 1024, seed=61)
    rows = ["slide,rid,y"]
    for k in range(4):
        y, x = rng.randint(0, 400, 2)
        Image.fromarray(src[y:y + 600, x:x + 560]).save(
            os.path.join(patches, f"{90 + k // 2}_{1 + k % 2}.tif"))
        rows.append(f"{90 + k // 2},{1 + k % 2},0.5")
    csv_pth = os.path.join(root, "labels.csv")
    with open(csv_pth, "w") as f:
        f.write("\n".join(rows))
    # random weights regress to about -0.85 here: the output bias moves
    # the predictions into [0, 1], where the CSV's clamp does not hide them
    cfg = default_config()
    model = init_ynet(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.regressor.fc[-1].bias += 1.3
    ckpt = os.path.join(root, "ckpt")
    save_checkpoint(model, ckpt, cfg.arch_encoder, 0)
    args = ["eval-spie", "--patch_folder", patches, "--label_csv_path",
            csv_pth, "--eval_model_pth", ckpt]
    preds, secs = {}, {}
    for device, flag in (("cuda", []), ("cpu", ["--device", "cpu"])):
        d = os.path.join(root, device)
        os.makedirs(d)
        reset_counts()
        t0 = time.time()
        with contextlib.chdir(d):
            pth = main(args + flag)
        secs[device] = time.time() - t0
        assert sum(read_counts().values()) == 0
        with open(os.path.join(d, pth)) as f:
            preds[device] = [(r["slide"], r["rid"], float(r["p"]))
                             for r in csv.DictReader(f)]
    g, c = preds["cuda"], preds["cpu"]
    assert [r[:2] for r in g] == [r[:2] for r in c] and len(g) == 4
    d_spie = max(abs(a[2] - b[2]) / max(1.0, abs(b[2]))
                 for a, b in zip(g, c))
    assert d_spie <= SPIE_TOL, (g, c)
    assert any(0.0 < r[2] < 1.0 for r in c), f"every prediction clamped: {c}"

    batch = {"image": np.stack([src[y:y + 512, x:x + 512] for y, x in
                                rng.randint(0, 512, (4, 2))]),
             "cls_label": np.arange(4) % cfg.num_classes,
             "reg_label": rng.rand(4).astype(np.float32),
             "is_cls": np.ones(4, np.float32),
             "is_reg": np.ones(4, np.float32)}
    reps, vals = {}, {}
    for key, device in (("card", dev), ("cpu", "cpu")):
        net = evaluators.PatchNet(model, cfg, device)
        vals[key] = (net.regress_tta(batch["image"]).float().cpu(),
                     net.class_logits(batch["image"]).float().cpu())
        reps[key] = (
            evaluators.predict_reg(model, cfg, [batch], device=device,
                                   log=lambda s: None),
            evaluators.predict_cls(model, cfg, [batch], device=device,
                                   log=lambda s: None))
    (rg, lg), (rc, lc) = vals["card"], vals["cpu"]
    d_reg = ((rg - rc).abs() / rc.abs().clamp(min=1)).max().item()
    d_cls = ((lg - lc).abs() / lc.abs().clamp(min=1)).max().item()
    top2 = lc.topk(2, dim=1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * SPIE_TOL * lc.abs().amax(
        dim=1).clamp(min=1)
    same = (lg.argmax(1) == lc.argmax(1))[sure]
    assert d_reg <= SPIE_TOL and d_cls <= SPIE_TOL and bool(same.all()), \
        (d_reg, d_cls, lg, lc)
    print(f"[6f] eval-spie: 4 TIFs, GPU {secs['cuda']:.3f} s / CPU "
          f"{secs['cpu']:.3f} s, p GPU {[round(r[2], 5) for r in g]} CPU "
          f"{[round(r[2], 5) for r in c]}, max rel |d| {d_spie:.4g}; one "
          f"4x512x512 batch: TTA regression max rel |d| {d_reg:.4g}, "
          f"classifier logits max rel |d| {d_cls:.4g} (limit "
          f"{SPIE_TOL:.4g}), classes equal on {int(same.sum())}/"
          f"{int(sure.sum())} decided samples; predict_reg GPU "
          f"{reps['card'][0]} CPU {reps['cpu'][0]}; predict_cls acc GPU "
          f"{reps['card'][1]['acc']} CPU {reps['cpu'][1]['acc']}; no port "
          f"kernel launched (plain model)", flush=True)


TRAIN_REL = 1e-9                 # × max(1, |CPU|), float64 both sides
TRAIN_HW = 512                   # the trainers' tile (Config defaults)
TRAIN_BATCH = 30


def _train_batch(rng, b: int, hw: int, nc: int) -> dict:
    """A hybrid batch of u8 images and one task per row (cls, seg, reg,
    seg, ...) as numpy, the PatchDataset's form."""
    task = np.arange(b) % 4
    return {"image": rng.randint(0, 256, (b, hw, hw, 3)).astype(np.uint8),
            "seg_label": rng.randint(0, nc, (b, hw, hw)).astype(np.int32),
            "cls_label": np.where(task == 0, rng.randint(0, nc, b),
                                  -1).astype(np.int32),
            "reg_label": np.where(task == 2, rng.rand(b), 0).astype(
                np.float32),
            "is_cls": (task == 0).astype(np.float32),
            "is_reg": (task == 2).astype(np.float32),
            "is_seg": (task % 2 == 1).astype(np.float32)}


def _train_store(root: str, n: int, hw: int, nc: int) -> str:
    """A gt.npy store of n patches at hw², cls, seg (mask PNG) and reg
    rows in turn."""
    from wsiseg_tpu_torch.data import metadata as md
    rng = np.random.RandomState(70)
    src = level2_image(1024, 1024, seed=71)
    os.makedirs(root)
    store = {}
    for i in range(n):
        y, x = rng.randint(0, 1024 - hw, 2)
        ipth = os.path.join(root, f"p{i}.png")
        Image.fromarray(src[y:y + hw, x:x + hw]).save(ipth)
        if i % 3 == 0:
            label = int(rng.randint(0, nc))
        elif i % 3 == 1:
            label = os.path.join(root, f"m{i}.png")
            Image.fromarray(rng.randint(0, nc, (hw // 8, hw // 8)).astype(
                np.uint8).repeat(8, 0).repeat(8, 1)).save(label)
        else:
            label = float(rng.rand())
        md.add_patch(store, "synthetic", i, ipth, label)
    md.save_store(store, root)
    return root


def phase_train(dev, tmp: str, smi: str) -> dict:
    """Training, which launches none of the port's kernels (JAX's reaches
    no Pallas kernel either; K1/K2 fold inference BatchNorm into the conv,
    which train mode must not do): every launch count is 0 before the
    phase and still 0 after it.

    1. One float64 hybrid step (sgd) of the full-depth resnet18 Unet at
       64², batch 4, from the same seeded weights and batch, on the card
       and on the CPU: the loss and every parameter and running statistic
       within TRAIN_REL·max(1, |CPU|).
    2. Full width: resnet18 Unet at 512², batch 30, bf16 autocast, adam,
       on a batch resident on the card: 3 warm-up steps, 10 timed
       (synchronized wall time); ms per step, patches/s, peak memory.
    3. ``python -m wsiseg_tpu_torch train`` on a 60-patch 512² store for
       2 epochs with checkpoints, resumed for a third with
       ``--continue_train``; again with ``--device_cache``. Each epoch's
       patches/s (host loading included)."""
    from wsiseg_tpu_torch.__main__ import main
    from wsiseg_tpu_torch.cli.common import make_preprocess, setup_ynet
    from wsiseg_tpu_torch.config import default_config
    from wsiseg_tpu_torch.models.ynet import init_ynet
    from wsiseg_tpu_torch.optim import build_optimizer
    from wsiseg_tpu_torch.train.state import TrainState
    from wsiseg_tpu_torch.train.steps import make_hybrid_train_step

    reset_counts()
    t_phase = time.time()
    # 1. GPU against CPU in float64
    cfg64 = default_config(tile_w=64, tile_h=64, compute_dtype="float64",
                           param_dtype="float64", optim="sgd", lr=1e-2)
    host = _train_batch(np.random.RandomState(72), 4, 64, cfg64.num_classes)
    res = []
    for d in (dev, torch.device("cpu")):
        net = init_ynet(cfg64, torch.Generator().manual_seed(3)).double()
        net = net.to(d)
        if d.type == "cuda":
            net = net.to(memory_format=torch.channels_last)
        state = TrainState(net, build_optimizer(cfg64, net.parameters()))
        b = make_preprocess(cfg64, train=False)(
            {k: torch.from_numpy(v).to(d) for k, v in host.items()})
        m = make_hybrid_train_step(net, cfg64)(state, b)
        res.append(({k: float(v) for k, v in m.items()},
                    {k: v.detach().cpu() for k, v in
                     net.state_dict().items()}))
    (mg, sg), (mc, sc) = res
    d64 = max(abs(mg[k] - mc[k]) / max(1.0, abs(mc[k])) for k in mc)
    for k, ref in sc.items():
        if ref.is_floating_point():
            d64 = max(d64, ((sg[k] - ref).abs() / ref.abs().clamp(min=1.0))
                      .max().item())
    assert d64 <= TRAIN_REL, f"f64 train step GPU vs CPU: {d64}"

    # 2. full width, resident batch
    cfg = default_config(model_save_pth=os.path.join(tmp, "unused"))
    state, _ = setup_ynet(cfg, dev)
    step = make_hybrid_train_step(state.model, cfg)
    batch = make_preprocess(cfg)(
        {k: torch.from_numpy(v).to(dev) for k, v in _train_batch(
            np.random.RandomState(73), TRAIN_BATCH, TRAIN_HW,
            cfg.num_classes).items()},
        torch.Generator(device=dev).manual_seed(0))
    losses = [step(state, batch)["loss"] for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    for _ in range(10):
        losses.append(step(state, batch)["loss"])
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) / 10 * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    vals = torch.stack(losses).float().cpu()
    assert torch.isfinite(vals).all(), vals
    del state, step, batch

    # 3. the CLI, host-fed and device-cached, each resumed
    store = _train_store(os.path.join(tmp, "train_store"), 60, TRAIN_HW,
                         cfg.num_classes)
    rates = {}
    for mode, extra in (("host", []), ("cache", ["--device_cache", "true"])):
        ck = os.path.join(tmp, f"train_ck_{mode}")
        args = ["train", "--train_image_pth", store, "--model_save_pth", ck,
                "--train_model_pth", os.path.join(ck, "*"),
                "--raw_val_pth", "", "--save_models", "1"] + extra
        first = main(args + ["--num_epoch", "2"])
        again = main(args + ["--num_epoch", "3", "--continue_train", "true"])
        hist = first.history + again.history
        assert [r["epoch"] for r in hist] == [1, 2, 3], hist
        assert again.state.step == 3 * first.state.step // 2
        assert all(np.isfinite(r["loss"]) for r in hist), hist
        assert os.path.exists(os.path.join(ck, "model_resnet18_3.pt"))
        rates[mode] = [round(r["patches_per_sec"], 3) for r in hist]
    counts = read_counts()
    assert sum(counts.values()) == 0, f"training launched kernels: {counts}"
    out = {"step_ms": step_ms, "patches_per_sec": TRAIN_BATCH / step_ms * 1e3,
           "peak_gb": peak_gb, "f64_rel": d64, "epoch_rates": rates}
    print(f"[6g] train: f64 hybrid step (resnet18 Unet 64x64, batch 4, sgd)"
          f" GPU vs CPU max rel |d| {d64:.4g} (limit {TRAIN_REL:g}); full "
          f"width (resnet18 Unet {TRAIN_HW}x{TRAIN_HW}, batch "
          f"{TRAIN_BATCH}, bf16 autocast, adam, resident batch): "
          f"{step_ms:.3f} ms/step, {out['patches_per_sec']:.1f} patches/s, "
          f"peak {peak_gb:.3f} GB, losses "
          f"{[round(float(v), 4) for v in vals]};"
          f" CLI train 60x{TRAIN_HW}^2 patches, 2 epochs + resume, epoch "
          f"patches/s host-fed {rates['host']}, --device_cache "
          f"{rates['cache']}; 0 kernel launches; {time.time() - t_phase:.1f}"
          f" s | {smi}", flush=True)
    return out


HR_BATCH = 30                    # regions a batch (Config.batch_size)
HR_US = 4                        # thumbnail downscale (slic.py's US)


def _median_ms(fn, n: int) -> float:
    """Median host wall ms of n synchronized calls."""
    return float(np.median([_host_ms(fn)[1] for _ in range(n)]))


def _hr_store(root: str, slide_pth: str, n: int) -> str:
    """An HR region store on a 4096² ``.npy`` slide: n regions of 8
    center and 24 perimeter points at level 2 (classes in turn) and one
    plain 'P' photo, the JAX tests' layout (tests/test_regions_ssr.py)."""
    from wsiseg_tpu_torch.data import metadata as md
    rng = np.random.RandomState(80)
    os.makedirs(root)
    photo = os.path.join(root, "photo.png")
    Image.fromarray(level2_image(1536, 2048, seed=81)).save(photo)
    regions = {}
    for i in range(n):
        x0, y0 = rng.randint(20, 150, 2)
        cnt = np.stack([x0 + rng.randint(10, 70, 8),
                        y0 + rng.randint(10, 70, 8)], 1).astype(np.int64)
        t = np.linspace(0, 2 * np.pi, 24, endpoint=False)
        perim = np.stack([x0 + 40 + 35 * np.cos(t), y0 + 40 + 35 * np.sin(t)],
                         1).astype(np.int64)
        regions[i] = {0: {"cnt_xy": cnt, "perim_xy": perim, "label": i % 4,
                          "wsipath": slide_pth, "scan_level": 2}}
    md.save_store({"P": {0: {0: {"cnt_xy": None, "perim_xy": None,
                                 "label": 1, "wsipath": photo,
                                 "scan_level": None,
                                 "dimensions": (2048, 1536)}}},
                   os.path.basename(slide_pth): regions}, root)
    return root


def _fg_agree(a, b) -> float:
    """|a ∩ b| / max(|a|, |b|) of two (rows, cols) index tuples of one
    4096×3072 image."""
    fa = np.ravel_multi_index(a, (BENCH_HW[0], BENCH_HW[1]))
    fb = np.ravel_multi_index(b, (BENCH_HW[0], BENCH_HW[1]))
    both = np.intersect1d(fa, fb, assume_unique=True).size
    return both / max(fa.size, fb.size, 1)


def phase_hr(dev, tmp: str, smi: str) -> dict:
    """The proposal/HR workload, which launches none of the port's kernels
    (JAX's reaches no Pallas kernel either: SLIC and k-means are jnp
    matmuls, the ensemble's trunk flax convs): every launch count is 0
    before the phase and still 0 after it. Full width: the bench
    geometry's level-2 image (4096×3072) and its 1024×768 SLIC thumbnail
    (200 segments → K = 204 centers, N = 786,432 pixels); the resnet18
    region ensemble on 16 patches of 64² a region, batch 30, bf16.

    a. SLIC on the thumbnail: ms per call on the card (median of 5 after
       a warm-up), peak memory; labels GPU against CPU at full size,
       ≥ 99 % equal.
    b. k-means at ``get_key_points``' cap (16384 points, k = 8): the same
       host seeds, centers within 1e-4·max|c|, labels ≥ 99.9 % equal;
       ``label_propagation`` of the thumbnail's tissue mask, exactly
       equal, with its step count.
    c. The ensemble's bf16 compute copy at batch 30: both outputs GPU
       against CPU within SPIE_TOL·max(1, |CPU|); regions/s on a resident
       batch and from host u8 patches (median of 20, synchronized).
    d. ``run_slic_pipeline`` on a ``VirtualPyramidSlide`` (level 2 the
       bench image, level 1 the same repeated 4× per axis: real level-1
       patch reads): wall split into its parts, proposals, peak memory;
       ``slic_proposals`` with k-means on the CPU from the card's
       upscaled labels: same keys, centers within US_KMEANS px,
       foreground sets ≥ 99 % equal.
    e. ``python -m wsiseg_tpu_torch slic`` and ``scannet`` on a 4096²
       ``.npy`` slide (two PNGs each, classes in range) and ``train-hr``
       on a 61-region store, 2 epochs and a resumed third (regions/s
       per epoch, host reads included).
    f. One float64 sgd HR step GPU against CPU within TRAIN_REL·max(1,
       |CPU|); the full-width bf16 adam step on a resident batch (3
       warm-up steps, 10 timed): ms/step, regions/s, peak memory."""
    import contextlib

    from wsiseg_tpu_torch.__main__ import main
    from wsiseg_tpu_torch.cli import slic_demo
    from wsiseg_tpu_torch.cli.common import (make_hr_apply, make_preprocess,
                                             setup_hr)
    from wsiseg_tpu_torch.config import default_config
    from wsiseg_tpu_torch.models.ensemble import compute_copy, init_ensemble
    from wsiseg_tpu_torch.ops import kmeans
    from wsiseg_tpu_torch.ops.cc import label_propagation_steps
    from wsiseg_tpu_torch.ops.slic import slic
    from wsiseg_tpu_torch.ops.tissue import find_nuclei
    from wsiseg_tpu_torch.optim import build_optimizer
    from wsiseg_tpu_torch.proposals import slic_proposals
    from wsiseg_tpu_torch.slides.reader import VirtualPyramidSlide
    from wsiseg_tpu_torch.train.state import TrainState, save_checkpoint
    from wsiseg_tpu_torch.train.steps import make_hr_train_step

    reset_counts()
    t_phase = time.time()
    cpu = torch.device("cpu")
    hh, ww = BENCH_HW
    l2 = level2_image(hh, ww, seed=90)
    thumb = np.array(Image.fromarray(l2).resize((ww // HR_US, hh // HR_US)))
    th = torch.from_numpy(thumb)
    out = {}

    # a. SLIC
    tg = th.to(dev)
    slic(tg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["slic_ms"] = _median_ms(lambda: slic(tg), 5)
    out["slic_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    lab_g = slic(tg).cpu()
    t0 = time.time()
    lab_c = slic(th)
    out["slic_cpu_s"] = time.time() - t0
    slic_eq = (lab_g == lab_c).float().mean().item()
    assert slic_eq >= 0.99, slic_eq
    print(f"[6h] a. SLIC {ww // HR_US}x{hh // HR_US} (200 segments, K = "
          f"{int(lab_c.max()) + 1}): {out['slic_ms']:.3f} ms/call on the "
          f"card (median of 5), peak {out['slic_peak_gb']:.4f} GB; labels "
          f"GPU vs CPU (full size, CPU {out['slic_cpu_s']:.2f} s) "
          f"{slic_eq:.6f} equal | {smi}", flush=True)

    # b. k-means at the cap, label propagation
    tissue = find_nuclei(th)
    ys, xs = np.nonzero(tissue.numpy())
    pts = np.stack([xs, ys], 1).astype(np.float32)
    pts = pts[np.random.RandomState(0).choice(len(pts), 16384,
                                              replace=False)]
    pc, pg = torch.from_numpy(pts), torch.from_numpy(pts).to(dev)
    seeds_equal = np.array_equal(kmeans.plusplus_init(pg, 8),
                                 kmeans.plusplus_init(pc, 8))
    assert seeds_equal
    cg, lg = kmeans.kmeans(pg, 8)
    cc, lc = kmeans.kmeans(pc, 8)
    km_d = (cg.cpu() - cc).abs().max().item()
    km_eq = (lg.cpu() == lc).float().mean().item()
    assert km_d <= 1e-4 * cc.abs().max().item() and km_eq >= 0.999, \
        (km_d, km_eq)
    out["kmeans_ms"] = _median_ms(lambda: kmeans.kmeans(pg, 8), 5)
    (cc_g, steps_g), cc_ms = _host_ms(
        lambda: label_propagation_steps(tissue.to(dev)))
    cc_c, steps_c = label_propagation_steps(tissue)
    assert steps_g == steps_c and torch.equal(cc_g.cpu(), cc_c)
    print(f"[6h] b. k-means 16384 points, k = 8: seeds GPU == CPU, centers "
          f"max|d| {km_d:.4g} (limit {1e-4 * cc.abs().max().item():.4g}), "
          f"labels {km_eq:.6f} equal, {out['kmeans_ms']:.3f} ms/call on the "
          f"card; label_propagation {ww // HR_US}x{hh // HR_US} tissue "
          f"mask: equal, {steps_g} steps, {cc_ms:.3f} ms on the card",
          flush=True)

    # c. the ensemble, bf16, batch 30
    cfg = default_config()
    model = init_ensemble(cfg, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(91)
    yx = rng.randint(0, hh - 64, (HR_BATCH * 16, 2))
    u8 = np.stack([l2[y:y + 64, x:x + 64] for y, x in yx]).reshape(
        HR_BATCH, 16, 64, 64, 3)
    norm = make_preprocess(cfg, train=False)(
        {"image": torch.from_numpy(u8)})["image"]
    with torch.no_grad():
        net_c = compute_copy(model, torch.bfloat16)
        ref = net_c(norm)
        net_g = compute_copy(model, torch.bfloat16).to(dev)
        ng = norm.to(dev)
        got = net_g(ng)
        ens_d = max(((g.cpu() - r).abs() / r.abs().clamp(min=1.0)).max()
                    .item() for g, r in zip(got, ref))
        assert ens_d <= SPIE_TOL, ens_d
        net_g(ng)
        fwd_ms = _median_ms(lambda: net_g(ng), 20)
    apply = make_hr_apply(model, cfg, dev)
    apply(u8)
    apply_ms = _median_ms(lambda: apply(u8), 20)
    out.update(hr_forward_ms=fwd_ms,
               hr_regions_per_sec=HR_BATCH / fwd_ms * 1e3,
               hr_apply_regions_per_sec=HR_BATCH / apply_ms * 1e3)
    print(f"[6h] c. ensemble resnet18, {HR_BATCH}x16x64x64 bf16: GPU vs CPU "
          f"max rel |d| {ens_d:.4g} (limit {SPIE_TOL:.4g}); resident "
          f"forward {fwd_ms:.3f} ms, {out['hr_regions_per_sec']:.1f} "
          f"regions/s; from host u8 (H2D, normalize) {apply_ms:.3f} ms, "
          f"{out['hr_apply_regions_per_sec']:.1f} regions/s (median of 20)",
          flush=True)
    del net_c, net_g, ng

    # d. run_slic_pipeline end to end
    slide = VirtualPyramidSlide(
        {1: np.repeat(np.repeat(l2, 4, 0), 4, 1), 2: l2}, num_levels=3)
    parts, seen = {}, {}

    def timed(name, fn, sync=False):
        def wrapped(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t
            seen.setdefault(name, (a, r))
            return r
        return wrapped

    forward = slic_demo.make_hr_forward(model, cfg, dev)
    orig = {k: getattr(slic_demo, k) for k in (
        "slic", "slic_proposals", "classify_proposals", "paint_mask_rgb",
        "mark_boundaries")}
    save = Image.Image.save
    try:
        for k, fn in orig.items():
            setattr(slic_demo, k, timed(k, fn, sync=k == "slic"))
        Image.Image.save = timed("png", save)
        with contextlib.chdir(tmp):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            mask = slic_demo.run_slic_pipeline(
                slide, "bench.virtual", cfg,
                timed("ensemble", forward, sync=True), device=dev)
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9
            pngs = [np.asarray(Image.open(f"slic_out{s}.png")).shape
                    for s in ("_mask", "")]
    finally:
        for k, fn in orig.items():
            setattr(slic_demo, k, fn)
        Image.Image.save = save
    (labels_up, *_), meta_g = seen["slic_proposals"]
    assert mask.shape == (hh, ww) and 0 <= mask.min() and mask.max() < 4
    assert pngs == [(hh // HR_US, ww // HR_US, 3), (hh, ww, 3)], pngs
    t0 = time.time()
    meta_c = slic_proposals(labels_up, "bench.virtual", us_kmeans=HR_US,
                            device="cpu")
    cpu_prop_s = time.time() - t0
    assert sorted(meta_g) == sorted(meta_c) and meta_g
    d_cnt = max(np.abs(meta_g[k]["cnt_xy"] - meta_c[k]["cnt_xy"]).max()
                for k in meta_c)
    fg = min(_fg_agree(meta_g[k]["foreground_indices"],
                       meta_c[k]["foreground_indices"]) for k in meta_c)
    assert d_cnt <= slic_demo.US_KMEANS and fg >= 0.99, (d_cnt, fg)
    split = {k: round(v, 3) for k, v in parts.items()}
    split["classify_host"] = round(parts["classify_proposals"]
                                   - parts["ensemble"], 3)
    split["rest"] = round(wall - sum(parts[k] for k in (
        "slic", "slic_proposals", "classify_proposals", "paint_mask_rgb",
        "mark_boundaries", "png")), 3)
    out.update(slic_pipeline_s=wall, slic_pipeline_peak_gb=peak,
               proposals=len(meta_g), slic_pipeline_split=split)
    print(f"[6h] d. run_slic_pipeline, {ww}x{hh} level 2 (level 1 "
          f"{ww * 4}x{hh * 4}): {wall:.3f} s wall, {len(meta_g)} proposals, "
          f"painted classes {sorted(np.unique(mask).tolist())}, peak "
          f"{peak:.4f} GB; split (s): {split}; slic_proposals k-means GPU "
          f"vs CPU (CPU {cpu_prop_s:.2f} s): keys equal, centers max|d| "
          f"{d_cnt} px (limit {slic_demo.US_KMEANS}), foreground sets "
          f">= {fg:.6f} equal | {smi}", flush=True)
    del slide

    # e. the CLIs
    root = os.path.join(tmp, "hr")
    os.makedirs(root)
    small_l2 = level2_image(256, 256, seed=92)
    npy = os.path.join(root, "slide.npy")
    np.save(npy, np.repeat(np.repeat(small_l2, 16, 0), 16, 1))
    gt = np.zeros((256, 256), np.uint8)
    gt[30:102, 40:112] = 2           # bbox > 5 %: split by k-means into
    gt[150:222, 130:202] = 1         # 9-center proposals (the last label
    gt_pth = os.path.join(root, "gt.png")   # is never visited: ROADMAP §3)
    Image.fromarray(gt).save(gt_pth)
    ck = os.path.join(root, "ck")
    shifted = init_ensemble(cfg, torch.Generator().manual_seed(1))
    with torch.no_grad():
        shifted.fc_2.bias[2] += 30.0     # painted proposals show as class 2
    save_checkpoint(shifted, ck, cfg.arch_encoder, 0)
    demo = {}
    for cmd, extra in (("slic", ["--num_segments", "12"]),
                       ("scannet", ["--gt_thumbnail", gt_pth])):
        d = os.path.join(root, cmd)
        os.makedirs(d)
        with contextlib.chdir(d):
            t0 = time.time()
            m = main([cmd, npy, "--eval_model_pth", ck] + extra)
            demo[cmd] = round(time.time() - t0, 3)
            shapes = [np.asarray(Image.open(f"{cmd}_out{s}.png")).shape
                      for s in ("_mask", "")]
        assert shapes == [(64, 64, 3), (256, 256, 3)], (cmd, shapes)
        assert m.min() >= 0 and m.max() < 4 and (m == 2).mean() > 0.05, cmd
    store = _hr_store(os.path.join(root, "store"), npy, 60)
    hr_ck = os.path.join(root, "train_ck")
    args = ["train-hr", "--train_hr_image_pth", store, "--val_hr_image_pth",
            store, "--model_save_pth", hr_ck, "--train_model_pth",
            os.path.join(hr_ck, "*"), "--save_models", "1"]
    first = main(args + ["--num_epoch", "2"])
    again = main(args + ["--num_epoch", "3", "--continue_train", "true"])
    hist = first.history + again.history
    assert [r["epoch"] for r in hist] == [1, 2, 3], hist
    assert again.state.step == 3 * first.state.step // 2
    assert all(np.isfinite(r["loss"]) and 0 <= r["val_acc"] <= 1
               for r in hist), hist
    rates = [round(r["patches_per_sec"], 3) for r in hist]
    out["train_hr_epoch_regions_per_sec"] = rates
    print(f"[6h] e. CLIs on a 4096^2 .npy slide: slic {demo['slic']} s, "
          f"scannet {demo['scannet']} s (both PNGs, classes in range); "
          f"train-hr on 61 regions (60 slide regions + 1 photo), batch "
          f"{HR_BATCH}, 2 epochs + resume: regions/s per epoch {rates}, "
          f"val acc {[round(r['val_acc'], 4) for r in hist]}", flush=True)

    # f. training steps
    cfg64 = default_config(compute_dtype="float64", param_dtype="float64",
                           optim="sgd", lr=1e-2)
    r = np.random.RandomState(93)
    host = {"image": r.randint(0, 256, (2, 16, 32, 32, 3)).astype(np.uint8),
            "cls_label": np.array([3, 1], np.int32)}
    res = []
    for d in (dev, cpu):
        net = init_ensemble(cfg64, torch.Generator().manual_seed(2))
        net = net.double().to(d)
        st = TrainState(net, build_optimizer(cfg64, net.parameters()))
        b = make_preprocess(cfg64, train=False)(
            {k: torch.from_numpy(v).to(d) for k, v in host.items()})
        m = make_hr_train_step(net, cfg64, class_weights=[0.2, 1, 0.5,
                                                          0.7])(st, b)
        res.append(({k: float(v) for k, v in m.items()},
                    {k: v.detach().cpu() for k, v in
                     net.state_dict().items()}))
    (mg, sg), (mc, sc) = res
    d64 = max(abs(mg[k] - mc[k]) / max(1.0, abs(mc[k])) for k in mc)
    for k, v in sc.items():
        if v.is_floating_point():
            d64 = max(d64, ((sg[k] - v).abs() / v.abs().clamp(min=1.0))
                      .max().item())
    assert d64 <= TRAIN_REL, f"f64 HR step GPU vs CPU: {d64}"
    state, _ = setup_hr(cfg.replace(model_save_pth=os.path.join(
        tmp, "unused")), dev)
    step = make_hr_train_step(state.model, cfg, class_weights=[1, 1, 1, 1])
    batch = make_preprocess(cfg)(
        {"image": torch.from_numpy(u8).to(dev),
         "cls_label": torch.arange(HR_BATCH, device=dev) % 4},
        torch.Generator(device=dev).manual_seed(0))
    losses = [step(state, batch)["loss"] for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    for _ in range(10):
        losses.append(step(state, batch)["loss"])
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) / 10 * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    vals = torch.stack(losses).float().cpu()
    assert torch.isfinite(vals).all(), vals
    counts = read_counts()
    assert sum(counts.values()) == 0, f"HR path launched kernels: {counts}"
    out.update(hr_step_ms=step_ms, hr_train_regions_per_sec=HR_BATCH
               / step_ms * 1e3, hr_step_peak_gb=peak_gb, hr_f64_rel=d64)
    print(f"[6h] f. train: f64 sgd HR step (resnet18, 2x16x32x32) GPU vs "
          f"CPU max rel |d| {d64:.4g} (limit {TRAIN_REL:g}); full width "
          f"({HR_BATCH}x16x64x64, bf16 autocast, adam, resident batch): "
          f"{step_ms:.3f} ms/step, {out['hr_train_regions_per_sec']:.1f} "
          f"regions/s, peak {peak_gb:.3f} GB, losses "
          f"{[round(float(v), 4) for v in vals]}; g. 0 kernel launches; "
          f"{time.time() - t_phase:.1f} s | {smi}", flush=True)
    return out


def _grid_stages(engine, plan) -> dict:
    """CUDA-event ms of the grid route's stages on its first full tile
    batch: gather, forward, the sequential adds into the canvas, and the
    slide's postprocess once."""
    cfg = engine.cfg
    img = engine._take(engine.stage_slide(plan))
    xs, ys, _ = engine._pad_grid(plan.grid.xs, plan.grid.ys, engine.batch)
    ys, xs = ys[0], xs[0]
    canvas = torch.zeros(plan.stitch_hw + (cfg.num_classes,),
                         dtype=torch.float32, device=img.device)
    mask = engine._level_mask(plan, plan.canvas_hw)
    with torch.no_grad():
        tiles = gather_tiles(img, ys, xs, cfg.tile_h, cfg.tile_w)
        seg = engine._seg_forward_tiles(tiles)
        return {
            "gather": cuda_ms(lambda: gather_tiles(img, ys, xs, cfg.tile_h,
                                                   cfg.tile_w), 5),
            "forward": cuda_ms(lambda: engine._seg_forward_tiles(tiles), 5),
            "adds": cuda_ms(lambda: scatter_add_tiles(canvas, seg, ys, xs),
                            5),
            "postprocess (slide)": cuda_ms(lambda: engine._postprocess(
                canvas, mask, out_hw=plan.canvas_hw), 5)}


def phase_routes(dev) -> dict:
    """Each route this slice serves, on small slides at full width
    (resnet18 Unet, bf16), the card (kernel path) against the CPU (plain
    path): the grid and cls modes, scan level 1 (grid, and the fused
    route's canvas branch), scan_resize 2, the chunked FCN (chunk 512),
    the banded FCN, the streamed grid, and keep_probs/keep_canvas on the
    fused route plain and with fcn_fold; labels ≥ 99 % equal, heat within
    2/255 on ≥ 99 %. On the card: streamed equals resident, banded equals
    chunked, and a slide padded just over the engine's lowered
    ``fcn_fast_max_px`` takes the banded route. Returns the kernel
    launches of the GPU runs."""
    from wsiseg_tpu_torch.config import default_config
    from wsiseg_tpu_torch.data.wsi_tiles import plan_slide
    from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
    from wsiseg_tpu_torch.models.ynet import init_ynet
    from wsiseg_tpu_torch.slides import SyntheticSlide, VirtualPyramidSlide

    cfg = default_config(wsi_mask_pth="")
    small = VirtualPyramidSlide({2: level2_image(768, 1024, seed=13)},
                                num_levels=3)
    level1 = SyntheticSlide(width=4096, height=3072, num_levels=3, seed=13)

    def pair(mode="seg", fold=False, **kw):
        c = cfg.replace(**kw)
        out = []
        for d in (dev, "cpu"):
            e = DenseInferenceEngine(init_ynet(c, torch.Generator()
                                               .manual_seed(0)), c,
                                     mode=mode, device=d)
            e.fcn_fold = fold
            out.append(e)
        return c, out

    c2, base = pair()
    c1, lvl1 = pair(scan_level=1)
    cr, rsz = pair(scan_resize=2)
    _, cls = pair(mode="cls")
    _, fold = pair(fold=True)
    p2, p1 = plan_slide("small", small, c2), plan_slide("l1", level1, c1)
    pr = plan_slide("small", small, cr)
    keep = dict(keep_probs=True, keep_canvas=True)
    routes = [
        ("grid", base, p2, lambda e, p: e.predict_slide(p), {}),
        ("cls", cls, p2, lambda e, p: e.predict_slide(p), {}),
        ("scan_level=1 grid", lvl1, p1, lambda e, p: e.predict_slide(p),
         {}),
        ("scan_level=1 fcn", lvl1, p1, lambda e, p: e.predict_slide_fcn(p),
         {"stem_pool_conv": 1}),
        ("scan_resize=2", rsz, pr, lambda e, p: e.predict_slide(p), {}),
        ("chunked fcn", base, p2,
         lambda e, p: e.predict_slide_fcn(p, chunk=512), {}),
        ("banded fcn", base, p2,
         lambda e, p: e.predict_slide_fcn_banded(p, chunk=512), {}),
        ("streamed", base, p2, lambda e, p: e.predict_slide_streamed(p), {}),
        ("keep", base, p2, lambda e, p: e.predict_slide_fcn(p, **keep),
         {"stem_pool_conv": 1}),
        ("keep fold", fold, p2, lambda e, p: e.predict_slide_fcn(p, **keep),
         {"stem_conv": 1, "conv9": 11}),
    ]
    launches, gpu_res, msg = {}, {}, []
    for name, (gpu, cpu), plan, run, want in routes:
        reset_counts()
        t0 = time.time()
        a = run(gpu, plan)
        torch.cuda.synchronize()
        ta = time.time() - t0
        counts = {k: v for k, v in read_counts().items() if v}
        assert counts == want, f"{name}: launches {counts}, want {want}"
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        t0 = time.time()
        b = run(cpu, plan)
        tb = time.time() - t0
        assert a.labels.shape == a.heatmap.shape == plan.canvas_hw
        lab = float((a.labels == b.labels).mean())
        heat = float((np.abs(a.heatmap - b.heatmap) <= 2 / 255 + 1e-6)
                     .mean())
        msg.append(f"{name} GPU {ta:.3f} s / CPU {tb:.3f} s labels "
                   f"{lab:.6f} heat<=2/255 {heat:.6f}")
        assert lab >= 0.99 and heat >= 0.99, (name, lab, heat)
        if name.startswith("keep"):
            nc = cfg.num_classes
            assert a.canvas.shape == a.probs.shape == plan.canvas_hw + (nc,)
            assert np.isfinite(a.canvas).all() and np.isfinite(a.probs).all()
            served = gpu.predict_slide_fcn(plan)
            assert (served.labels == a.labels).all(), name
        gpu_res[name] = a
    print("[6d] routes on a 1024x768 slide (level 1: 1024x768 of a "
          "4096x3072 pyramid), GPU against CPU: " + "; ".join(msg),
          flush=True)

    gpu = base[0]
    resident = gpu.predict_slide(p2)
    streamed = gpu_res["streamed"]
    assert (streamed.labels == resident.labels).all()
    dh = float(np.abs(streamed.heatmap - resident.heatmap).max())
    assert dh <= 1e-5, dh
    chunked, banded = gpu_res["chunked fcn"], gpu_res["banded fcn"]
    assert (chunked.labels == banded.labels).all()
    assert (chunked.heatmap == banded.heatmap).all()
    hp, wp = gpu._fcn_fast_dims(*p2.stitch_hw)
    gpu.fcn_fast_max_px = hp * wp - 1
    took, banded_call = [], gpu.predict_slide_fcn_banded
    gpu.predict_slide_fcn_banded = \
        lambda *a, **k: took.append(k) or banded_call(*a, **k)
    reset_counts()
    over = gpu.predict_slide_fcn(p2)
    counts = {k: v for k, v in read_counts().items() if v}
    assert len(took) == 1 and not counts, (took, counts)
    ref = banded_call(p2)
    assert (over.labels == ref.labels).all()
    assert (over.heatmap == ref.heatmap).all()
    print(f"[6d] on the card: streamed == resident (labels equal, heat "
          f"max|d| {dh:.3g}); banded == chunked (chunk 512: labels and "
          f"heat equal); a {wp}x{hp} slide over fcn_fast_max_px "
          f"{hp * wp - 1} took the banded route ({took}), no kernel "
          f"launched; launches {launches}", flush=True)
    return launches


def phase_fold_chain(dev) -> dict:
    """decode_fold(use_chain=True) on one bench-geometry slide's encoder
    features: five conv_chain launches, and the same logits as the conv9
    route within 2^-7·max|ref|."""
    from wsiseg_tpu_torch.config import default_config
    from wsiseg_tpu_torch.models.fast_decoder import decode_fold
    from wsiseg_tpu_torch.models.fast_encoder import encode_stages
    from wsiseg_tpu_torch.models.infer_fast import prepare_fast
    from wsiseg_tpu_torch.models.ynet import init_ynet
    from wsiseg_tpu_torch.ops import stem

    cfg = default_config()
    model = init_ynet(cfg, torch.Generator().manual_seed(0)).to(dev).eval()
    fw = prepare_fast(model, cfg.dataset_mean, cfg.dataset_std,
                      torch.bfloat16, fold=True)
    img = torch.from_numpy(level2_image(*BENCH_HW, seed=30))[None].to(dev)
    with torch.no_grad():
        c1 = stem.stem_conv(img, fw.stem_w, fw.stem_b, fw.pad_rgb,
                            fw.stem_cells)
        feats = encode_stages(fw.enc, None, fw.dtype,
                              c1=c1.permute(0, 3, 1, 2))
        reset_counts()
        chain = decode_fold(fw.fold, feats, fw.dtype, use_chain=True,
                            planar_head=True)
        torch.cuda.synchronize()
        counts = read_counts()
        per_layer = decode_fold(fw.fold, feats, fw.dtype, use_chain=False,
                                planar_head=True)
    assert counts["conv_chain"] == 5, counts
    assert chain.shape == (1, 16, BENCH_HW[0] // 2, BENCH_HW[1] // 2)
    assert torch.isfinite(chain).all()
    err = assert_close(chain, per_layer)
    ms = cuda_ms(lambda: decode_fold(fw.fold, feats, fw.dtype,
                                     use_chain=True, planar_head=True), 5)
    ms9 = cuda_ms(lambda: decode_fold(fw.fold, feats, fw.dtype,
                                      use_chain=False, planar_head=True), 5)
    print(f"[7] decode_fold(use_chain=True) at {BENCH_HW}: launches "
          f"{counts}; vs use_chain=False max|d| {err:.6g}; decode_fold "
          f"{ms:.4f} ms (chain) / {ms9:.4f} ms (conv9)", flush=True)
    return counts


def phase_head(dev) -> dict:
    """conv3x3_small has no caller in the serving path (as in JAX); this
    phase is its path: one call at the documented head shape."""
    from wsiseg_tpu_torch.ops import conv9
    h, w, ci, co = HEAD_SHAPE
    rng = np.random.RandomState(2)
    x = torch.from_numpy(np.abs(rng.randn(1, h, w, ci)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    k = torch.from_numpy(rng.randn(3, 3, ci, co).astype(np.float32)
                         / np.sqrt(9 * ci)).to(dev)
    reset_counts()
    y = conv9.conv3x3_small(x, k)
    torch.cuda.synchronize()
    counts = read_counts()
    assert counts["conv3x3_small"] == 1 and torch.isfinite(y).all()
    print(f"[8] conv3x3_small head {h}x{w} {ci}->{co}: launches {counts}",
          flush=True)
    return counts


TOOLS_SLIC_HW = (768, 1024)      # the SLIC mode's level 2 (see phase_tools)
TOOLS_QUANTIZE = 8               # colours of patch-to-cls's quantization
#: GT polygons of the tools' slide as level-2 boxes (x0, y0, x1, y1) of the
#: bench geometry with their class (1 benign, 2 in situ, 3 invasive): some
#: wider than a 512 tile (k-means-split centered tiles), some smaller
TOOLS_BOXES = [((300, 260, 1400, 1100), 3), ((1800, 400, 2500, 900), 2),
               ((2900, 300, 3300, 700), 3), ((500, 1600, 1200, 2300), 1),
               ((1600, 1700, 3600, 2800), 3), ((3700, 2500, 3950, 2900), 2)]


def _tools_xml(pth: str, scale: float) -> None:
    """An Aperio XML of TOOLS_BOXES as level-0 polygons (level-2 box ×
    16 × ``scale``, for a level 2 ``scale`` × 4096 wide; the first corner
    cut, so hulls and perimeters are not all axis-aligned)."""
    text = {1: "benign", 2: "carcinoma in situ", 3: "invasive carcinoma"}
    regions = []
    for (x0, y0, x1, y1), cls in TOOLS_BOXES:
        x0, y0, x1, y1 = (int(16 * scale * v) for v in (x0, y0, x1, y1))
        cut = (x1 - x0) // 3
        pts = [(x0 + cut, y0), (x1, y0), (x1, y1), (x0, y1), (x0, y0 + cut)]
        regions.append(
            f'<Region Text="{text[cls]}"><Attributes><Attribute Value='
            f'"{text[cls]}"/></Attributes><Vertices>' + "".join(
                f'<Vertex X="{x}" Y="{y}"/>' for x, y in pts)
            + "</Vertices></Region>")
    with open(pth, "w") as f:
        f.write('<?xml version="1.0"?><Annotations MicronsPerPixel="0.25">'
                "<Annotation><Dummy/><Regions>" + "".join(regions)
                + "</Regions></Annotation></Annotations>")


def _same_value(a, b, ra: str, rb: str, where: str) -> None:
    """Equal nested store values; strings under ``ra`` read relative to
    it (against ``rb``), arrays exactly equal in dtype and value."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            _same_value(a[k], b[k], ra, rb, f"{where}[{k!r}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        assert np.array_equal(a, b), where
    elif isinstance(a, str) and a.startswith(ra):
        assert b == rb + a[len(ra):], (where, a, b)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _same_tree(a: str, b: str, roots=None) -> int:
    """The files under ``a`` and ``b`` (recursively): the same names, PNGs
    pixel-equal, ``gt.npy`` stores equal (paths relative to ``roots``,
    default ``a`` and ``b``). Returns the number of files."""
    from wsiseg_tpu_torch.data import metadata as md

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    names = files(a)
    assert names == files(b), (a, b)
    for f in names:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith(".png"):
            ia, ib = np.asarray(Image.open(pa)), np.asarray(Image.open(pb))
            assert ia.dtype == ib.dtype and ia.shape == ib.shape, f
            same = (ia == ib).mean()
            assert same == 1.0, f"{f}: {same:.6f} of values equal"
        elif f.endswith("gt.npy"):
            _same_value(md.load_store(pa), md.load_store(pb),
                        *(roots or (a, b)), f)
    return len(names)


def phase_tools(dev, tmp: str, smi: str) -> dict:
    """The preprocess generators and the paper tools at the reference's
    settings (tile 512, scan level 2, ``us_kmeans`` 8 for CC proposals and
    4 for SLIC's, 200 SLIC segments, the 30×30 and 50×50 openings), each
    run on the card (its default device) and again with ``--device cpu``
    into another directory, then the two outputs compared: the same
    files, PNGs pixel-equal, ``gt.npy`` stores equal, printed lines equal.
    They launch none of the port's kernels (JAX's tools reach no Pallas
    kernel either): every launch count is 0 before and after.

    The slide is the bench geometry's level 2 (4096×3072, a
    ``SyntheticSlide`` image: tissue blobs on clean white, so its tissue
    mask has a few components, where the bench image's background noise
    gives thousands; six annotated regions), a ``VirtualPyramidSlide`` as
    in phase ``[6h]`` d: a materialized level 0 would take 9.7 GB. The
    tools open it by path through a stand-in ``open_slide`` that hands out
    that pyramid; the file is a placeholder. Two cuts, both host loops the
    JAX tools share: the SLIC mode runs on a 1024×768 level 2 (the same
    image and layout scaled by 1/4), as it builds a full-size mask a
    superpixel (ROADMAP.md §1, item 7; 0.28 s a region at
    4096×3072); ``closest-regionproposal`` reads ``mk-gt``'s class mask
    resized to 256×192, as its k-NN concave hull walks every perimeter
    pixel at full resolution, quadratic in their count. The CPU run gets the card's SLIC labels, so the store
    compares the rest exactly; the labels themselves, GPU against CPU,
    must agree on ≥ 99.9 % of pixels.

    Tools: ``preprocess mk-gt``, ``centered``, ``no-tumors``,
    ``region-proposal-points --mode cc`` and ``--mode slic``,
    ``breastpathq-cells`` (four 512² crop/dot pairs), ``patch-to-cls``'s
    BreastPathQ flavor with TOOLS_QUANTIZE-colour quantization (four 512²
    patches; the CLI does not quantize, so its library function),
    ``overlay-tb`` and ``check-fp`` on heatmaps at the eval's heatmap size
    (2048×1536) and ``closest-regionproposal``."""
    import contextlib
    import io

    from wsiseg_tpu_torch.__main__ import main
    from wsiseg_tpu_torch.config import default_config
    from wsiseg_tpu_torch.ops import slic as slic_mod
    from wsiseg_tpu_torch.paper_tools import overlay_tb_wsi
    from wsiseg_tpu_torch.preprocess import (mk_gt, mk_traindata_centered,
                                             mk_traindata_no_tumors,
                                             patch_to_cls,
                                             region_proposal_points)
    from wsiseg_tpu_torch.slides.reader import (SyntheticSlide,
                                                VirtualPyramidSlide)

    reset_counts()
    t_phase = time.time()
    root = os.path.join(tmp, "tools")
    hh, ww = BENCH_HW
    l2 = SyntheticSlide(width=ww, height=hh, num_levels=1,
                        seed=95).read_level(0)
    sh, sw = TOOLS_SLIC_HW
    l2s = np.array(Image.fromarray(l2).resize((sw, sh)))
    pyramids = {"11.npy": VirtualPyramidSlide({2: l2}),
                "31.npy": VirtualPyramidSlide({2: l2s})}
    for tag in ("gpu", "cpu"):
        for d, name, scale in (("wsi", "11", ww / 4096),
                               ("slic", "31", sw / 4096)):
            os.makedirs(os.path.join(root, tag, d))
            np.save(os.path.join(root, tag, d, name + ".npy"),
                    np.zeros((1, 1, 3), np.uint8))
            _tools_xml(os.path.join(root, tag, d, name + ".xml"), scale)
    # BreastPathQ patches + labels, and crops + dot masks (512², the
    # dataset's size)
    r = np.random.RandomState(96)
    bpq, cells = os.path.join(root, "bpq"), os.path.join(root, "cells")
    os.makedirs(bpq)
    os.makedirs(cells)
    rows = ["slide,rid,y"]
    for i in range(4):
        img = level2_image(512, 512, seed=97 + i)
        Image.fromarray(img).save(os.path.join(bpq, f"{i + 1}_1.tif"))
        rows.append(f"{i + 1},1,{r.rand():.3f}")
        Image.fromarray(img).save(os.path.join(
            cells, f"{i + 1}_Region 1_crop.tif"))
        dots = np.full((512, 512, 3), 255, np.uint8)
        for y, x in r.randint(0, 512, (60, 2)):
            dots[y, x] = 0
        Image.fromarray(dots).save(os.path.join(
            cells, f"{i + 1}_Region 1_mask.tif"))
    with open(os.path.join(bpq, "labels.csv"), "w") as f:
        f.write("\n".join(rows))

    seen = {}

    def slic_on(tag):
        def run(img, **kw):
            lab = real_slic(img, **kw)
            seen[tag] = lab.cpu()
            return lab if tag == "gpu" else seen["gpu"].clone()
        return run

    def opener(pth):
        return pyramids[os.path.basename(pth)]

    real_slic = slic_mod.slic
    mods = (mk_gt, mk_traindata_centered, mk_traindata_no_tumors,
            region_proposal_points, overlay_tb_wsi)
    real_open = [m.open_slide for m in mods]
    times = {}
    printed = {}
    try:
        for m in mods:
            m.open_slide = opener
        for tag in ("gpu", "cpu"):
            base = os.path.join(root, tag)
            flag = [] if tag == "gpu" else ["--device", "cpu"]
            device = "cuda" if tag == "gpu" else "cpu"
            wsi = os.path.join(base, "wsi")
            hm_dir = os.path.join(base, "heat", "0")
            runs = [
                ("mk-gt", lambda: main(["preprocess", "mk-gt",
                                        "--raw_val_pth", wsi] + flag)),
                ("centered", lambda: main(
                    ["preprocess", "centered", "--raw_train_pth", wsi,
                     "--train_image_pth", os.path.join(base, "centered")]
                    + flag)),
                ("no-tumors", lambda: main(
                    ["preprocess", "no-tumors", "--raw_train_pth", wsi,
                     "--train_image_pth", os.path.join(base, "normals")]
                    + flag)),
                ("rpp-cc", lambda: main(
                    ["preprocess", "region-proposal-points", "--mode", "cc",
                     "--raw_train_pth", wsi, "--train_hr_image_pth",
                     os.path.join(base, "hr_cc")] + flag)),
                ("rpp-slic", lambda: region_proposal_points.generate_slic(
                    os.path.join(base, "slic"),
                    os.path.join(base, "hr_slic"), default_config(),
                    num_segments=200, device=device)),
                ("breastpathq-cells", lambda: main(
                    ["preprocess", "breastpathq-cells", "--patch_folder",
                     cells, "--train_image_pth", os.path.join(base, "cells")]
                    + flag)),
                ("patch-to-cls", lambda: patch_to_cls.generate_breastpathq(
                    bpq, os.path.join(bpq, "labels.csv"),
                    os.path.join(base, "cls"), default_config(),
                    quantize_colors=TOOLS_QUANTIZE, device=device)),
                ("overlay-tb", lambda: main(
                    ["overlay-tb", "11", "--raw_val_pth", wsi,
                     "--val_save_pth", os.path.dirname(hm_dir),
                     "--out_dir", os.path.join(base, "overlay")] + flag)),
                ("check-fp", lambda: main(
                    ["check-fp", "--raw_val_pth",
                     os.path.join(base, "screen"), "--val_save_pth",
                     os.path.join(base, "screen_heat")] + flag)),
                ("closest-regionproposal", lambda: main(
                    ["closest-regionproposal",
                     os.path.join(base, "gt_256x192.png")] + flag)),
            ]
            slic_mod.slic = slic_on(tag)
            for name, fn in runs:
                if name == "overlay-tb":
                    _tools_heatmaps(base, hm_dir)
                    os.makedirs(os.path.join(base, "overlay"))
                if name == "closest-regionproposal":
                    Image.open(os.path.join(wsi, "11.npy_mask.png")).resize(
                        (256, 192), Image.NEAREST).save(
                            os.path.join(base, "gt_256x192.png"))
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    _, ms = _host_ms(fn)
                times.setdefault(name, {})[tag] = ms / 1e3
                printed.setdefault(name, {})[tag] = out.getvalue().replace(
                    os.path.join(root, tag), "<root>")
    finally:
        slic_mod.slic = real_slic
        for m, f in zip(mods, real_open):
            m.open_slide = f
    gpu, cpu = os.path.join(root, "gpu"), os.path.join(root, "cpu")
    n_files = _same_tree(gpu, cpu)
    for name, out in printed.items():
        assert out["gpu"] == out["cpu"], (name, out)
    slic_eq = (seen["gpu"] == seen["cpu"]).float().mean().item()
    assert slic_eq >= 0.999, f"SLIC labels GPU vs CPU: {slic_eq}"
    counts = read_counts()
    assert sum(counts.values()) == 0, f"tools launched kernels: {counts}"
    from wsiseg_tpu_torch.data import metadata as md
    stores = {k: md.load_store(os.path.join(gpu, k))
              for k in ("centered", "normals", "hr_cc", "hr_slic", "cls")}
    sizes = {"centered": sum(len(v) for v in stores["centered"].values()),
             "normals": sum(len(v) for v in stores["normals"].values()),
             "hr_cc": len(stores["hr_cc"]["11.npy"]),
             "hr_slic": len(stores["hr_slic"]["31.npy"][0]),
             "cls": sum(len(v) for v in stores["cls"].values())}
    assert all(v > 0 for v in sizes.values()), sizes
    assert printed["closest-regionproposal"]["gpu"].count("nearest") >= 2
    for name, t in times.items():
        print(f"[6i] {name}: GPU {t['gpu']:.3f} s, CPU {t['cpu']:.3f} s "
              f"wall | {smi}", flush=True)
    print(f"[6i] tools on a 4096x3072 level 2 (SLIC mode: 1024x768): GPU "
          f"== CPU on {n_files} files (PNGs pixel-equal, stores equal), "
          f"printed lines equal; records {sizes}; SLIC labels GPU vs CPU "
          f"{slic_eq:.6f} equal (limit 0.999); 0 kernel launches; "
          f"{time.time() - t_phase:.1f} s | {smi}", flush=True)
    return {"tool_s": times, "slic_eq": slic_eq, "records": sizes}


def _tools_heatmaps(base: str, hm_dir: str) -> None:
    """Heatmaps at the eval's heatmap size (half of level 2, 2048×1536):
    ``11``'s hot where ``mk-gt``'s mask is malignant, with noise and
    specks; a screening set ``21``–``24`` (stub slides; 21 and 22
    annotated; 21 and 23 hot) for ``check-fp``."""
    mask = np.asarray(Image.open(os.path.join(base, "wsi",
                                              "11.npy_mask.png")))
    r = np.random.RandomState(98)
    h, w = mask.shape[0] // 2, mask.shape[1] // 2
    hot = mask[::2, ::2] >= 2
    heat = np.where(hot, 250, r.randint(0, 200, (h, w))).astype(np.uint8)
    heat[r.rand(h, w) < 0.002] = 255
    os.makedirs(hm_dir)
    Image.fromarray(heat).save(os.path.join(hm_dir, "11.npy_32_heatmap.png"))
    screen, sheat = (os.path.join(base, "screen"),
                     os.path.join(base, "screen_heat", "0"))
    os.makedirs(screen)
    os.makedirs(sheat)
    for sid in (21, 22, 23, 24):
        np.save(os.path.join(screen, f"{sid}.npy"), np.zeros((1, 1, 3),
                                                              np.uint8))
        if sid in (21, 22):
            with open(os.path.join(screen, f"{sid}.xml"), "w") as f:
                f.write("<Annotations/>")
        hm = r.randint(0, 240, (h, w)).astype(np.uint8)
        if sid in (21, 23):
            hm[h // 4:h // 2, w // 4:w // 2] = 255
        Image.fromarray(hm).save(os.path.join(sheat,
                                              f"{sid}.npy_32_heatmap.png"))


def phase_multi(dev, tmp: str, smi: str):
    """Multi-rank (``[6j]``). At world size 1 over NCCL, in this process,
    at the bench geometry: slide-parallel FCN on one slide against
    ``predict_slides_fcn`` and row-striped FCN against
    ``predict_slide_fcn(chunk=fcn_stripe_geometry(h, w, 1))``, each
    exactly, with s/slide beside the single-device route. Then two ranks
    sharing the card over gloo (NCCL refuses two ranks on one device):
    the f64 sgd hybrid step data-parallel against the single-device step
    within 1e-9·max(1, |ref|), one ``--mesh 2`` epoch of
    ``train-cellularity``, ``train-p``, ``train-ssr`` and ``train-hr``, and
    one ``--mesh 1x2`` epoch of ``train`` and ``train-hr`` (``[6k]`` e);
    and the dryrun's checks 1–5 on four ranks sharing the card. Returns
    the K1 launches of the world-1 slide-parallel run, and what ``[6k]``
    reports of these runs (d, e)."""
    from wsiseg_tpu_torch.config import default_config
    from wsiseg_tpu_torch.data.wsi_tiles import plan_slide
    from wsiseg_tpu_torch.infer.engine import (DenseInferenceEngine,
                                               fcn_stripe_geometry)
    from wsiseg_tpu_torch.models.ynet import init_ynet
    from wsiseg_tpu_torch.parallel import checks
    from wsiseg_tpu_torch.parallel.dryrun import dryrun_multichip
    from wsiseg_tpu_torch.parallel.launch import run_ranks
    from wsiseg_tpu_torch.parallel.mesh import make_mesh
    from wsiseg_tpu_torch.slides import VirtualPyramidSlide

    t_phase = time.time()
    h, w = BENCH_HW
    cfg = default_config(wsi_mask_pth="")
    # one slide: [6j] grows the run by more than 60 s (PERF.md §6)
    plans = [plan_slide("mp0", VirtualPyramidSlide(
        {2: level2_image(h, w, seed=60)}, num_levels=3), cfg)]
    engine = DenseInferenceEngine(
        init_ynet(cfg, torch.Generator().manual_seed(0)), cfg, device=dev)

    def world1(rank_dev):
        mesh = make_mesh(devices=[rank_dev])
        out = {}
        for run in ("warm", "timed"):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.time()
            sp = engine.predict_slides_fcn_sharded(plans, mesh)
            torch.cuda.synchronize()
            out["sp_s"] = (time.time() - t0) / len(plans)
            out["counts"] = read_counts()
            t0 = time.time()
            ref = engine.predict_slides_fcn(plans)
            torch.cuda.synchronize()
            out["single_s"] = (time.time() - t0) / len(plans)
        for a, b in zip(sp, ref):
            assert np.array_equal(a.labels, b.labels), "slide-parallel labels"
            assert np.array_equal(a.heatmap, b.heatmap), "slide-parallel heat"
        ch, cw = fcn_stripe_geometry(h, w, 1)
        t0 = time.time()
        rows = engine.predict_slide_fcn_sharded_rows(plans[0], mesh)
        torch.cuda.synchronize()
        out["rows_s"] = time.time() - t0
        oracle = engine.predict_slide_fcn(plans[0], chunk=(ch, cw))
        assert np.array_equal(rows.labels, oracle.labels), "row FCN labels"
        assert np.array_equal(rows.heatmap, oracle.heatmap), "row FCN heat"
        out["stripe"] = (ch, cw)
        return out

    w1 = run_ranks(world1, 1, devices=[dev])
    k1 = w1["counts"]["stem_pool_conv"]
    assert k1 > 0, "slide-parallel serving never launched stem_pool_conv"
    assert w1["counts"]["stem_conv"] == 0 and w1["counts"]["conv9"] == 0
    t_w1 = time.time() - t_phase
    print(f"[6j] a. world 1 (NCCL) at {w}x{h}: slide-parallel FCN on "
          f"{len(plans)} slide == predict_slides_fcn (labels, heat), "
          f"{w1['sp_s']:.4f} s/slide against {w1['single_s']:.4f} s/slide "
          f"single-device, launches {w1['counts']}; row-striped FCN "
          f"(stripe {w1['stripe']}) == chunked oracle, {w1['rows_s']:.3f} "
          f"s | {smi}", flush=True)

    # the dryrun at 4 ranks, as the tier-1 test runs it: at 2 (batch 4)
    # the seed-0 Y-Net's third adam step raises the loss, on one device
    # as on two, and JAX's "falling" heuristic fails (PERF.md §6)
    t0 = time.time()
    dry = dryrun_multichip(4, "cuda", devices=[dev] * 4)
    t_dry = time.time() - t0
    pair = [dev, dev]
    root = os.path.join(tmp, "multi")
    ssr_dir = os.path.join(root, "ssr")
    os.makedirs(ssr_dir)
    rng = np.random.RandomState(61)
    for i in range(4):
        Image.fromarray(level2_image(600, 600, seed=62 + i)).save(
            os.path.join(ssr_dir, f"r{i}_image.png"))
        gt = np.zeros((600, 600, 3), np.uint8)
        gt[:300, :, rng.randint(3)] = 255
        Image.fromarray(gt).save(os.path.join(ssr_dir, f"r{i}_gt.png"))
    npy = os.path.join(root, "hr_slide.npy")
    level0 = np.full((4096, 4096, 3), 240, np.uint8)
    level0[512:3584, 512:3584] = rng.randint(60, 200, (3072, 3072, 3))
    np.save(npy, level0)
    store = _hr_store(os.path.join(root, "store"), npy, 7)
    ynet_store = _train_store(os.path.join(root, "ynet"), 8, 32, 4)
    t0 = time.time()
    card = run_ranks(checks.card_training_cases, 2, devices=pair,
                     args=(ynet_store, ssr_dir, store,
                           os.path.join(root, "ck")))
    t_card = time.time() - t0
    assert card["hybrid_f64"] <= 1e-9, \
        f"DP f64 step != single-device step: {card['hybrid_f64']}"
    for k in ("train_cellularity", "train_p", "train_ssr", "train_hr",
              "train_1x2", "train_hr_1x2"):
        assert [r["epoch"] for r in card[k]] == [1], (k, card[k])
        assert np.isfinite(card[k][0]["loss"]), (k, card[k])
    print(f"[6j] b. ranks sharing the card (gloo): dryrun(4) checks 1-5 OK "
          f"(losses {[round(x, 4) for x in dry['losses']]}, step 1 rel "
          f"{dry['step1_rel']:.3g}) in {t_dry:.1f} s; DP f64 sgd hybrid "
          f"step vs single-device rel {card['hybrid_f64']:.3g}; --mesh 2 "
          f"epoch losses: " + ", ".join(
              f"{k} {card[k][0]['loss']:.4f}" for k in (
                  "train_cellularity", "train_p", "train_ssr", "train_hr"))
          + f", in {t_card:.1f} s; "
          f"[6j] {time.time() - t_phase:.1f} s (world 1: {t_w1:.1f} s) | "
          f"{smi}", flush=True)
    return k1, {"dryrun": dry, "train_1x2": card["train_1x2"],
                "train_hr_1x2": card["train_hr_1x2"]}


SPATIAL_F64_REL = 1e-9           # × max(1, |single device|), float64
SPATIAL_F32_REL = 1e-4           # step 1's metrics, float32, TF32 off
SPATIAL_BIG = 2048               # [6k] c's tile: spatial's purpose


def phase_spatial(dev, smi: str, from_multi: dict) -> dict:
    """Spatial training (``[6k]``), which launches none of the kernels.
    Four ranks share the card over gloo in one group
    (``parallel.checks.card_spatial_cases``): a. the f64 sgd hybrid step
    (resnet18 Unet, 64², batch 4) on a (2, 2) mesh against the
    single-device f64 step; b. resnet18 Unet hybrid at 512², batch 4, f32
    with TF32 off, step 1's metrics on (2, 2) and (1, 4) against the
    single-device step; c. 2048² tiles, batch 2, bf16 autocast, adam, 3
    steps on (1, 4): finite losses, each rank's peak device memory and ms
    a step beside the single-device step's; f. no kernel launch in any
    rank. d (the dryrun's check 5) and e (``--mesh 1x2`` epochs of
    ``train`` and ``train-hr``) ran in ``[6j]``'s groups
    (``from_multi``)."""
    from wsiseg_tpu_torch.parallel import checks
    from wsiseg_tpu_torch.parallel.launch import run_ranks
    t0 = time.time()
    sp = run_ranks(checks.card_spatial_cases, 4, devices=[dev] * 4,
                   args=(SPATIAL_BIG,))
    big = sp["big"]
    assert sp["f64"] <= SPATIAL_F64_REL, f"[6k] a. f64 step: {sp['f64']}"
    for m in ("2x2", "1x4"):
        assert sp[f"f32_{m}"] <= SPATIAL_F32_REL, \
            f"[6k] b. f32 step on {m}: {sp[f'f32_{m}']}"
    assert all(np.isfinite(big["losses"] + big["single_losses"])), big
    assert sp["launches"] == 0, f"[6k] launched kernels: {sp['launches']}"
    dry = from_multi["dryrun"]
    e = {k: round(from_multi[k][0]["loss"], 4)
         for k in ("train_1x2", "train_hr_1x2")}
    print(f"[6k] spatial (4 ranks sharing the card, gloo): a. f64 sgd "
          f"hybrid step (resnet18 Unet 64x64, batch 4) on 2x2 vs single "
          f"device rel {sp['f64']:.3g} (limit {SPATIAL_F64_REL:g}); b. f32 "
          f"512x512 batch 4 step 1 metrics rel 2x2 {sp['f32_2x2']:.3g}, 1x4 "
          f"{sp['f32_1x4']:.3g} (limit {SPATIAL_F32_REL:g}; losses "
          f"{sp['f32_2x2_loss']}, {sp['f32_1x4_loss']}); c. "
          f"{SPATIAL_BIG}x{SPATIAL_BIG} batch 2 bf16 adam on 1x4: losses "
          f"{[round(x, 4) for x in big['losses']]}, "
          f"{[round(x, 1) for x in big['rank_ms']]} ms/step, peak "
          f"{[round(x, 3) for x in big['rank_peak_gb']]} GB a rank; single "
          f"device {big['single_ms']:.1f} ms/step, peak "
          f"{big['single_peak_gb']:.3f} GB, losses "
          f"{[round(x, 4) for x in big['single_losses']]}; d. dryrun check "
          f"5 spatial step-0 loss {dry['spatial_loss']:.6f} vs DP "
          f"{dry['losses'][0]:.6f}; e. --mesh 1x2 epoch losses {e}; f. 0 "
          f"kernel launches; [6k] {time.time() - t0:.1f} s | {smi}",
          flush=True)
    return sp


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs an NVIDIA GPU")
    import wsiseg_tpu_torch  # noqa: F401  (fails before any output)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.time()
    smi = phase_identify()
    phase_build()
    stems = phase_stems(dev)
    convs = phase_convs(dev)
    prb = phase_probes(dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli(dev, tmp)
        eval_cli = phase_eval_cli(dev, tmp)
        default, engine, plan = phase_serve(dev, tmp, fold=False,
                                            n_slides=3)
        profiled = phase_profiling(engine, plan, tmp, smi)
        del engine, plan
        fold, _, _ = phase_serve(dev, tmp, fold=True, n_slides=2)
        families = phase_families(dev, tmp)
        phase_grid(dev, tmp, smi)
        eval_full = phase_eval_full(dev, tmp, smi)
        phase_patch_evals(dev, tmp)
        phase_train(dev, tmp, smi)
        phase_hr(dev, tmp, smi)
        phase_tools(dev, tmp, smi)
        multi, from_multi = phase_multi(dev, tmp, smi)
        phase_spatial(dev, smi, from_multi)
    routes = phase_routes(dev)
    chain = phase_fold_chain(dev)
    head = phase_head(dev)
    launches = {"stem_pool_conv": default["stem_pool_conv"] + profiled
                + families + routes["stem_pool_conv"] + eval_cli
                + eval_full + multi,
                "stem_conv": fold["stem_conv"] + routes["stem_conv"],
                "conv9": fold["conv9"] + routes["conv9"],
                "conv_chain": chain["conv_chain"],
                "conv3x3_small": head["conv3x3_small"]}
    launches.update({k: v["launches"] for k, v in prb.items()})
    rows = [
        ("stem_pool_conv", "stem_sm90.cu",
         "wsiseg_tpu/ops/pallas_stem.py:244"),
        ("stem_conv", "stem_sm90.cu", "wsiseg_tpu/ops/pallas_stem.py:79"),
        ("conv9", "conv3x3_sm90.cu", "wsiseg_tpu/ops/conv9.py:49"),
        ("conv_chain", "conv_chain_sm90.cu",
         "wsiseg_tpu/ops/conv9.py:175"),
        ("conv3x3_small", "conv3x3_sm90.cu",
         "wsiseg_tpu/ops/pallas_conv.py:28"),
        ("probe_wgmma", "probes.cu", "scripts/probe_dot.py:38"),
        ("probe_load", "probes.cu", "scripts/probe_dot2.py:58"),
        ("probe_store", "probes.cu", "scripts/probe_dot3.py:39"),
        ("probe_window", "probes.cu", "scripts/probe_dma64.py:35"),
        ("probe_stem_assembly", "stem_sm90.cu", "scripts/exp_r6e.py:43"),
        ("probe_pool_epilogue", "probes.cu", "scripts/probe_retile.py:28"),
    ]
    kernels = []
    for name, src, replaces in rows:
        if name in stems:
            r = stems[name]
            vals = dict(r["bench"], **r["bound"])
            vals["max_abs_err"] = max(v["max_abs_err"] for k, v in r.items()
                                      if k != "bound")
        else:
            vals = convs.get(name) or prb[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"wsiseg_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": vals["max_abs_err"],
            "ms": vals["ms"], "plain_ms": vals["plain_ms"],
            "bound_ms": vals["bound_ms"], "bound_by": vals["bound_by"],
            "library_ms": vals["library_ms"]})
    print(f"[9] all phases passed in {time.time() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
