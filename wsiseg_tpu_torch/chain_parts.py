"""Where the fused chain's time goes, without a profiler that sees inside a
kernel: ``csrc/conv_chain_sm90.cu`` rebuilt with parts switched off, and
its launch plan varied, each case timed on the fold decoder's layer groups
at the bench geometry (a 3072×4096 level-2 slide, N = 1) on one CUDA
device:

    python3 -m wsiseg_tpu_torch.chain_parts

Variants (outputs of all but ``full`` are wrong by design): ``full``;
``no_mma`` (no wgmma issued; the loads, barriers and epilogues run);
``no_epilogue`` (the inner layers' ring stores and the last layer's
staging and global stores skipped; barriers kept); ``loads_only`` (both
off: the TMA ring, the windows and the barriers alone); and the epilogue
in parts: ``no_bias_loads`` (bias read as 0), ``no_inner_stores`` (the
ring stores only), ``no_last_stores`` (the last layer's staging and
global stores only); ``barrier_first`` (both consumer warpgroups meet
before the inner epilogue, so no wgmma is in flight during its stores);
``no_fence`` (the inner epilogue's fence.proxy.async left out: a timing
of the fence only, the results may be wrong). Then ``full`` with
the plan of ``ops/conv9.plan_chain`` changed one knob at a time: the
segment halved and doubled, one or two layer-0 windows, fewer weight
stages. Prints ptxas's notes
on wgmma pipelines it serialised, per variant (a wgmma issued under a
runtime condition cost 1.4-1.5x before the kernel issued them all). Kernel
time by CUDA events (median of 10). Prints one line per case and a JSON
line; builds into ``wsiseg_tpu_torch/_build/chain_parts/``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from dataclasses import replace

import numpy as np
import torch

from wsiseg_tpu_torch.ops import conv9, stem
from wsiseg_tpu_torch.probes import cuda_ms

# chip_smoke.py's FOLD_GROUPS: (name, H, W, channels, last ReLU, f32 out)
GROUPS = [("block0", 192, 256, (768, 256, 256), True, False),
          ("block1", 384, 512, (384, 128, 128), True, False),
          ("block2", 384, 512, (384, 256, 256), True, False),
          ("block3", 768, 1024, (320, 128, 128), True, False),
          ("block4+head", 1536, 2048, (32, 64, 64, 16), False, True)]
# (text in conv_chain_sm90.cu, the same text behind a switch)
SWITCHES = [
    ("                for (int mt = 0; mt < MT; ++mt) {\n"
     "                  const uint64_t da",
     "                for (int mt = 0; mt < (SKIP_MMA ? 0 : MT); ++mt) {\n"
     "                  const uint64_t da"),
    ("          for (int jn = 0; jn < NM / 8; ++jn) {",
     "          for (int jn = 0; jn < (SKIP_EPI || SKIP_MID ? 0 : NM / 8);"
     " ++jn) {"),
    ("            for (int jn = 0; jn < NL / 8; ++jn) {\n"
     "              if (jn / (CH / 8) != p) continue;",
     "            for (int jn = 0; jn < (SKIP_EPI || SKIP_LAST ? 0 : NL / 8);"
     " ++jn) {\n"
     "              if (jn / (CH / 8) != p) continue;"),
    ("q < PITCH * NQ; q += 128)",
     "q < (SKIP_EPI || SKIP_LAST ? 0 : PITCH * NQ); q += 128)"),
    ("__ldg(bias + n)", "(SKIP_BIAS ? 0.f : __ldg(bias + n))"),
    ("          const uint32_t ring = ring0 + l * R * SLOT;",
     "          if (BAR_FIRST) bar_sync(1, 256);\n"
     "          const uint32_t ring = ring0 + l * R * SLOT;"),
    ("          fence_proxy_async();",
     "          if (!SKIP_FENCE) fence_proxy_async();"),
    ("__ldg(bias + n + 1)", "(SKIP_BIAS ? 0.f : __ldg(bias + n + 1))"),
]
VARIANTS = {"full": (), "no_mma": ("SKIP_MMA",),
            "no_epilogue": ("SKIP_EPI",),
            "loads_only": ("SKIP_MMA", "SKIP_EPI"),
            "no_bias_loads": ("SKIP_BIAS",), "no_inner_stores": ("SKIP_MID",),
            "no_last_stores": ("SKIP_LAST",),
            "barrier_first": ("BAR_FIRST",), "no_fence": ("SKIP_FENCE",)}
ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 5
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] * 3
            + [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 7
            + [ctypes.c_void_p])


def build_variants() -> dict:
    """One library per variant, all nvcc runs started together."""
    src = (stem.CSRC / "conv_chain_sm90.cu").read_text()
    for old, new in SWITCHES:
        if old not in src:
            raise RuntimeError(f"conv_chain_sm90.cu changed; no {old!r}")
        src = src.replace(old, new)
    macros = "".join(f"#ifndef {k}\n#define {k} 0\n#endif\n"
                     for k in ("SKIP_MMA", "SKIP_EPI", "SKIP_BIAS",
                               "SKIP_MID", "SKIP_LAST", "BAR_FIRST",
                               "SKIP_FENCE"))
    out = stem.BUILD_DIR / "chain_parts"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "chain_parts.cu"
    cu.write_text(src.replace('#include "sm90.cuh"',
                              macros + '#include "sm90.cuh"'))
    nvcc = "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, flags in VARIANTS.items():
        lib = out / f"lib_{name}.so"
        cmd = [nvcc, *stem.NVCC_FLAGS, *stem.PTXAS_VERBOSE, "-shared",
               "-I", str(stem.CSRC),
               *(f"-D{f}=1" for f in flags), "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stderr=subprocess.PIPE,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        # ptxas's notes on wgmma pipelines it had to serialise
        notes = sorted({ln.split(":", 1)[-1].strip()
                        for ln in err.splitlines()
                        if "erializ" in ln or "Performance" in ln})
        print(f"{name}: ptxas notes {notes or 'none'}", flush=True)
        fn = ctypes.CDLL(str(lib)).wsiseg_conv_chain_sm90
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def _plans(p: conv9.ChainPlan) -> dict:
    """The plan and its one-knob variants that fit in shared memory."""
    cands = {"plan": p, "seg/2": replace(p, seg=max(1, p.seg // 2)),
             "seg*2": replace(p, seg=min(p.h, 2 * p.seg)),
             "nwin=1": replace(p, nwin=1), "nwin=2": replace(p, nwin=2),
             "stages/2": replace(p, stages=max(2, p.stages // 2))}
    out = {}
    for k, q in cands.items():
        if k != "plan" and q == p:
            continue
        while q.smem_bytes > conv9.MAX_SMEM and q.stages > 2:
            q = replace(q, stages=q.stages - 1)
        if q.smem_bytes <= conv9.MAX_SMEM:
            out[f"{k} (seg {q.seg}, stages {q.stages}, nwin {q.nwin})"] = q
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chain_parts needs a CUDA device")
    dev = torch.device("cuda", 0)
    libs = build_variants()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.RandomState(0)
    res = {"device": torch.cuda.get_device_name(0)}
    for gname, h, w, chans, last_relu, f32 in GROUPS:
        x = torch.from_numpy(rng.randn(1, h, w, chans[0]).astype(
            np.float32)).to(dev).to(torch.bfloat16)
        layers = []
        for i, (ci, co) in enumerate(zip(chans[:-1], chans[1:])):
            k = torch.from_numpy(rng.randn(3, 3, ci, co).astype(np.float32)
                                 / np.sqrt(9 * ci)).to(dev)
            wl, bl = conv9.prep_layer(k)
            layers.append((wl, bl, last_relu or i + 2 < len(chans)))
        out = torch.empty((1, h, w, chans[-1]), device=dev,
                          dtype=torch.float32 if f32 else torch.bfloat16)
        args = []
        for wl, bl, _ in layers:
            args += [wl.data_ptr(), bl.data_ptr(), wl.shape[0]]
        args += [None, None, 0] * (conv9.MAX_LAYERS - len(layers))
        relu = sum(int(r) << i for i, (_, _, r) in enumerate(layers))
        base = conv9.plan_chain(1, h, w, chans)

        def timed(fn, p):
            def run():
                err = fn(x.data_ptr(), 1, h, w, chans[0], len(layers), *args,
                         relu, int(f32), out.data_ptr(), p.nm, p.nl, p.mt,
                         p.seg, p.stages, p.nwin, p.smem_bytes, stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: {err}")
            return cuda_ms(run, 10)

        for name, fn in libs.items():
            ms = timed(fn, base)
            res[f"{gname}:{name}"] = ms
            print(f"{gname} {name}: {ms:.4f} ms", flush=True)
        for label, p in _plans(base).items():
            if label.startswith("plan"):
                continue
            ms = timed(libs["full"], p)
            res[f"{gname}:{label}"] = ms
            print(f"{gname} full, {label}: {ms:.4f} ms (recompute "
                  f"{p.recompute:.4f})", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
