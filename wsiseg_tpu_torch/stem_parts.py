"""Where the stem kernel's time goes, without a profiler that sees inside a
kernel: ``csrc/stem_sm90.cu`` rebuilt with parts switched off, each
variant timed at the bench geometry on one CUDA device:

    python3 -m wsiseg_tpu_torch.stem_parts

Variants (outputs of all but ``full`` are wrong by design): ``full``;
``no_mma`` (the 21 wgmmas of a row not issued); ``no_assembly`` (the next
row's input rows not written: the block forms' loads and conversions);
``no_store`` (no global stores); ``no_pool`` (no pool epilogue);
``loop_only`` (all four off: barriers, staging and the loop). For each
assembly form and mode, kernel time by CUDA events (median of 10), the
launch plan of ``ops/stem.plan_stem`` computed once. Prints one line per
case and a JSON line; builds into ``wsiseg_tpu_torch/_build/parts/``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from wsiseg_tpu_torch.ops import stem
from wsiseg_tpu_torch.probes import MEAN, cuda_ms, stem_weights

BENCH_HW = (3072, 4096)
# (text in stem_sm90.cu, the same text behind a switch)
SWITCHES = [
    ("      Wgmma<BN>::mma(acc, a_desc(y, ks),",
     "      if (!SKIP_MMA) Wgmma<BN>::mma(acc, a_desc(y, ks),"),
    ("    if (FORM != PER_ROW && y + 1 < y_end) {",
     "    if (!SKIP_ASM && FORM != PER_ROW && y + 1 < y_end) {"),
    ("        *reinterpret_cast<uint4*>(dst + 8 * c) = v;",
     "        if (!SKIP_STORE) *reinterpret_cast<uint4*>(dst + 8 * c) = v;"),
    ("            *reinterpret_cast<uint4*>(\n                a.out1",
     "            if (!SKIP_STORE) *reinterpret_cast<uint4*>(\n"
     "                a.out1"),
    ("        if (store_row) {\n          // pool[q]",
     "        if (!SKIP_POOL && store_row) {\n          // pool[q]"),
]
VARIANTS = {"full": (), "no_mma": ("SKIP_MMA",), "no_assembly": ("SKIP_ASM",),
            "no_store": ("SKIP_STORE",), "no_pool": ("SKIP_POOL",),
            "loop_only": ("SKIP_MMA", "SKIP_ASM", "SKIP_STORE", "SKIP_POOL")}


def build_variants() -> dict:
    """One library per variant, all nvcc runs started together."""
    src = (stem.CSRC / "stem_sm90.cu").read_text()
    for old, new in SWITCHES:
        if old not in src:
            raise RuntimeError(f"stem_sm90.cu changed; no {old!r}")
        src = src.replace(old, new)
    macros = "".join(f"#ifndef {k}\n#define {k} 0\n#endif\n"
                     for k in ("SKIP_MMA", "SKIP_ASM", "SKIP_STORE",
                               "SKIP_POOL"))
    out = stem.BUILD_DIR / "parts"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "stem_parts.cu"
    cu.write_text(src.replace('#include "sm90.cuh"',
                              macros + '#include "sm90.cuh"'))
    nvcc = "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, flags in VARIANTS.items():
        lib = out / f"lib_{name}.so"
        cmd = [nvcc, *stem.NVCC_FLAGS, "-shared", "-I", str(stem.CSRC),
               *(f"-D{f}=1" for f in flags), "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stderr=subprocess.PIPE,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        fn = ctypes.CDLL(str(lib)).wsiseg_stem_sm90
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("stem_parts needs a CUDA device")
    dev = torch.device("cuda", 0)
    libs = build_variants()
    h, w = BENCH_HW
    img = torch.from_numpy(np.random.RandomState(0).randint(
        0, 255, (1, h, w, 3), np.uint8)).to(dev)
    wf, bias = stem_weights(dev)
    cells = stem.prepare_stem_cells(wf)
    pad = stem.pad_value(MEAN)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = {"device": torch.cuda.get_device_name(0)}
    for pool in (True, False):
        o0 = torch.empty((1, h // 4, w // 4, 256) if pool
                         else (1, h // 2, w // 2, 64), dtype=torch.bfloat16,
                         device=dev)
        o1 = torch.empty((1, h // 4, w // 4, 64), dtype=torch.bfloat16,
                         device=dev)
        for form in stem.FORMS:
            p = stem.plan_stem(1, h, w, pool, form, sms)
            for name, fn in libs.items():
                args = (img.data_ptr(), cells.data_ptr(), bias.data_ptr(), 1,
                        h, w, *pad, o0.data_ptr(), o1.data_ptr(), int(pool),
                        stem.FORMS.index(form), p.strips, p.segs, p.seg_rows,
                        p.wgs, stream)

                def run():
                    if fn(*args) != 0:
                        raise RuntimeError(f"{name} launch failed")
                ms = cuda_ms(run, 10)
                key = f"{'pool' if pool else 'native'}_{form}_{name}"
                res[key] = ms
                print(f"{key}: {ms:.4f} ms ({p.wgs} warpgroups a block, "
                      f"{p.units} units of {p.seg_rows} rows)", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
