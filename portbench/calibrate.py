"""Readings for the limits of ``correct``: the program's numbers over many
seeds, the control's (the reference from fp8 operands, in the program's
place) and a planted fault's, in one process, so that set-up's imports
and kernel builds are paid once.

    python3 -m portbench.calibrate --workload stream.r18_unet \
        --seeds 1,2,3 --control 1,2 --seconds 3 [--fault half_batch]

Each seed is a full set-up and a short window at the cell's own sizes and
load; one JSON line a seed. Faults (``--fault``): ``half_batch`` (train:
each step takes the first half of its rows, the mean over them),
``altered`` (stream: every label and heat value of a slide's result
shifted where the engine produces it) and ``labels`` (stream: the labels
alone shifted there, the heat left as it is).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import shutil
import sys
import time

import torch

from portbench import run as bench


def plant(fault: str) -> None:
    if fault == "half_batch":
        from wsiseg_tpu_torch.train import device_cache
        orig = device_cache.gather_batch

        def half(arrays, idx, cfg, generator=None, train=True):
            b = orig(arrays, idx, cfg, generator, train)
            return {k: v[: v.shape[0] // 2] for k, v in b.items()}
        device_cache.gather_batch = half
    elif fault in ("altered", "labels"):
        from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
        orig = DenseInferenceEngine._results

        def altered(self, plans, labels, heat, per):
            out = orig(self, plans, labels, heat, per)
            for r in out:
                r.labels = (r.labels + 1) % self.cfg.num_classes
                if fault == "altered":
                    r.heatmap = (r.heatmap + 0.5) % 1.0
            return out
        DenseInferenceEngine._results = altered
    elif fault:
        raise SystemExit(f"unknown fault {fault!r}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", default="")
    p.add_argument("--tiny", action="store_true")
    ns = p.parse_args(argv)
    seeds = [int(s) for s in ns.seeds.split(",") if s]
    control = {int(s) for s in ns.control.split(",") if s}
    plant(ns.fault)
    for seed in seeds:
        t0 = time.perf_counter()
        cell = bench.load_cell(argparse.Namespace(
            workload=ns.workload, seed=seed, seconds=ns.seconds, trace=0,
            tiny=ns.tiny))
        drv = importlib.import_module(
            f"portbench.drivers.{cell.traffic['driver']}").Driver(cell)
        try:
            drv.setup()
            win = drv.window(ns.seconds)
            drv.release()
            gc.collect()
            rec = {"seed": seed, "fault": ns.fault or None,
                   "program": drv.readings(), "e2e": win["e2e"],
                   "attempted": win["attempted"]}
            if seed in control:
                rec["control"] = drv.control_readings()
        finally:
            shutil.rmtree(cell.workdir, ignore_errors=True)
            drv = None
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
    sys.stdout.flush()


if __name__ == "__main__":
    main()
