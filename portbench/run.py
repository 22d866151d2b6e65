"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Reads ``BENCHMARK.json`` at the checkout's root and finds everything of
the cell by name: its configuration (``configs/<config>.json``), its
traffic (``traffic/<traffic>.json``, whose ``driver`` names
``drivers/<driver>.py``), its limits (``limits/<workload>.json``),
each per-layer metric's reader (``metrics/<metric>.py``) and the spans
they read (``spans/<span>.json``). Then: set-up
(``setup_s``), the measured window, the device peak, the reference's
judgement of the window's outputs, and one JSON line on standard output.
With ``--trace 1`` the window runs under ``torch.profiler`` with the
benchmark's spans and the program's ``record_function`` ranges recorded,
and the line holds the per-layer metrics.

``--tiny`` (tests only) runs the traffic's ``tiny`` sizes on the CPU.
"""

from __future__ import annotations

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every compile cache inside the checkout, at a fixed path
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "portbench", "_cache",
                                              "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "portbench",
                                                  "_cache", "extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import torch  # noqa: E402

from portbench.harness import checks  # noqa: E402
from portbench.harness import spans as span_files  # noqa: E402
from portbench.harness.spans import Spans  # noqa: E402
from portbench.harness.trace import traced  # noqa: E402

JAX_NAMES = ("jax", "jaxlib", "flax", "wsiseg_tpu")


@dataclass
class Cell:
    workload: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    e2e: List[Dict]
    per_layer: List[Dict]
    seed: int
    seconds: float
    trace: bool
    tiny: bool
    device: torch.device
    workdir: str


def _json(*parts) -> Dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def applies(metric: Dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_cell(ns) -> Cell:
    bench = _json("BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if ns.workload not in cells:
        raise SystemExit(f"no workload {ns.workload!r} in BENCHMARK.json")
    w = cells[ns.workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(configs[w["config"]]["file"])
    traffic = _json("portbench", "traffic", f"{w['traffic']}.json")
    if ns.tiny:
        config = {**config, **config.get("tiny", {})}
        traffic = {**traffic, **traffic.get("tiny", {})}
    limits = _json("portbench", "limits", f"{ns.workload}.json")
    tiny_limits = limits.pop("tiny", {})
    if ns.tiny:
        limits = tiny_limits
    dev = torch.device("cpu" if ns.tiny else "cuda")
    base = tempfile.gettempdir()
    return Cell(workload=ns.workload, chips=w["chips"], config=config,
                traffic=traffic, limits=limits,
                e2e=[m for m in bench["end_to_end"]
                     if applies(m, ns.workload)],
                per_layer=[m for m in bench["per_layer"]
                           if applies(m, ns.workload)],
                seed=ns.seed % 2 ** 63, seconds=ns.seconds,
                trace=bool(ns.trace), tiny=ns.tiny, device=dev,
                workdir=tempfile.mkdtemp(prefix="portbench-", dir=base))


def reader(name: str):
    """A per-layer metric's reader: ``metrics/<name>.py``'s ``read``."""
    path = os.path.join(ROOT, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What a per-layer reader reads."""
    cell: Cell
    window: Dict
    trace: object
    spans: Spans
    kind: str


def device_info(cell: Cell) -> Dict:
    if cell.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(cell.chips))}


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def jax_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(JAX_NAMES))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--tiny", action="store_true", help=argparse.SUPPRESS)
    ns = p.parse_args(argv)
    cell = load_cell(ns)
    if not ns.tiny and (not torch.cuda.is_available()
                        or torch.cuda.device_count() < cell.chips):
        print(f"portbench: {ns.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 3
    try:
        drv = importlib.import_module(
            f"portbench.drivers.{cell.traffic['driver']}").Driver(cell)
        return _run(cell, drv)
    finally:
        shutil.rmtree(cell.workdir, ignore_errors=True)


def _run(cell: Cell, drv) -> int:
    drv.setup()
    if cell.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    spans = Spans()
    trace = None
    if cell.trace:
        with spans.installed(span_files.load()), spans.annotations(), \
                traced(spans, cell.device.type == "cuda") as box:
            window = drv.window(cell.seconds)
        trace = box["trace"]
    else:
        window = drv.window(cell.seconds)
    device = device_info(cell)
    drv.release()
    gc.collect()
    found = jax_loaded()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    readings = drv.readings()
    verdict = checks.judge(readings, cell.limits)

    out = {"correct": verdict["correct"], "attempted": window["attempted"],
           "failed": window["failed"]}
    if cell.trace:
        run = Run(cell, window, trace, spans, device["kind"])
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.window_s
        out["metrics"] = metrics
        out["device"] = device
        out["breakdown"] = {"device_ops": trace.top_ops(),
                            "idle_gaps": trace.idle_gaps()}
    else:
        vals = {**window["e2e"], "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": vals[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.e2e}
        out["device"] = device
    if cell.device.type == "cuda":
        out["power_limit"] = power_limit()
    out["checks"] = verdict["checks"]
    for line in checks.lines(verdict):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
