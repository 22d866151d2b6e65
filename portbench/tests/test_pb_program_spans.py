"""The metrics on the program's own ``record_function`` ranges: a
``--tiny --trace 1`` run of each cell reports each of them that the cell
lists as a number, and no device operation carries a range's name (the
ranges add no device events)."""

from __future__ import annotations

import pytest

from pb_util import bench, tiny_run

METRICS = ("mask_ms.stream", "filter_ms.stream", "stage_wait_ms.stream",
           "sync_ms.stream", "d2h_ms.stream", "tail_ms.stream",
           "prepare_ms.train", "dispatch_ms.train")
RANGES = ("plan.slide", "plan.mask", "plan.filter", "pipeline.stage_wait",
          "engine.stage", "engine.serve", "engine.inputs", "engine.launch",
          "engine.forward", "engine.postprocess", "engine.sync",
          "engine.d2h", "engine.tail", "loader.wait", "loader.next",
          "loader.copy", "loader.close", "train.prepare", "train.step",
          "train.fetch")


def _listed(cell):
    return [m["name"] for m in bench()["per_layer"]
            if m["name"] in METRICS and cell in m.get("workloads", [cell])]


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_traced_tiny_run_reads_program_ranges(cell):
    want = _listed(cell)
    assert want, cell
    rc, out, err = tiny_run(cell, trace=1)
    assert rc == 0, err[-2000:]
    for name in want:
        v = out["metrics"].get(name)
        assert v is not None, (name, sorted(out["metrics"]))
        assert isinstance(v["value"], float) and v["value"] >= 0, (name, v)
    ops = [n for n, _ in out["breakdown"]["device_ops"]]
    assert not [n for n in ops if any(r in n for r in RANGES)], ops


def test_every_new_metric_is_listed():
    assert sorted(m for c in (w["name"] for w in bench()["workloads"])
                  for m in _listed(c)) == sorted(
        ["mask_ms.stream", "filter_ms.stream"] + 2 * [
            "stage_wait_ms.stream", "sync_ms.stream", "d2h_ms.stream",
            "tail_ms.stream"] + ["prepare_ms.train", "dispatch_ms.train"])
