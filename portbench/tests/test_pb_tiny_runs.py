"""A ``--tiny`` run of each cell on the CPU prints a contract line, and a
traced run the cell's per-layer metrics that a CPU run can read."""

from __future__ import annotations

import pytest

from pb_util import bench, tiny_run

CELLS = [w["name"] for w in bench()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_prints_contract_line(cell):
    rc, out, err = tiny_run(cell)
    assert rc == 0, err[-2000:]
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    b = bench()
    want = {m["name"] for m in b["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["attempted"] > 0 and out["failed"] == 0
    assert err.strip().splitlines()[-1] == "correct: True"


@pytest.mark.parametrize("cell", ["stream.r18_unet", "train.r18_unet"])
def test_tiny_traced_run(cell):
    rc, out, err = tiny_run(cell, trace=1)
    assert rc == 0, err[-2000:]
    b = bench()
    allowed = {m["name"] for m in b["per_layer"]
               if cell in m.get("workloads", [cell])}
    assert out["metrics"] and set(out["metrics"]) <= allowed
    assert "window_s" in out["device"] and "breakdown" in out


def test_refuses_without_a_card():
    """Without ``--tiny`` and without CUDA the run prints no result and
    exits non-zero."""
    import subprocess
    import sys

    import torch

    from pb_util import ROOT
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "stream.r18_unet", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
