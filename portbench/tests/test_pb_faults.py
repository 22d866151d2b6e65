"""``correct`` comes out false when the timed path is broken underneath,
once for each fault a cell can have, and when the control (the
reference from fp8 operands) stands in the program's place. The runs
skip the look for a card and drive the rest of a run at the traffic's
tiny sizes on the CPU, held to the limits files' ``tiny`` limits."""

from __future__ import annotations

import argparse
import importlib
import shutil

import pytest

from portbench import calibrate
from portbench import run as bench
from portbench.harness import checks


def _cell(workload, seed=11):
    return bench.load_cell(argparse.Namespace(
        workload=workload, seed=seed, seconds=1.0, trace=0, tiny=True))


def _run(workload, fault=None, monkeypatch=None, control=False):
    cell = _cell(workload)
    drv = importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}").Driver(cell)
    try:
        if fault:
            fault(monkeypatch)
        drv.setup()
        drv.window(1.0)
        drv.release()
        r = drv.control_readings() if control else drv.readings()
    finally:
        shutil.rmtree(cell.workdir, ignore_errors=True)
    return checks.judge(r, cell.limits)


def _altered(mp):
    calibrate.plant("altered")


def _labels(mp):
    calibrate.plant("labels")


def _half_batch(mp):
    calibrate.plant("half_batch")


def _unchanged(mp):
    """The step returns the state unchanged: the update is skipped."""
    import torch
    mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


@pytest.fixture
def restore(monkeypatch):
    from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
    from wsiseg_tpu_torch.train import device_cache
    monkeypatch.setattr(DenseInferenceEngine, "_results",
                        DenseInferenceEngine._results)
    monkeypatch.setattr(device_cache, "gather_batch",
                        device_cache.gather_batch)
    return monkeypatch


@pytest.mark.parametrize("workload,fault", [
    ("stream.r18_unet", _altered), ("stream.r18_unet", _labels),
    ("planned.r50_fpn", _altered),
    ("train.r18_unet", _half_batch), ("train.r18_unet", _unchanged)])
def test_fault_is_not_correct(workload, fault, restore):
    assert not _run(workload, fault, restore)["correct"]


@pytest.mark.parametrize("workload", ["stream.r18_unet", "planned.r50_fpn",
                                      "train.r18_unet"])
def test_sound_run_is_correct(workload):
    assert _run(workload)["correct"]


@pytest.mark.parametrize("workload", ["stream.r18_unet", "planned.r50_fpn",
                                      "train.r18_unet"])
def test_control_is_not_correct(workload):
    assert not _run(workload, control=True)["correct"]
