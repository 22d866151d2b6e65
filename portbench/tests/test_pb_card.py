"""On the card, at the cell's own sizes: the program's outputs read
``correct`` and the fp8 control's do not, on three seeds, in every cell.
Marked ``cuda``; skips without a card."""

from __future__ import annotations

import argparse
import importlib
import shutil

import pytest
import torch

from portbench import run as bench
from portbench.harness import checks


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["stream.r18_unet", "planned.r50_fpn",
                                      "train.r18_unet"])
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102,
                                  2 ** 31 + 103])
def test_program_correct_control_not(workload, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = bench.load_cell(argparse.Namespace(
        workload=workload, seed=seed, seconds=1.0, trace=0, tiny=False))
    drv = importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}").Driver(cell)
    try:
        drv.setup()
        drv.window(1.0)
        drv.release()
        assert checks.judge(drv.readings(), cell.limits)["correct"]
        assert not checks.judge(drv.control_readings(),
                                cell.limits)["correct"]
    finally:
        shutil.rmtree(cell.workdir, ignore_errors=True)
