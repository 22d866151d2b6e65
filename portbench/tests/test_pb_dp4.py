"""The four-rank training cell: its driver's tiny runs on four gloo CPU
ranks (sound; a skipped update on rank 0; BatchNorm's moments left
unexchanged, and half of each rank's batch, on every rank; the
control), a failure on rank 0 ending every rank at once, and its
readers on a made-up trace."""

from __future__ import annotations

import importlib.util
import multiprocessing
import os
import shutil
from types import SimpleNamespace

import pytest

from pb_util import ROOT
from portbench.drivers import train_dp
from portbench.harness.trace import Trace
from test_pb_faults import _cell
from test_pb_faults import _run as tiny_cell
from test_pb_faults import _unchanged, restore  # noqa: F401


def local_batchnorm():
    """BatchNorm's all-reduces left out (Σx, Σx² and the count forward,
    Σdy and Σdy·x̂ backward): each rank normalises with its own rows'
    moments."""
    from wsiseg_tpu_torch.models import resnet
    from wsiseg_tpu_torch.parallel import comm
    resnet.comm = SimpleNamespace(**{**vars(comm),
                                     "all_reduce": lambda t, group: None})


def half_batch():
    """Each step takes the first half of the rank's rows."""
    from wsiseg_tpu_torch.train import device_cache
    orig = device_cache.gather_batch

    def half(*args, **kw):
        b = orig(*args, **kw)
        return {k: v[: v.shape[0] // 2] for k, v in b.items()}
    device_cache.gather_batch = half


def everywhere(plant):
    """``plant`` in every rank: the run's process and the spawned ones."""
    def fault(mp):
        from wsiseg_tpu_torch.models import resnet
        mp.setattr(resnet, "comm", resnet.comm)
        mp.setattr(train_dp.Rank, "faults", (plant,))
    return fault


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "m", os.path.join(ROOT, "portbench", "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_tiny_sound_run_is_correct():
    v = tiny_cell("train.r18_unet.dp4")
    assert v["correct"], v["checks"]
    assert v["checks"]["replica_gap"]["value"] == 0


def test_tiny_skipped_update_is_not_correct(restore):  # noqa: F811
    """Rank 0 (the run's process) skips its updates: its parameters do
    not move, and they leave the other ranks'."""
    v = tiny_cell("train.r18_unet.dp4", _unchanged, restore)
    assert not v["correct"]
    assert v["checks"]["update_gap"]["value"] > 0.9
    assert v["checks"]["replica_gap"]["value"] > 0


@pytest.mark.parametrize("plant", [local_batchnorm, half_batch])
def test_tiny_fault_on_every_rank_is_not_correct(plant, restore):  # noqa: F811
    v = tiny_cell("train.r18_unet.dp4", everywhere(plant), restore)
    assert not v["correct"], v["checks"]


def _fail(self, *args):
    raise RuntimeError("planted")


@pytest.mark.parametrize("where", ["_gather_first_rows", "_window"])
def test_failure_on_rank_0_ends_every_rank(where, monkeypatch):
    """Rank 0 raises in its set-up (while the others wait in the
    all-gather) or in its window (while they wait for its command):
    the error propagates and no spawned rank outlives it."""
    cell = _cell("train.r18_unet.dp4")
    drv = train_dp.Driver(cell)
    monkeypatch.setattr(train_dp.Driver, where, _fail)
    try:
        with pytest.raises(RuntimeError, match="planted"):
            drv.setup()
            drv.window(1.0)
    finally:
        shutil.rmtree(cell.workdir, ignore_errors=True)
    assert drv.procs is None
    assert not multiprocessing.active_children()


def test_tiny_control_is_not_correct():
    assert not tiny_cell("train.r18_unet.dp4", control=True)["correct"]


def test_readers_on_a_made_up_trace():
    """Two steps; NCCL kernels of 3 ms, compute of 40 ms, a 1-s window."""
    kernels = [("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 0.1, 0.003),
               ("ncclKernel_AllReduce_RING_LL_Sum_float", 0.2, 0.003),
               ("sm90_xmma_gemm_bf16", 0.3, 0.04)]
    run = SimpleNamespace(trace=Trace(window_s=1.0, kernels=kernels),
                          window={"steps": 2})
    assert _reader("nccl_ms.dp4")(run) == pytest.approx(3.0)
    assert _reader("idle_share.train")(run) == pytest.approx(100 * 0.954)
    run.trace.kernels = kernels[2:]
    assert _reader("nccl_ms.dp4")(run) is None
