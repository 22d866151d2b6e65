"""Data-parallel training over each rank's device cache (``train --mesh N
--device_cache``): each rank caches only its rows of every host batch,
shuffles them with the epoch's permutation, and draws the global batch's
jitter for its rows (``train.device_cache.cached_training``).

One group of four gloo CPU ranks holds the cached data-parallel step
against the single-device cached step on the global batch (each rank's
local batch at its ``parallel.mesh.batch_rows``), f64 sgd, within the
tolerance of ``tests/test_torch_dp_training.py``: 1e-9·max(1, |ref|) on
every parameter, BatchNorm statistic and metric, every rank. Then ``train --mesh 2 --device_cache
--device cpu`` end to end, its two ranks spawned by the command."""

import numpy as np
import pytest

import torch_rank_cases as rc
from test_torch_train_data import make_store
from wsiseg_tpu_torch.cli.train import main
from wsiseg_tpu_torch.parallel import launch

REL = 1e-9                              # × max(1, |ref|), float64


@pytest.fixture(scope="module")
def cases():
    return launch.run_ranks(rc.cached_dp_cases, 4, "cpu", threads=1)


def test_cached_dp_step_matches_single_device(cases):
    assert cases["cached_dp"] <= REL, cases["cached_dp"]


def test_each_rank_caches_its_rows(cases):
    """32 patches in host batches of 8 over 4 ranks: 8 rows cached a
    rank, a local batch of 2."""
    assert cases["cache_rows"] == 8 and cases["local_batch"] == 2


def test_allreduces_counted(cases):
    """The data-parallel step all-reduces BatchNorm's moments in each of
    the resnet18 Unet's 30 BatchNorm layers, forward and backward, the
    losses' global sums and the gradients; the single-device step makes
    none."""
    assert cases["allreduce_calls"] >= 2 * 30 + 1
    assert cases["single_calls"] == 0


def test_train_cli_mesh_device_cache_trains(tmp_path):
    """``train --mesh 2 --device_cache --device cpu`` spawns its gloo
    ranks, each caching its rows, and trains two epochs: rank 0's
    history."""
    store = make_store(str(tmp_path / "store"), n=16, sizes=((32, 32),))
    trainer = main(["--device", "cpu", "--mesh", "2", "--device_cache",
                    "true", "--train_image_pth", store, "--tile_w", "32",
                    "--tile_h", "32", "--batch_size", "8", "--num_epoch",
                    "2", "--save_models", "0", "--raw_val_pth", "",
                    "--compute_dtype", "float32"])
    hist = trainer.history
    assert [h["epoch"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) and h["patches_per_sec"] > 0
               for h in hist)
