"""The port's multi-rank layer (``wsiseg_tpu_torch.parallel``) over two
gloo CPU ranks: the mesh, the collectives (``global_sum`` with its
gradient, ``gather_slots``, ``shift`` as ``jax.lax.ppermute`` with
(i, i + 1)), the batch and state helpers, global BatchNorm and every loss
under ``comm.data_parallel`` against the single-device result on the
whole batch (value, and each rank's input gradient over the world size,
within 1e-9·max(1, |ref|) in f64), and the per-row jitter draw.

One group of ranks runs every case (``torch_rank_cases.parallel_cases``)
in a module-scope fixture; the tests assert on its results."""

import numpy as np
import pytest
import torch

import torch_rank_cases as rc
from wsiseg_tpu_torch.cli.common import make_preprocess
from wsiseg_tpu_torch.config import default_config
from wsiseg_tpu_torch.parallel import launch
from wsiseg_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)

REL = 1e-9                              # × max(1, |ref|), float64


@pytest.fixture(scope="module")
def cases():
    return launch.run_ranks(rc.parallel_cases, 2, "cpu", threads=1)


def test_mesh_and_collectives(cases):
    assert cases["world"] == 2 and cases["dims"] == ("data",)
    assert cases["global_sum"] == 2 * 1.0 + 2 * 4.0
    # rank 0's x = 1: the true gradient 2x times the world size
    np.testing.assert_array_equal(cases["global_sum_grad"], [4.0, 4.0])
    np.testing.assert_array_equal(cases["gather"], [[1, 1, 1], [2, 2, 2]])
    np.testing.assert_array_equal(cases["shift1"], [[0, 0], [1, 1]])
    assert cases["gather_objects"] == [{"rank": 0}, {"rank": 1}]


def test_batch_rows_and_replication(cases):
    # grad_accum 2: rank 0 holds rows 0-1 of microbatch 0 and 4-5 of 1
    np.testing.assert_array_equal(cases["rows_ga2"], [0, 1, 4, 5])
    assert cases["indivisible_raises"]
    np.testing.assert_array_equal(cases["shard_rows"], [0, 1, 2, 3])
    np.testing.assert_array_equal(cases["shard_rng"], [0, 1])
    assert cases["replicated_weight"] == 0.0        # rank 0's weights


@pytest.mark.parametrize("name", [
    "batchnorm", "loss_xent", "loss_xent_plain", "loss_focal", "loss_ohem",
    "loss_ohem_plain", "loss_cent", "loss_dice", "loss_jaccard",
    "loss_tversky", "loss_bce", "loss_mse", "loss_l1", "loss_rmse",
    "loss_logcosh", "loss_xtanh", "loss_xsigmoid"])
def test_global_reductions_match_single_device(cases, name):
    assert cases[name] <= REL, cases[name]


@pytest.mark.parametrize("shape", [(4, 8, 8, 3), (4, 2, 8, 8, 3)])
def test_jitter_rows_match_the_global_batch(shape):
    """A rank's rows (n, index) draw the whole batch's jitter factors and
    take theirs: equal to the rows of the single-device preprocess (an HR
    batch's patches draw per patch)."""
    cfg = default_config(compute_dtype="float64")
    pre = make_preprocess(cfg)
    img = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, shape).astype(np.uint8))
    full = pre({"image": img}, torch.Generator().manual_seed(3))["image"]
    idx = torch.tensor([1, 3])
    part = pre({"image": img[idx]}, torch.Generator().manual_seed(3),
               rows=(shape[0], idx))["image"]
    torch.testing.assert_close(part, full[idx], rtol=0, atol=0)


def test_launch_picks_backends_and_refuses_missing_cards():
    cpu, c0, c1 = (torch.device(d) for d in ("cpu", "cuda:0", "cuda:1"))
    assert launch.backend_for([cpu, cpu]) == "gloo"
    assert launch.backend_for([c0, c0]) == "gloo"
    assert launch.backend_for([c0, c1]) == "nccl"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch.rank_devices(2, "cuda")
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()
