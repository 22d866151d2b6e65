"""Spatial (data × space) training of the port over four gloo CPU ranks,
against the port's single-device step and, for two cases, against the
JAX package's single-device step on the same weights and batch, in f64
with sgd: loss, metrics, parameters and BatchNorm running statistics
within 1e-9·max(1, |ref|), every rank.

One group of four ranks (``torch_rank_cases.spatial_training_cases``)
builds a (2, 2) and a (1, 4) mesh over the four, and two (1, 2) meshes
over ranks 0–1 and 2–3, which run their cases at once; each case against
the single-device step on the whole batch:

- the resnet18 Unet hybrid step at 64², batch 4, on (2, 2): every stripe
  32 rows, nothing gathers; and at 32² on (1, 4), the stripe of 8 rows of
  JAX's ``tests/test_spatial_training.py``, where levels 4 and 5 gather
  (``parallel/spatial.py``);
- a Bottleneck encoder: resnet50 Unet hybrid at 32², batch 8, on (1, 2),
  where the stripe is 16 rows and level 5 gathers (at batch 2 its c5
  BatchNorm would see two values a channel, and a 1e-15 relative change
  of the input moves the single-device f64 state by 1e-2: no reordering
  of its sums can be held to 1e-9 there; at batch 8 it sees eight);
- the seg step of Linknet, FPN (a gathered c5's lateral split at level
  4) and PSPNet (c5 gathered) on (1, 2) at 32²;
- OHEM (the ranking over the gathered, resized pixels, each once) and
  dice on Unet; the cls step (``train-p``);
- the HR ensemble step at 2×16×32², the patches split over 2 space ranks;
- ``grad_accum`` 2 at batch 8;
- one ``Trainer`` epoch with the jitter on (2, 2), which logs from one
  rank only, and ``train --mesh 2x2`` in the group.

The (2, 2) hybrid and the OHEM cases start from f64 flax variables
(``test_torch_train_step.random_variables`` through ``from_flax``) and
are also held against ``test_torch_train_step.jax_step``, which the JAX
steps of this process compute while the ranks work. The layout of
``shard_batch_spatial`` is held against JAX's on conftest's 8 CPU
devices, and the spatial ops at one space rank against the plain ops.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_rank_cases as rc
from test_torch_train_data import make_store
from test_torch_train_step import (CW, SW, assert_step_close, configs,
                                   jax_f64, jax_step, random_variables)
from wsiseg_tpu.models.ynet import build_ynet as jax_build_ynet
from wsiseg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wsiseg_tpu.parallel.mesh import \
    shard_batch_spatial as jax_shard_batch_spatial
from wsiseg_tpu_torch.models.decoders import resize_linear
from wsiseg_tpu_torch.models.flax_import import from_flax
from wsiseg_tpu_torch.parallel import comm, launch, spatial
from wsiseg_tpu_torch.parallel.mesh import shard_batch_spatial
from wsiseg_tpu_torch.parallel.checks import hybrid_batch

torch.set_num_threads(2)

REL = 1e-9                              # × max(1, |ref|), float64
SEED = 0                                # the flax variables' seed


def _jax_batch(batch):
    return {k: v.astype(np.int32) if v.dtype == np.int64 else v
            for k, v in batch.items()}


def _jax_references(variables, given):
    """JAX's single-device f64 steps of the ``hybrid_2x2`` and
    ``seg_ohem`` cases from the seed's ``variables`` (``given`` is their
    port state_dict): {case: (metrics, new state as a port
    state_dict)}."""
    jcfg, _ = configs(tile=64)
    _, jm, sd = jax_step("hybrid", jcfg, _jax_batch(hybrid_batch(
        "crss", tile=64)), 1, variables=variables, cls_weights=CW,
        seg_weights=SW)
    out = {"hybrid_2x2": (jm, sd)}
    jcfg, _ = configs(loss="ohem")
    _, jm, sd = jax_step("seg", jcfg, _jax_batch(rc.ohem_batch(given)), 1,
                         variables=variables, class_weights=SW)
    out["seg_ohem"] = (jm, sd)
    return out


@pytest.fixture(scope="module")
def ck_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("ck")


@pytest.fixture(scope="module")
def run(tmp_path_factory, ck_dir):
    """(the ranks' results, {case: JAX reference}): the ranks run in a
    thread while this process makes the flax variables (which the ranks
    read from a file once they need them) and computes the JAX steps."""
    store = make_store(str(tmp_path_factory.mktemp("store")), n=8,
                       sizes=((32, 32),))
    given_pth = str(tmp_path_factory.mktemp("given") / "given.pt")
    with ThreadPoolExecutor(max_workers=1) as pool:
        ranks = pool.submit(launch.run_ranks, rc.spatial_training_cases, 4,
                            "cpu", args=(given_pth, store, str(ck_dir)),
                            threads=1)
        with jax_f64():
            variables = random_variables(jax_build_ynet(configs()[0]),
                                         SEED)
        given = from_flax(variables)
        rc.publish_state(given, given_pth)
        refs = _jax_references(variables, given)
        return ranks.result(), refs


@pytest.fixture(scope="module")
def cases(run):
    return run[0]


@pytest.mark.parametrize("case", [
    "hybrid_2x2", "hybrid_1x4", "resnet50_1x2", "seg_Linknet", "seg_FPN",
    "seg_PSPNet", "seg_ohem", "seg_dice", "cls", "hr", "grad_accum2",
    "trainer_epoch"])
def test_spatial_step_matches_single_device(cases, case):
    assert cases[case] <= REL, cases[case]


@pytest.mark.parametrize("case", ["hybrid_2x2", "seg_ohem"])
def test_spatial_step_matches_jax(run, case):
    """The port's spatial step (rank 0's replica; the spread over the
    ranks is in ``test_spatial_step_matches_single_device``) against
    JAX's single-device step on the same variables and global batch."""
    cases, refs = run
    metrics, state = cases[f"{case}_sp"]
    jm, ref_sd = refs[case]
    assert_step_close(jm, ref_sd, metrics,
                      {k: torch.from_numpy(v) for k, v in state.items()})


def test_trainer_logs_from_one_rank(cases):
    """On the (2, 2) mesh only the lead rank (every coordinate 0) logs;
    a batch that does not divide over the data axis raises."""
    assert cases["trainer_history_keys"]
    assert [n > 0 for n in cases["trainer_logs"]] == [True, False, False,
                                                      False]
    assert cases["indivisible_raises"]


def test_train_cli_spatial_mesh(cases, ck_dir):
    """``train --device cpu --mesh 2x2`` in the group (as under
    ``torchrun``) trains an epoch: rank 0's history, its checkpoint."""
    hist = cases["train_cli"]
    assert [r["epoch"] for r in hist] == [1]
    assert np.isfinite(hist[0]["loss"])
    assert sorted(f for f in os.listdir(ck_dir) if f.endswith(".pt")) == [
        os.path.basename(hist[0]["checkpoint"])]


class _Coord:
    """What the port's ``shard_batch_spatial`` reads of a ``DeviceMesh``,
    at coordinate (d, s) of a (2, 4) ("data", "space") mesh (no process
    group)."""

    mesh_dim_names = ("data", "space")
    device_type = "cpu"

    def __init__(self, d: int, s: int):
        self.coord = (d, s)

    def size(self, dim=None):
        return 8 if dim is None else (2, 4)[dim]

    def get_local_rank(self, dim):
        return self.coord[dim]


def _layout_batches():
    rs = np.random.RandomState(4)
    ynet = {"image": rs.rand(4, 32, 16, 3).astype(np.float32),
            "seg_label": rs.randint(0, 4, (4, 32, 16)).astype(np.int32),
            "is_seg": rs.rand(4).astype(np.float32)}
    hr = {"image": rs.rand(4, 16, 8, 8, 3).astype(np.float32),
          "cls_label": rs.randint(0, 4, (4,)).astype(np.int32)}
    return ynet, hr


@pytest.mark.parametrize("which", ["ynet", "hr"])
def test_shard_batch_spatial_layout_matches_jax(which):
    """For each device (d, s) of a (2, 4) mesh, the port's rows and stripe
    equal the addressable shard JAX's ``shard_batch_spatial`` places
    there: images and label maps on (batch, height), per-row keys on
    batch, the HR batch's 16 patches on (batch, patch)."""
    assert jax.device_count() == 8
    batch = dict(zip(("ynet", "hr"), _layout_batches()))[which]
    mesh = jax_make_mesh(devices=jax.devices(), shape=(2, 4),
                         axes=("data", "space"))
    staged = jax_shard_batch_spatial(mesh, batch)
    where = {dev: (d, s) for (d, s), dev in np.ndenumerate(mesh.devices)}
    for k, arr in staged.items():
        for shard in arr.addressable_shards:
            got = shard_batch_spatial(_Coord(*where[shard.device]), batch)
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(shard.data),
                                          err_msg=f"{k} at {shard.device}")


def test_indivisible_height_raises_in_both():
    ynet, _ = _layout_batches()
    bad = dict(ynet, image=np.zeros((4, 30, 16, 3), np.float32))
    mesh = jax_make_mesh(devices=jax.devices(), shape=(2, 4),
                         axes=("data", "space"))
    with pytest.raises(ValueError, match="not divisible"):
        jax_shard_batch_spatial(mesh, bad)
    with pytest.raises(ValueError, match="image height 30 not divisible"):
        shard_batch_spatial(_Coord(0, 0), bad)


@pytest.mark.parametrize("spec,ranks", [("2x4", 8), ("1x1", 1), ("4", 4),
                                        ("", 1)])
def test_mesh_ranks_parses(spec, ranks):
    from wsiseg_tpu_torch.cli.common import mesh_ranks
    assert mesh_ranks(spec, "cpu") == ranks


def test_mesh_all_counts_cards():
    """``--mesh all`` counts the visible cards; on the CPU it raises."""
    from wsiseg_tpu_torch.cli.common import mesh_ranks
    assert mesh_ranks("all", "cuda") == torch.cuda.device_count()
    with pytest.raises(ValueError, match="--mesh N"):
        mesh_ranks("all", "cpu")


# ---- the spatial ops at one space rank, and their halos ----


@pytest.mark.parametrize("k,s,p,rows", [
    (7, 2, 3, (3, 2)),          # conv1
    (3, 1, 1, (1, 1)),          # block and decoder 3×3 convs
    (3, 2, 1, (1, 0)),          # stride-2 3×3 convs and the max pool
    (1, 2, 0, (0, 0)),          # the 1×1/2 shortcut
    (1, 1, 0, (0, 0))])         # 1×1 convs
def test_halo_rows(k, s, p, rows):
    assert spatial.halo_rows(k, s, p) == rows


@pytest.mark.parametrize("h0,levels", [
    (32, (True,) * 6),                              # 64² over 2
    (16, (True,) * 5 + (False,)),                   # 32² over 2
    (8, (True,) * 4 + (False,) * 2),                # 32² over 4
    (2, (True,) + (False,) * 5),                    # conv1's halo of 3
    (9, (True,) + (False,) * 5)])                   # odd: misaligned
def test_plan(h0, levels):
    assert spatial.plan(h0) == levels


ONE = comm.Space(None, 0, 1)     # one space rank: no collective


def _conv(k, s, p):
    torch.manual_seed(k * 10 + s)
    return spatial.Conv2d(3, 4, k, s, p).double()


@pytest.mark.parametrize("k,s,p", [(7, 2, 3), (3, 1, 1), (3, 2, 1),
                                   (1, 2, 0)])
def test_conv_on_one_rank_is_plain(k, s, p):
    conv = _conv(k, s, p)
    x = torch.from_numpy(np.random.RandomState(k).randn(2, 3, 8, 10))
    with comm.spatial(ONE):
        got = conv(x)
    torch.testing.assert_close(got, F.conv2d(x, conv.weight, conv.bias, s,
                                             p), rtol=1e-12, atol=1e-12)


def test_pool_upsample_mean_on_one_rank_are_plain():
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 8, 6))
    with comm.spatial(ONE):
        pool = spatial.max_pool2d(x, 3, 2, 1)
        up = spatial.upsample_linear(x, 4)
        mean = spatial.mean_hw(x)
        same = spatial.split(spatial.gather(x, ONE), ONE)
    assert torch.equal(pool, F.max_pool2d(x, 3, 2, 1))
    torch.testing.assert_close(up, resize_linear(x, 32, 24), rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(mean, x.mean(dim=(2, 3)), rtol=1e-12,
                               atol=1e-12)
    assert torch.equal(same, x)


@pytest.mark.parametrize("family", ["Unet", "Linknet", "FPN", "PSPNet"])
def test_ynet_on_one_rank_is_plain(family):
    """A train-mode Y-Net forward inside ``comm.spatial`` at one space
    rank equals the plain forward."""
    from wsiseg_tpu_torch.parallel.checks import seeded_ynet, train_cfg
    net = seeded_ynet(train_cfg(model_name=family)).double().train()
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 3, 32, 32))
    ref = net(x)
    with comm.spatial(ONE):
        got = net(x)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=1e-10, atol=1e-10)
