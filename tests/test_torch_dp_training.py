"""Data-parallel training of the port over two gloo CPU ranks against
the port's single-device step and, for three cases, against the JAX
package's step on the same weights and batch, in f64 with sgd: loss,
metrics, parameters and BatchNorm running statistics within
1e-9·max(1, |ref|), every rank.

- the hybrid step on a batch split so that rank 0 holds only cls/reg
  rows and rank 1 only seg rows (per-rank loss normalizers would differ);
- the seg step with dice and with OHEM (ranked over the global batch);
- the cls step and the HR region-ensemble step;
- ``grad_accum=2`` at batch 8 (each rank holds its share of each
  microbatch);
- one ``Trainer`` epoch with the color jitter, history and parameters;
- a global batch that does not divide over the ranks raises.

The uneven hybrid step, the OHEM seg step and ``grad_accum=2`` start from
f64 flax variables (``test_torch_train_step.random_variables``, through
``from_flax``) and are also held against JAX's single-device step
(``test_torch_train_step.jax_step``, which GSPMD's data-parallel step
equals) from the same variables: global BatchNorm moments, global loss
normalizers, OHEM's global ranking and the microbatch row order, each
against JAX directly.

One group of ranks runs every port case
(``torch_rank_cases.dp_training_cases``) in a module-scope fixture while
this process computes the JAX steps, and then ``train --mesh 2`` end to
end. (The other trainers share its path: ``chip_smoke.py`` phase
``[6j]`` runs ``train-cellularity``, ``train-p``, ``train-ssr`` at its
512² and ``train-hr`` with its 33.5 M-weight ensemble, each with
``--mesh 2`` on two ranks sharing the card.)"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_rank_cases as rc
from test_torch_train_data import make_store
from test_torch_train_step import (CW, SW, assert_step_close, configs,
                                   jax_f64, jax_step, random_variables)
from wsiseg_tpu.models.ynet import build_ynet as jax_build_ynet
from wsiseg_tpu_torch.models.flax_import import from_flax
from wsiseg_tpu_torch.parallel import launch

torch.set_num_threads(2)

REL = 1e-9                              # × max(1, |ref|), float64
SEED = 0                                # the flax variables' seed


def _jax_batch(batch):
    return {k: v.astype(np.int32) if v.dtype == np.int64 else v
            for k, v in batch.items()}


def _jax_reference(case, given):
    """JAX's single-device f64 step of ``case`` (``rc.JAX_CASES``) from
    the seed's variables (``given``, as a port state_dict): (metrics, new
    state as a port state_dict)."""
    make_batch, kw, ga = rc.JAX_CASES[case]
    jcfg, _ = configs(**kw)
    batch = _jax_batch(make_batch(given))
    if case.startswith("seg"):
        _, jm, sd = jax_step("seg", jcfg, batch, ga, SEED,
                             class_weights=SW)
    else:
        _, jm, sd = jax_step("hybrid", jcfg, batch, ga, SEED,
                             cls_weights=CW, seg_weights=SW)
    return jm, sd


@pytest.fixture(scope="module")
def ck_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("ck")


@pytest.fixture(scope="module")
def run(tmp_path_factory, ck_dir):
    """(the ranks' results, {case: JAX reference}): the ranks run in a
    thread while this process computes the JAX steps."""
    store = make_store(str(tmp_path_factory.mktemp("store")), n=16,
                       sizes=((32, 32),))
    with jax_f64():
        variables = random_variables(jax_build_ynet(configs()[0]), SEED)
    given = from_flax(variables)
    with ThreadPoolExecutor(max_workers=1) as pool:
        ranks = pool.submit(launch.run_ranks, rc.dp_training_cases, 2,
                            "cpu", args=(given, store, str(ck_dir)),
                            threads=1)
        refs = {case: _jax_reference(case, given) for case in rc.JAX_CASES}
        return ranks.result(), refs


@pytest.fixture(scope="module")
def cases(run):
    return run[0]


@pytest.mark.parametrize("case", ["hybrid_uneven", "seg_dice", "seg_ohem",
                                  "cls", "hr", "grad_accum2",
                                  "trainer_epoch"])
def test_dp_step_matches_single_device(cases, case):
    assert cases[case] <= REL, cases[case]


@pytest.mark.parametrize("case", list(rc.JAX_CASES))
def test_dp_step_matches_jax(run, case):
    """The port's data-parallel step (rank 0's replica; the spread over
    the ranks is in ``test_dp_step_matches_single_device``) against JAX's
    step on the same variables and global batch."""
    cases, refs = run
    metrics, state = cases[f"{case}_dp"]
    jm, ref_sd = refs[case]
    assert_step_close(jm, ref_sd, metrics,
                      {k: torch.from_numpy(v) for k, v in state.items()})


def test_trainer_refuses_indivisible_batch(cases):
    assert cases["trainer_history_keys"]
    assert cases["indivisible_raises"]


def test_train_cli_mesh_runs_over_gloo(cases, ck_dir):
    """``train --device cpu --mesh 2`` in the group (as under
    ``torchrun``) trains an epoch, each rank decoding only its rows: rank
    0's history, its checkpoint. (The CLI spawns its ranks when no group
    runs: tests/test_torch_eval.py's ``eval --sharded``.)"""
    hist = cases["train_cli"]
    assert [r["epoch"] for r in hist] == [1]
    assert np.isfinite(hist[0]["loss"])
    assert sorted(f for f in os.listdir(ck_dir) if f.endswith(".pt")) == [
        os.path.basename(hist[0]["checkpoint"])]

