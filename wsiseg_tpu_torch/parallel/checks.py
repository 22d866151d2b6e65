"""Cross-rank checks of data-parallel training: what a rank of a group
(``parallel.launch.run_ranks(fn, world, device)``) runs to hold the
data-parallel step against the single-device step on the same seeded
inputs, and the ranks of ``chip_smoke.py`` phase ``[6j]``
(:func:`card_training_cases`). The tests' rank functions build on these
helpers; ``parallel.dryrun`` takes :func:`rank_mesh`.

Differences are reported as the largest over every rank (each rank holds
its own replica).
"""

from __future__ import annotations

import copy
import functools
from typing import Callable, Dict

import numpy as np
import torch
import torch.distributed as dist

from wsiseg_tpu_torch.config import default_config
from wsiseg_tpu_torch.parallel import comm
from wsiseg_tpu_torch.parallel.mesh import (make_mesh, mesh_group,
                                            mesh_rank, mesh_size,
                                            replicate_tree, shard_batch)

F64 = torch.float64
#: hybrid-step class weights (cls, seg), as tests/test_torch_train_step.py
CW = np.array([0.3, 1.0, 0.6, 0.8])
SW = np.array([1.0, 0.5, 0.9, 0.7])


def rank_mesh(device):
    """A 1-D ``data`` mesh over the whole group, on this rank's device."""
    return make_mesh(devices=[device] * dist.get_world_size())


def max_over_ranks(x: float, device) -> float:
    t = torch.tensor([float(x)], dtype=F64, device=device)
    if dist.is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| / max(1, |b|)."""
    a, b = a.detach().double(), b.detach().double()
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max().item())


def on_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def train_cfg(**kw):
    """The f64 sgd config of the data-parallel cases (32² tiles, batch
    4), as tests/test_torch_train_step.py's."""
    common = dict(tile_w=32, tile_h=32, compute_dtype="float64",
                  norm_dtype="float64", param_dtype="float64", optim="sgd",
                  lr=1e-2, weight_decay=1e-4, batch_size=4, save_models=0,
                  validate_model=0)
    common.update(kw)
    return default_config(**common)


@functools.lru_cache(maxsize=None)
def _ynet_init(model_name: str, arch: str, num_classes: int, seed: int):
    from wsiseg_tpu_torch.models.ynet import build_ynet
    torch.manual_seed(seed)
    return build_ynet(default_config(model_name=model_name,
                                     arch_encoder=arch,
                                     num_classes=num_classes)).eval()


def seeded_ynet(cfg, seed: int = 0):
    """A Y-Net of ``cfg``'s family with torch's default init after
    ``torch.manual_seed(seed)`` (every rank draws the same; ~0.1 s, where
    the flax-style ``init_ynet`` takes ~1 s), built once a rank."""
    return copy.deepcopy(_ynet_init(cfg.model_name, cfg.arch_encoder,
                                    cfg.num_classes, seed))


def ynet_f64(cfg, device):
    """The seed-0 Y-Net of ``cfg``'s family in f64."""
    return seeded_ynet(cfg).to(device, F64)


def state_diff(ref: torch.nn.Module, got: torch.nn.Module) -> float:
    ref_sd, got_sd = ref.state_dict(), got.state_dict()
    return max(rel_diff(got_sd[k], ref_sd[k]) for k in ref_sd
               if not k.endswith("num_batches_tracked"))


def replica_spread(model: torch.nn.Module, mesh, device) -> float:
    """The largest relative spread over the ranks of each state entry's
    Σx² (0 when every rank holds the same replica)."""
    sums = torch.stack([t.detach().double().pow(2).sum() for k, t in
                        model.state_dict().items()
                        if t.is_floating_point()]).to(device)
    every = comm.gather_slots(sums, mesh_group(mesh))
    return float(((every - every[0]).abs()
                  / every[0].abs().clamp(min=1.0)).max())


def step_pair(mesh, device, make_model: Callable, make_step: Callable, cfg,
              batch: Dict, grad_accum: int = 1, owner: int = 0):
    """One optimizer step data-parallel over ``mesh`` (this rank's rows,
    in microbatch order) against the same step on the full batch on one
    device, which rank ``owner`` alone computes (the ranks share the
    work of the references). Returns (the largest relative difference of
    the metrics, the parameters and the BatchNorm statistics, and the
    replicas' spread over the ranks; the data-parallel model; its
    metrics as floats)."""
    from wsiseg_tpu_torch.optim import build_optimizer
    from wsiseg_tpu_torch.train.state import TrainState
    dev = torch.device(device)
    dp = make_model(cfg, dev)
    st_dp = replicate_tree(mesh, TrainState(
        dp, build_optimizer(cfg, dp.parameters())))
    local = shard_batch(mesh, batch, microbatches=grad_accum)
    with comm.data_parallel(mesh):
        m_dp = make_step(dp, cfg, grad_accum)(st_dp, local)
    worst = replica_spread(dp, mesh, dev)
    if mesh_rank(mesh) == owner % mesh_size(mesh):
        ref = make_model(cfg, dev)
        st_ref = TrainState(ref, build_optimizer(cfg, ref.parameters()))
        m_ref = make_step(ref, cfg, grad_accum)(st_ref,
                                                on_device(batch, dev))
        worst = max([worst, state_diff(ref, dp)]
                    + [rel_diff(m_dp[k], m_ref[k]) for k in m_ref])
    return (max_over_ranks(worst, dev), dp,
            {k: float(v) for k, v in m_dp.items()})


def hybrid_step(model, cfg, ga):
    from wsiseg_tpu_torch.train.steps import make_hybrid_train_step
    return make_hybrid_train_step(model, cfg, cls_weights=CW,
                                  seg_weights=SW, grad_accum=ga)


def hybrid_batch(rows: str, seed: int = 3, tile: int = 32) -> Dict:
    """Normalized f64 rows, one task each, in the order ``rows`` spells
    (c cls, r reg, s seg)."""
    rs = np.random.RandomState(seed)
    b = len(rows)
    task = np.array([list("crs").index(c) for c in rows])
    return {
        "image": rs.randn(b, tile, tile, 3),
        "seg_label": rs.randint(0, 4, (b, tile, tile)).astype(np.int64),
        "cls_label": np.where(task == 0, rs.randint(0, 4, b), -1),
        "reg_label": np.where(task == 1, rs.rand(b), 0.0),
        "is_cls": (task == 0).astype(np.float64),
        "is_reg": (task == 1).astype(np.float64),
        "is_seg": (task == 2).astype(np.float64),
    }


def card_training_cases(device, ynet_store: str, ssr_dir: str,
                        hr_store: str, out_dir: str) -> Dict[str, object]:
    """The ranks of ``chip_smoke.py`` phase ``[6j]`` (two sharing one
    card): the f64 sgd hybrid step data-parallel against the
    single-device step, and one ``--mesh 2`` epoch of ``train-cellularity``
    and ``train-p`` (on ``ynet_store``), ``train-ssr`` (512² regions) and
    ``train-hr`` (the region ensemble), whose histories come back."""
    from wsiseg_tpu_torch.__main__ import main
    mesh = rank_mesh(device)
    out: Dict[str, object] = {"hybrid_f64": step_pair(
        mesh, device, ynet_f64, hybrid_step, train_cfg(),
        hybrid_batch("crss"))[0]}
    common = ["--device", "cuda" if torch.device(device).type == "cuda"
              else "cpu", "--mesh", str(mesh_size(mesh)), "--batch_size",
              "4", "--num_epoch", "1", "--save_models", "0",
              "--model_save_pth", out_dir]
    for cmd in ("train-cellularity", "train-p"):
        out[cmd.replace("-", "_")] = main(
            [cmd, "--train_image_pth", ynet_store, "--val_image_pth", "",
             "--tile_w", "32", "--tile_h", "32"] + common).history
    out["train_ssr"] = main(["train-ssr", "--train_image_pth", ssr_dir,
                             "--val_image_pth", ""] + common).history
    out["train_hr"] = main(["train-hr", "--train_hr_image_pth", hr_store,
                            "--val_hr_image_pth", ""] + common).history
    return out
