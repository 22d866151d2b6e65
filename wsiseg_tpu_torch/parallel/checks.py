"""Cross-rank checks of data-parallel and spatial training: what a rank
of a group (``parallel.launch.run_ranks(fn, world, device)``) runs to
hold the data-parallel or (data, space) step against the single-device
step on the same seeded inputs, and the ranks of ``chip_smoke.py``
phases ``[6j]`` (:func:`card_training_cases`) and ``[6k]``
(:func:`card_spatial_cases`). The tests' rank functions build on these
helpers; ``parallel.dryrun`` takes :func:`rank_mesh` and
:func:`spatial_mesh`.

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
from wsiseg_tpu_torch.parallel.mesh import (make_mesh, mesh_index,
                                            mesh_size, replicate_tree,
                                            shard_batch, shard_batch_spatial,
                                            space_size)

F64 = torch.float64
#: hybrid-step class weights (cls, seg), as tests/test_torch_train_step.py
CW = np.array([0.3, 1.0, 0.6, 0.8])
SW = np.array([1.0, 0.5, 0.9, 0.7])


def rank_mesh(device):
    """A 1-D ``data`` mesh over the whole group, on this rank's device."""
    return make_mesh(devices=[device] * dist.get_world_size())


def spatial_mesh(device, n_data: int, n_space: int):
    """An (n_data, n_space) ``("data", "space")`` mesh over the group's
    first n_data·n_space ranks, on this rank's device (every rank of the
    group calls it; the others are outside the mesh)."""
    return make_mesh(devices=[device] * dist.get_world_size(),
                     shape=(n_data, n_space), axes=("data", "space"))


def in_mesh(mesh) -> bool:
    """Whether this rank is one of the mesh's."""
    return mesh.get_coordinate() is not None


def max_over_ranks(x: float, device, mesh=None) -> float:
    """The largest ``x`` over the mesh's ranks (default: the group's)."""
    t = torch.tensor([float(x)], dtype=F64, device=device)
    if dist.is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.MAX,
                        group=None if mesh is None else comm.as_group(mesh))
    return float(t.item())


def rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| / max(1, |b|)."""
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs_().div_(b.abs().clamp_(min=1.0)).max().item())


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
    """The largest relative spread over the mesh's ranks of each state
    entry's Σx² (0 when every rank holds the same replica)."""
    sums = torch.stack([t.detach().double().pow(2).sum() for k, t in
                        model.state_dict().items()
                        if t.is_floating_point()]).to(device)
    every = comm.gather_slots(sums, comm.as_group(mesh))
    return float(((every - every[0]).abs()
                  / every[0].abs().clamp(min=1.0)).max())


def single_step(make_model: Callable, make_step: Callable, cfg,
                batch: Dict, device, grad_accum: int = 1):
    """The step on the full batch on one device: (the model after it, its
    metrics)."""
    from wsiseg_tpu_torch.optim import build_optimizer
    from wsiseg_tpu_torch.train.state import TrainState
    dev = torch.device(device)
    ref = make_model(cfg, dev)
    st_ref = TrainState(ref, build_optimizer(cfg, ref.parameters()))
    return ref, make_step(ref, cfg, grad_accum)(st_ref, on_device(batch, dev))


def is_owner(mesh, owner: int) -> bool:
    """Whether this rank is the mesh's rank ``owner`` (mod its size)."""
    return mesh.get_coordinate() is not None and \
        mesh_index(mesh) == owner % mesh.size()


def step_pair(mesh, device, make_model: Callable, make_step: Callable, cfg,
              batch: Dict, grad_accum: int = 1, owner: int = 0,
              reference=None):
    """One optimizer step over ``mesh`` (this rank's rows, in microbatch
    order, and on a (data, space) mesh its stripe of them) against the
    same step on the full batch on one device (:func:`single_step`),
    which the mesh's rank ``owner`` alone computes (the ranks share the
    work of the references), unless it passes it as ``reference``.
    Returns (the largest relative difference of the metrics, the
    parameters and the BatchNorm statistics, and the replicas' spread
    over the ranks; the mesh's model; its metrics as floats)."""
    from wsiseg_tpu_torch.optim import build_optimizer
    from wsiseg_tpu_torch.train.state import TrainState
    dev = torch.device(device)
    dp = make_model(cfg, dev)
    st_dp = replicate_tree(mesh, TrainState(
        dp, build_optimizer(cfg, dp.parameters())))
    shard = shard_batch_spatial if space_size(mesh) > 1 else shard_batch
    local = shard(mesh, batch, microbatches=grad_accum)
    with comm.data_parallel(mesh), comm.spatial(mesh):
        m_dp = make_step(dp, cfg, grad_accum)(st_dp, local)
    worst = replica_spread(dp, mesh, dev)
    if is_owner(mesh, owner):
        ref, m_ref = reference or single_step(make_model, make_step, cfg,
                                              batch, dev, grad_accum)
        worst = max([worst, state_diff(ref, dp)]
                    + [rel_diff(m_dp[k], m_ref[k]) for k in m_ref])
    return (max_over_ranks(worst, dev, mesh), dp,
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
    # phase [6k] e: the same group as one data row of two stripes
    spatial = common[:3] + ["1x2"] + common[4:]
    out["train_1x2"] = main(
        ["train", "--train_image_pth", ynet_store, "--raw_val_pth", "",
         "--tile_w", "32", "--tile_h", "32"] + spatial).history
    out["train_hr_1x2"] = main(
        ["train-hr", "--train_hr_image_pth", hr_store, "--val_hr_image_pth",
         ""] + spatial).history
    return out


def _launches() -> int:
    """The port's kernel launches counted in this rank so far."""
    from wsiseg_tpu_torch.ops import conv9, stem
    return stem.LAUNCHES + stem.STEM_CONV_LAUNCHES + sum(
        conv9.LAUNCHES.values())


def _metrics_rel(got: Dict, ref: Dict) -> float:
    return max(abs(float(got[k]) - float(v)) / max(1.0, abs(float(v)))
               for k, v in ref.items())


def _adam_steps(mesh, dev, cfg, host: Dict, n: int):
    """``n`` hybrid steps (adam) of the seed-0 resnet18 Unet on ``host``,
    over ``mesh`` (None: one device): (losses, ms a step after the first,
    peak device GB)."""
    import time

    from wsiseg_tpu_torch.optim import build_optimizer
    from wsiseg_tpu_torch.train.state import TrainState
    from wsiseg_tpu_torch.train.steps import make_hybrid_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = seeded_ynet(cfg).to(dev).to(memory_format=torch.channels_last)
    state = TrainState(model, build_optimizer(cfg, model.parameters()))
    if mesh is None:
        batch = on_device(host, dev)
    else:
        replicate_tree(mesh, state)
        batch = shard_batch_spatial(mesh, host)
    step = make_hybrid_train_step(model, cfg)
    losses, t0 = [], 0.0
    for i in range(n):
        if i == 1:
            torch.cuda.synchronize(dev)
            t0 = time.time()
        with comm.data_parallel(mesh), comm.spatial(mesh):
            losses.append(float(step(state, batch)["loss"]))
    torch.cuda.synchronize(dev)
    ms = (time.time() - t0) / max(1, n - 1) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    del state, model, batch
    torch.cuda.empty_cache()
    return losses, ms, peak


def card_spatial_cases(device, big: int = 2048) -> Dict[str, object]:
    """The ranks of ``chip_smoke.py`` phase ``[6k]`` (four sharing one
    card, over gloo), each case against the single-device step on the
    card:

    a. the f64 sgd hybrid step (resnet18 Unet, 64², batch 4) on (2, 2):
       metrics, parameters and running statistics (:func:`step_pair`);
    b. full width in f32 (TF32 off): resnet18 Unet hybrid, 512², batch
       4, step 1's metrics of every rank on (2, 2) and on (1, 4) (rank 0
       computes the single-device step, after the meshes' steps);
    c. spatial's purpose: ``big``² tiles, batch 2, bf16 autocast, adam, 3
       steps on (1, 4): the losses, each rank's peak device memory and
       ms a step, beside the single-device step's (rank 0 runs it
       alone, after the mesh's steps);

    and the kernel launches of every rank (none expected)."""
    dev = torch.device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    before = _launches()
    meshes = {"2x2": spatial_mesh(dev, 2, 2), "1x4": spatial_mesh(dev, 1, 4)}
    out: Dict[str, object] = {"f64": step_pair(
        meshes["2x2"], dev, ynet_f64, hybrid_step,
        train_cfg(tile_w=64, tile_h=64), hybrid_batch("crss", tile=64))[0]}

    cfg = train_cfg(tile_w=512, tile_h=512, compute_dtype="float32",
                    norm_dtype="float32", param_dtype="float32")
    host = {k: v.astype(np.float32) if v.dtype == np.float64 else v
            for k, v in hybrid_batch("crss", seed=7, tile=512).items()}
    from wsiseg_tpu_torch.optim import build_optimizer
    from wsiseg_tpu_torch.train.state import TrainState
    every = {}
    for name, mesh in meshes.items():
        net = replicate_tree(mesh, seeded_ynet(cfg).to(dev))
        st = TrainState(net, build_optimizer(cfg, net.parameters()))
        with comm.data_parallel(mesh), comm.spatial(mesh):
            got = hybrid_step(net, cfg, 1)(st, shard_batch_spatial(mesh,
                                                                   host))
        keys = sorted(got)
        every[name] = comm.gather_slots(
            torch.stack([got[k].detach().double() for k in keys]),
            comm.as_group(mesh)).cpu()
        del net, st, got
    if dist.get_rank() == 0:    # the reference once, on the card alone
        ref = seeded_ynet(cfg).to(dev)
        ref_m = hybrid_step(ref, cfg, 1)(
            TrainState(ref, build_optimizer(cfg, ref.parameters())),
            on_device(host, dev))
        del ref
        for name, got in every.items():
            out[f"f32_{name}"] = max(
                _metrics_rel(dict(zip(keys, row.tolist())), ref_m)
                for row in got)
            out[f"f32_{name}_loss"] = (float(got[0, keys.index("loss")]),
                                       float(ref_m["loss"]))
    dist.barrier()

    bcfg = default_config(tile_w=big, tile_h=big, batch_size=2,
                          compute_dtype="bfloat16", optim="adam")
    host = {k: v.astype(np.float32) if v.dtype == np.float64 else v
            for k, v in hybrid_batch("cs", seed=8, tile=big).items()}
    losses, ms, peak = _adam_steps(meshes["1x4"], dev, bcfg, host, 3)
    peaks = comm.gather_slots(torch.tensor([peak, ms], dtype=F64,
                                           device=dev),
                              comm.as_group(meshes["1x4"])).cpu().tolist()
    out["big"] = {"losses": losses, "rank_peak_gb": [p for p, _ in peaks],
                  "rank_ms": [m for _, m in peaks]}
    if dist.get_rank() == 0:
        losses1, ms1, peak1 = _adam_steps(None, dev, bcfg, host, 3)
        out["big"].update(single_losses=losses1, single_ms=ms1,
                          single_peak_gb=peak1)
    dist.barrier()
    out["launches"] = max_over_ranks(_launches() - before, dev)
    return out
