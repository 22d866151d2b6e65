"""The rank functions of the port's multi-rank tests: what each rank of a
group (``parallel.launch.run_ranks(fn, world, device)``) runs, holding a
multi-rank path of the port against its single-device path on the same
seeded inputs and returning plain numbers and numpy arrays (rank 0's).

A spawned rank imports the module of its function, so this module
imports nothing of JAX (the test modules do, and set ``XLA_FLAGS``): only
torch, numpy and the port. ``tests/test_torch_parallel.py``,
``test_torch_dp_training.py``, ``test_torch_spatial_training.py``,
``test_torch_sharded_inference.py`` and ``test_torch_engine.py`` assert
on its results.

Differences are reported as the largest over every rank (each rank holds
its own replica and its own single-device reference).
"""

from __future__ import annotations

import copy
import functools
import os
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch

from wsiseg_tpu_torch import losses
from wsiseg_tpu_torch.config import default_config
from wsiseg_tpu_torch.parallel import comm
from wsiseg_tpu_torch.parallel.checks import (CW, F64, SW, hybrid_batch,
                                              hybrid_step, in_mesh, is_owner,
                                              max_over_ranks, rank_mesh,
                                              rel_diff, replica_spread,
                                              seeded_ynet, single_step,
                                              spatial_mesh, state_diff,
                                              step_pair, train_cfg, ynet_f64)
from wsiseg_tpu_torch.parallel.mesh import (batch_rows, mesh_group,
                                            mesh_index, mesh_rank, mesh_size,
                                            replicate_tree, shard_batch)


def loaded_roots(device) -> list:
    """The top-level names of every module loaded in this rank."""
    del device
    return sorted({k.split(".")[0] for k in sys.modules})


# ---- collectives, BatchNorm and the losses ----


def parallel_cases(device) -> Dict[str, object]:
    """The mesh and the collectives, then global BatchNorm and every loss
    under ``data_parallel`` against the single-device result on the full
    batch: value, and this rank's input gradient (which carries the world
    size factor, ``parallel.comm``) divided by the world size."""
    from wsiseg_tpu_torch.models.resnet import BatchNorm2d
    mesh = rank_mesh(device)
    g, r, n = mesh_group(mesh), mesh_rank(mesh), mesh_size(mesh)
    out: Dict[str, object] = {"world": n,
                              "dims": tuple(mesh.mesh_dim_names)}
    dev = torch.device(device)

    x = torch.full((2,), float(r + 1), dtype=F64, device=dev,
                   requires_grad=True)
    with comm.data_parallel(mesh):
        y = comm.global_sum((x * x).sum())
    y.backward()
    out["global_sum"] = float(y.detach())
    out["global_sum_grad"] = x.grad.cpu().numpy()        # 2·n·x
    out["gather"] = comm.gather_slots(
        torch.full((3,), r + 1, dtype=torch.uint8, device=dev), g) \
        .cpu().numpy()
    out["gather_objects"] = comm.gather_objects({"rank": r}, g)
    out["shift1"] = comm.gather_slots(comm.shift(
        torch.full((2,), float(r + 1), device=dev), 1, g), g).cpu().numpy()
    out["rows_ga2"] = batch_rows(mesh, 8, microbatches=2)
    try:
        batch_rows(mesh, 6, microbatches=2)
        out["indivisible_raises"] = False
    except ValueError:
        out["indivisible_raises"] = True
    sb = shard_batch(mesh, {"a": np.arange(8), "rng": np.arange(2)})
    out["shard_rows"] = sb["a"].cpu().numpy()
    out["shard_rng"] = sb["rng"].cpu().numpy()
    lin = torch.nn.Linear(3, 2).to(dev)
    with torch.no_grad():
        lin.weight.fill_(float(r))
    replicate_tree(mesh, lin)
    out["replicated_weight"] = float(lin.weight.detach().abs().max())

    rs = np.random.RandomState(7)
    b = 4 * n
    rows = torch.as_tensor(batch_rows(mesh, b), device=dev)

    # BatchNorm: forward, running statistics, x and affine gradients
    xs = torch.from_numpy(rs.randn(b, 5, 3, 3)).to(dev)
    wt = torch.from_numpy(rs.randn(b, 5, 3, 3)).to(dev)
    ref_bn = BatchNorm2d(5).to(dev, F64).train()
    dp_bn = BatchNorm2d(5).to(dev, F64).train()
    xr = xs.clone().requires_grad_(True)
    (ref_bn(xr) * wt).sum().backward()
    xl = xs[rows].clone().requires_grad_(True)
    with comm.data_parallel(mesh):
        yl = dp_bn(xl)
        comm.global_sum((yl * wt[rows]).sum()).backward()
    comm.all_reduce_grads(dp_bn.parameters(), g)
    out["batchnorm"] = max_over_ranks(max(
        rel_diff(xl.grad / n, xr.grad[rows]),
        rel_diff(dp_bn.weight.grad, ref_bn.weight.grad),
        rel_diff(dp_bn.bias.grad, ref_bn.bias.grad),
        rel_diff(dp_bn.running_mean, ref_bn.running_mean),
        rel_diff(dp_bn.running_var, ref_bn.running_var)), dev)

    # every loss: value and logits gradient
    logits = torch.from_numpy(rs.randn(b, 4, 16, 16)).to(dev)
    targets = torch.from_numpy(rs.randint(0, 4, (b, 16, 16))).to(dev)
    sw = torch.from_numpy((rs.rand(b) > 0.4).astype(np.float64)).to(dev)
    pred = torch.from_numpy(rs.rand(b)).to(dev)
    tgt = torch.from_numpy(rs.rand(b)).to(dev)
    dense = {
        "xent": lambda lg, t, w: losses.cross_entropy(
            lg, t, class_weights=CW, sample_weight=w),
        "focal": lambda lg, t, w: losses.focal(lg, t, class_weights=CW,
                                               sample_weight=w),
        "ohem": lambda lg, t, w: losses.ohem(lg, t, scale_factor=0.25,
                                             sample_weight=w),
        "cent": lambda lg, t, w: losses.conditional_entropy_ce(
            lg, t, sample_weight=w),
        "dice": lambda lg, t, w: losses.dice(lg, t, class_weights=CW,
                                             sample_weight=w),
        "jaccard": lambda lg, t, w: losses.jaccard(lg, t, sample_weight=w),
        "tversky": lambda lg, t, w: losses.tversky(lg, t, sample_weight=w),
        "xent_plain": lambda lg, t, w: losses.cross_entropy(lg, t),
        "ohem_plain": lambda lg, t, w: losses.ohem(lg, t,
                                                   scale_factor=0.25),
    }
    for name, fn in dense.items():
        out[f"loss_{name}"] = max_over_ranks(_loss_diff(
            mesh, lambda v, idx: fn(v, targets[idx], sw[idx]), logits,
            rows, n), dev)
    for name in ("mse", "l1", "logcosh", "xtanh", "xsigmoid", "rmse"):
        fn = losses.loss_fn(name)
        out[f"loss_{name}"] = max_over_ranks(_loss_diff(
            mesh, lambda v, idx, fn=fn: fn(v, tgt[idx],
                                           sample_weight=sw[idx]),
            pred, rows, n), dev)
    out["loss_bce"] = max_over_ranks(_loss_diff(
        mesh, lambda v, idx: losses.bce(torch.sigmoid(v), tgt[idx] > 0.5),
        pred, rows, n), dev)
    return out


def _loss_diff(mesh, fn: Callable, values: torch.Tensor, rows, n) -> float:
    """``fn(values, all rows)`` on one device against ``fn(values[rows],
    rows)`` under ``data_parallel``: value and gradient."""
    full = values.clone().requires_grad_(True)
    ref = fn(full, slice(None))
    ref.backward()
    local = values[rows].clone().requires_grad_(True)
    with comm.data_parallel(mesh):
        got = fn(local, rows)
        got.backward()
    return max(rel_diff(got, ref), rel_diff(local.grad / n,
                                            full.grad[rows]))


# ---- data-parallel training ----


def _seg_step(model, cfg, ga):
    from wsiseg_tpu_torch.train.steps import make_seg_train_step
    return make_seg_train_step(model, cfg, class_weights=SW, grad_accum=ga)


def _cls_step(model, cfg, ga):
    from wsiseg_tpu_torch.train.steps import make_cls_train_step
    return make_cls_train_step(model, cfg, class_weights=CW, grad_accum=ga)


def _hr_step(model, cfg, ga):
    from wsiseg_tpu_torch.train.steps import make_hr_train_step
    return make_hr_train_step(model, cfg, class_weights=CW, grad_accum=ga)


@functools.lru_cache(maxsize=None)
def _hr_init(arch: str, num_classes: int, num_patches: int):
    from wsiseg_tpu_torch.models.ensemble import MultiPatchResNet
    torch.manual_seed(0)
    return MultiPatchResNet(arch, num_classes, num_patches=num_patches)


def _hr_net(cfg, device, num_patches: int = 2):
    """The seed-0 HR ensemble in f64, built once a rank (its ``fc_1`` at
    16 patches has 33.5 M parameters)."""
    return copy.deepcopy(_hr_init(cfg.arch_encoder, cfg.num_classes,
                                  num_patches)).to(device, F64)


def _given_ynet(state_dict, cfg, device):
    """The Y-Net of ``cfg``'s family holding ``state_dict``, in f64."""
    from wsiseg_tpu_torch.models.ynet import build_ynet
    net = build_ynet(cfg).to(F64)
    net.load_state_dict(state_dict)
    return net.to(device)


def seg_batch(rs=None) -> Dict:
    """The seg cases' batch, the first draws of ``RandomState(11)`` (or of
    ``rs``): normalized f64 images, int labels."""
    rs = np.random.RandomState(11) if rs is None else rs
    return {"image": rs.randn(4, 32, 32, 3),
            "seg_label": rs.randint(0, 4, (4, 32, 32)).astype(np.int64)}


def publish_state(state_dict, path: str) -> None:
    """Write ``state_dict`` to ``path`` whole (a rename after the write),
    for :func:`await_state` in the ranks."""
    torch.save(state_dict, path + ".part")
    os.replace(path + ".part", path)


def await_state(path: str, timeout: float = 600.0):
    """The state_dict :func:`publish_state` writes to ``path``, once it is
    there (the test process computes it while the ranks start)."""
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout:
            raise TimeoutError(f"no state at {path} after {timeout} s")
        time.sleep(0.05)
    return torch.load(path)


def ohem_batch(given) -> Dict:
    """:func:`seg_batch`'s images, each labelled everywhere with the class
    that the ``given`` Y-Net (in train mode, as the step runs it) finds
    most likely on it for rows 0-1 and least likely for rows 2-3: the
    hardest pixels lie on rank 1, so OHEM ranked on each rank would
    average other pixels than the global ranking does."""
    b = seg_batch()
    net = _given_ynet(given, train_cfg(), "cpu").train()
    with torch.no_grad():
        p = torch.softmax(net.segment(torch.from_numpy(b["image"]).permute(
            0, 3, 1, 2)), dim=1).mean(dim=(2, 3))
    pick = torch.cat([p[:2].argmax(1), p[2:].argmin(1)]).numpy()
    b["seg_label"] = np.broadcast_to(pick[:, None, None],
                                     b["seg_label"].shape).copy()
    return b


#: the cases held against JAX's step too: (batch from the ``given``
#: weights, config overrides, grad_accum), on ``dp_training_cases``'
#: ``given`` weights
JAX_CASES = {
    "hybrid_uneven": (lambda given: hybrid_batch("crss"), {}, 1),
    "seg_ohem": (ohem_batch, {"loss": "ohem"}, 1),
    "grad_accum2": (lambda given: hybrid_batch("csrscssr", seed=5),
                    {"batch_size": 8, "grad_accum": 2}, 2),
}


def dp_training_cases(device, given, store: str = "",
                      out_dir: str = "") -> Dict[str, object]:
    """Every data-parallel training case against the single-device step
    (f64, sgd): the largest relative difference of each. The cases of
    :data:`JAX_CASES` start from the f64 ``given`` weights (a Unet
    state_dict: the tests hold them against JAX's step from the same
    flax variables) and also return the data-parallel metrics and new
    state (``<case>_dp``). With a gt.npy ``store``, then ``train --mesh
    <world>`` in this group (as under ``torchrun``), one epoch
    checkpointed into ``out_dir``: its history (``train_cli``). Needs a
    world of 2 (rank 0 holds the hybrid case's cls/reg rows, rank 1 its
    seg rows: per-rank normalizers would differ from the global ones)."""
    mesh = rank_mesh(device)
    rs = np.random.RandomState(11)
    seg = seg_batch(rs)
    out: Dict[str, object] = {}
    made = functools.partial(_given_ynet, given)
    for k, (case, (batch, kw, ga)) in enumerate(JAX_CASES.items()):
        step = _seg_step if case.startswith("seg") else hybrid_step
        worst, dp, metrics = step_pair(mesh, device, made, step,
                                       train_cfg(**kw), batch(given),
                                       grad_accum=ga, owner=k)
        out[case] = worst
        out[f"{case}_dp"] = (metrics, {n: t.detach().cpu().numpy()
                                       for n, t in dp.state_dict().items()})
    out["seg_dice"] = step_pair(mesh, device, ynet_f64, _seg_step,
                                train_cfg(loss="dice"), seg, owner=1)[0]
    cls = {"image": rs.randn(4, 32, 32, 3),
           "cls_label": np.array([1, 3, -1, 0]),
           "is_cls": np.array([1.0, 1.0, 0.0, 1.0])}
    out["cls"] = step_pair(mesh, device, ynet_f64, _cls_step, train_cfg(),
                           cls)[0]
    hr = {"image": rs.randn(4, 2, 32, 32, 3),
          "cls_label": np.array([0, 2, 1, 3])}
    out["hr"] = step_pair(mesh, device, _hr_net, _hr_step, train_cfg(), hr,
                          owner=1)[0]
    out.update(_trainer_epoch(mesh, device))
    if store:
        from wsiseg_tpu_torch.__main__ import main
        out["train_cli"] = main([
            "train", "--device", torch.device(device).type, "--mesh",
            str(mesh_size(mesh)), "--train_image_pth", store, "--tile_w",
            "32", "--tile_h", "32", "--batch_size", "8", "--num_epoch", "1",
            "--save_models", "1", "--model_save_pth", out_dir,
            "--raw_val_pth", "", "--compute_dtype", "float32", "--lr",
            "3e-4"]).history
    return out


def _epoch_batches(cfg, n_batches: int = 2, seed: int = 9):
    """Host batches of u8 images with mixed tasks (the Trainer's
    preprocess normalizes and jitters them)."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        b = hybrid_batch("crss" * (cfg.batch_size // 4),
                         seed=rs.randint(1 << 16))
        b["image"] = rs.randint(0, 256, b["image"].shape).astype(np.uint8)
        out.append(b)
    return out


def _epoch(mesh, device, n_batches: int, log_fn=None):
    """One ``Trainer`` epoch of the seed-0 f64 Unet on
    :func:`_epoch_batches`, with the jitter, over ``mesh`` (each rank fed
    its rows through ``make_batches(rows=)``, and on a (data, space) mesh
    keeping its stripe) or on one device (None)."""
    from wsiseg_tpu_torch.cli.common import make_preprocess
    from wsiseg_tpu_torch.optim import build_optimizer
    from wsiseg_tpu_torch.train.loop import Trainer
    from wsiseg_tpu_torch.train.state import TrainState
    cfg = train_cfg(num_epoch=1, start_epoch=1)
    batches = _epoch_batches(cfg, n_batches)

    def make_batches(rows=None):
        if rows is None:
            return iter(batches)
        return ({k: v[rows(len(v))] for k, v in b.items()} for b in batches)

    model = ynet_f64(cfg, torch.device(device))
    state = TrainState(model, build_optimizer(cfg, model.parameters()))
    tr = Trainer(cfg, state, hybrid_step(model, cfg, 1),
                 make_batches=make_batches,
                 preprocess_batch=make_preprocess(cfg),
                 log_fn=log_fn or (lambda s: None), mesh=mesh)
    tr.run()
    return tr


def _trainer_epoch(mesh, device, n_batches: int = 2,
                   reference=None) -> Dict[str, object]:
    """:func:`_epoch` over ``mesh`` against the same epoch on one device,
    which the mesh's rank 1 computes (unless it passes it as
    ``reference``): history and parameters; the ranks that logged; and
    the refusal of a global batch that does not divide over the (data)
    ranks."""
    from wsiseg_tpu_torch.optim import build_optimizer
    from wsiseg_tpu_torch.train.loop import Trainer
    from wsiseg_tpu_torch.train.state import TrainState
    dev = torch.device(device)
    logs = []
    got = _epoch(mesh, device, n_batches, logs.append)
    logged = comm.gather_slots(torch.tensor([float(len(logs))], device=dev),
                               comm.as_group(mesh)).reshape(-1).tolist()
    worst, keys_differ = replica_spread(got.state.model, mesh, dev), 0.0
    if mesh_index(mesh) == 1:                    # the reference's rank
        ref = reference or _epoch(None, device, n_batches)
        h_ref = {k: v for k, v in ref.history[0].items()
                 if k != "patches_per_sec"}
        h_got = {k: v for k, v in got.history[0].items()
                 if k != "patches_per_sec"}
        keys_differ = float(sorted(h_got) != sorted(h_ref))
        worst = max([worst, state_diff(ref.state.model, got.state.model)]
                    + [abs(h_got[k] - v) / max(1.0, abs(v))
                       for k, v in h_ref.items()])
    out = {"trainer_history_keys": max_over_ranks(keys_differ, dev) == 0,
           "trainer_epoch": max_over_ranks(worst, dev),
           "trainer_logs": logged}
    odd = train_cfg(batch_size=2 * mesh_size(mesh) + 1)
    model = ynet_f64(odd, dev)
    try:
        Trainer(odd, TrainState(model, build_optimizer(odd,
                                                       model.parameters())),
                hybrid_step(model, odd, 1), make_batches=lambda rows: iter([]),
                log_fn=lambda s: None, mesh=mesh).run()
        out["indivisible_raises"] = False
    except ValueError as e:
        out["indivisible_raises"] = "divide evenly" in str(e)
    return out


# ---- spatial training ----


def _pair_mesh(ranks):
    """A (1, 2) ("data", "space") mesh over two given ranks of the group
    (every rank of the group must call it, as ``make_mesh``)."""
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh("cpu", torch.tensor([ranks]),
                      mesh_dim_names=("data", "space"))
    mesh.flat_group = torch.distributed.new_group(ranks=list(ranks))
    return mesh


def spatial_training_cases(device, given, store: str = "",
                           out_dir: str = "") -> Dict[str, object]:
    """Every spatial training case against the single-device step (f64,
    sgd) on a group of four: the largest relative difference of each, on a
    (2, 2) and a (1, 4) mesh over the four ranks, and on two (1, 2)
    meshes over ranks 0–1 and 2–3, which run their cases at once. The
    ``given`` f64 Unet state_dict (or the path :func:`publish_state`
    writes it to; the tests hold it against JAX's step from the same flax
    variables) starts the ``hybrid_2x2`` and ``seg_ohem`` cases, which
    also return the mesh's metrics and new state (``<case>_sp``). With a
    gt.npy ``store``, then ``train --mesh 2x2`` in this group (as under
    ``torchrun``), one epoch into ``out_dir``: its history
    (``train_cli``). Needs a world of 4."""
    dev = torch.device(device)
    m22, m14 = spatial_mesh(dev, 2, 2), spatial_mesh(dev, 1, 4)
    lo, hi = _pair_mesh((0, 1)), _pair_mesh((2, 3))
    rs = np.random.RandomState(12)
    seg = seg_batch(rs)
    cls = {"image": rs.randn(4, 32, 32, 3), "cls_label": np.array([1, 3, -1, 0]),
           "is_cls": np.array([1.0, 1.0, 0.0, 1.0])}
    hr = {"image": rs.randn(2, 16, 32, 32, 3), "cls_label": np.array([2, 1])}
    # (case, mesh, model, step, config, batch, grad_accum, owner): each
    # owner computes its single-device references before any case runs on
    # a mesh, the owners chosen so that every rank's references and mesh
    # cases take about as long
    specs = [
        ("hybrid_1x4", m14, ynet_f64, hybrid_step, train_cfg(),
         hybrid_batch("crss"), 1, 0),
        # 32² over 2 space ranks: a stripe of 16 rows, level 5 gathers;
        # batch 8 gives c5's BatchNorm 8 values a channel (at batch 2 it
        # has two, and a 1e-15 relative change of the input moves the
        # single-device f64 state by 1e-2)
        ("resnet50_1x2", lo, ynet_f64, hybrid_step,
         train_cfg(arch_encoder="resnet50", batch_size=8),
         hybrid_batch("crsscsrs", seed=6), 1, 0),
        ("seg_dice", lo, ynet_f64, _seg_step, train_cfg(loss="dice"), seg,
         1, 0),
        ("seg_Linknet", lo, ynet_f64, _seg_step,
         train_cfg(model_name="Linknet"), seg, 1, 1),
        ("seg_FPN", lo, ynet_f64, _seg_step, train_cfg(model_name="FPN"),
         seg, 1, 1),
        ("hr", hi, functools.partial(_hr_net, num_patches=16), _hr_step,
         train_cfg(batch_size=2), hr, 1, 0),
        ("cls", hi, ynet_f64, _cls_step, train_cfg(), cls, 1, 0),
        ("seg_PSPNet", hi, ynet_f64, _seg_step,
         train_cfg(model_name="PSPNet"), seg, 1, 1),
        ("grad_accum2", hi, ynet_f64, hybrid_step,
         train_cfg(batch_size=8, grad_accum=2),
         hybrid_batch("csrscssr", seed=5), 2, 1)]
    refs = {case: single_step(model, step, cfg, batch, dev, ga)
            for case, mesh, model, step, cfg, batch, ga, owner in specs
            if is_owner(mesh, owner)}
    epoch_ref = _epoch(None, dev, 1) if mesh_index(m22) == 1 else None
    if isinstance(given, str):
        given = await_state(given)
    made = functools.partial(_given_ynet, given)
    given_specs = [
        ("hybrid_2x2", m22, made, hybrid_step,
         train_cfg(tile_w=64, tile_h=64), hybrid_batch("crss", tile=64), 1,
         3),
        ("seg_ohem", m22, made, _seg_step, train_cfg(loss="ohem"),
         ohem_batch(given), 1, 1)]
    refs.update({case: single_step(model, step, cfg, batch, dev, ga)
                 for case, mesh, model, step, cfg, batch, ga, owner
                 in given_specs if is_owner(mesh, owner)})
    specs = given_specs + specs
    out: Dict[str, object] = {}
    for case, mesh, model, step, cfg, batch, ga, owner in specs:
        if not in_mesh(mesh):
            continue
        worst, net, metrics = step_pair(mesh, dev, model, step, cfg, batch,
                                        ga, owner, refs.pop(case, None))
        out[case] = worst
        if model is made:
            out[f"{case}_sp"] = (metrics, {
                n: t.detach().cpu().numpy()
                for n, t in net.state_dict().items()})
    # the (1, 2) cases of ranks 2–3, to rank 0's results
    halves = {case: out[case] for case, mesh, *_ in specs if mesh is hi
              and in_mesh(mesh)}
    for every in comm.gather_objects(halves, torch.distributed.group.WORLD):
        for case, worst in every.items():
            out.setdefault(case, worst)
    out.update(_trainer_epoch(m22, device, n_batches=1, reference=epoch_ref))
    if store:
        from wsiseg_tpu_torch.__main__ import main
        out["train_cli"] = main([
            "train", "--device", dev.type, "--mesh", "2x2",
            "--train_image_pth", store, "--tile_w", "32", "--tile_h", "32",
            "--batch_size", "8", "--num_epoch", "1", "--save_models", "1",
            "--model_save_pth", out_dir, "--raw_val_pth", "",
            "--compute_dtype", "float32"]).history
    return out


# ---- sharded inference ----


def infer_cfg(**kw):
    """The sharded cases' config: 32² tiles at stride 8 on a 64×48 level
    2 (15 tiles; a 24-row stripe under a 32-row tile spills into two ranks
    below; the row-striped FCN's stripes are the pinned (32, 512)), f32."""
    common = dict(tile_w=32, tile_h=32, tile_stride_w=8, tile_stride_h=8,
                  compute_dtype="float32", infer_batch_size=4,
                  wsi_mask_pth="")
    common.update(kw)
    return default_config(**common)


#: the sharded cases' slide (its level 2 is 64×48)
SLIDE_WH = (1024, 768)


def _engine(cfg, device, mode="seg", state_dict=None, seed=0):
    from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
    from wsiseg_tpu_torch.models.ynet import build_ynet
    if state_dict is None:
        model = seeded_ynet(cfg, seed)
    else:
        model = build_ynet(cfg)
        model.load_state_dict(state_dict)
    return DenseInferenceEngine(model, cfg, mode=mode, device=device)


def _plan(name, seed, cfg):
    from wsiseg_tpu_torch.data.wsi_tiles import plan_slide
    from wsiseg_tpu_torch.slides.reader import SyntheticSlide
    w, h = SLIDE_WH
    return plan_slide(name, SyntheticSlide(width=w, height=h, num_levels=3,
                                           seed=seed), cfg)


def _res(res, canvas=True) -> Dict[str, np.ndarray]:
    out = {"labels": res.labels, "heat": res.heatmap}
    if canvas and res.canvas is not None:
        out["canvas"] = res.canvas
    return out


def sharded_inference_cases(device, state_dict=None, out_dir: str = "",
                            slides_dir: str = "") -> Dict[str, object]:
    """Every sharded route and its single-device counterpart, as numpy
    results (rank 0's; every rank holds the same):

    - ``psum``/``single``: ``predict_slide_sharded`` and ``predict_slide``
      (seg and cls mode), ``rows`` (``predict_slide_sharded_rows``);
    - ``streamed_sharded``/``streamed``;
    - ``slides_sharded``/``slides_single`` (one slide a rank);
    - ``fcn_rows_<family>``/``fcn_chunked_<family>`` at the pinned
      (32, 512) stripe geometry;
    - ``psum_given``: the psum route on ``state_dict``'s weights (the
      JAX comparison's);
    - ``tumorbed``: the files ``predict_tumorbed`` wrote with the mesh
      (rank 0 alone writes) under ``out_dir``;
    - ``cli``: ``eval-tumorbed --sharded --mesh <world>`` over the slides
      in ``slides_dir`` in this group (as under ``torchrun``), writing
      under ``out_dir``/cli.
    """
    from wsiseg_tpu_torch.infer.engine import fcn_stripe_geometry
    mesh = rank_mesh(device)
    n = mesh_size(mesh)
    out: Dict[str, object] = {"world": n}
    cfg = infer_cfg()
    plan = _plan("s", 5, cfg)
    engines = {mode: _engine(cfg, device, mode=mode)
               for mode in ("seg", "cls")}
    for mode, eng in engines.items():
        out[f"psum_{mode}"] = _res(eng.predict_slide_sharded(
            plan, mesh, keep_canvas=True))
        out[f"single_{mode}"] = _res(eng.predict_slide(plan,
                                                       keep_canvas=True))
        out[f"rows_{mode}"] = _res(eng.predict_slide_sharded_rows(
            plan, mesh, keep_canvas=True))
    eng = engines["seg"]
    out["streamed_sharded"] = _res(eng.predict_slide_streamed_sharded(
        plan, mesh, nthreads=1, keep_canvas=True))
    out["streamed"] = _res(eng.predict_slide_streamed(plan, nthreads=1,
                                                      keep_canvas=True))
    out["n_tiles"] = len(plan.grid)

    plans = [_plan(f"sp{k}", 40 + k, cfg) for k in range(n)]
    sp = eng.predict_slides_fcn_sharded(plans, mesh)
    out["slides_sharded"] = [_res(x, canvas=False) for x in sp]
    out["slides_single"] = [_res(eng.predict_slide_fcn(p), canvas=False)
                            for p in plans]

    lw, lh = plan.slide.level_dimensions[cfg.scan_level]
    ch, cw = out["stripe_geometry"] = fcn_stripe_geometry(lh, lw, n)
    for fam in ("Unet", "Linknet", "FPN"):
        feng = _engine(cfg.replace(model_name=fam), device, seed=2)
        out[f"fcn_rows_{fam}"] = _res(feng.predict_slide_fcn_sharded_rows(
            plan, mesh, halo=16, keep_canvas=True))
        out[f"fcn_chunked_{fam}"] = _res(feng.predict_slide_fcn(
            plan, chunk=(ch, cw), halo=16, keep_canvas=True))

    if state_dict is not None:
        geng = _engine(cfg, device, state_dict=state_dict)
        out["psum_given"] = _res(geng.predict_slide_sharded(
            plan, mesh, keep_canvas=True))

    if out_dir:
        from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection
        from wsiseg_tpu_torch.infer.evaluators import predict_tumorbed
        from wsiseg_tpu_torch.slides.reader import SyntheticSlide
        tcfg = cfg.replace(val_save_pth=out_dir)
        coll = SlideCollection([("t", SyntheticSlide(
            width=SLIDE_WH[0], height=SLIDE_WH[1], num_levels=3, seed=4))],
            tcfg)
        teng = _engine(tcfg, device)
        got = {}
        for fcn in (True, False):
            got[fcn] = predict_tumorbed(teng, coll, 0, fcn=fcn, mesh=mesh,
                                        log=lambda s: None)
        comm.global_sum(torch.zeros(1, device=torch.device(device)),
                        mesh_group(mesh))            # every rank is done
        out["tumorbed_results"] = {str(k): sorted(v) for k, v in got.items()}
        out["tumorbed_files"] = sorted(
            os.path.relpath(os.path.join(d, f), out_dir)
            for d, _, fs in os.walk(out_dir) for f in fs)
    if slides_dir:
        from wsiseg_tpu_torch.__main__ import main
        cli_dir = os.path.join(out_dir, "cli")
        out["cli"] = main([
            "eval-tumorbed", "--sharded", "--device",
            torch.device(device).type, "--mesh", str(n), "--raw_val_pth",
            slides_dir, "--eval_model_pth", os.path.join(cli_dir, "none"),
            "--val_save_pth", cli_dir, "--wsi_mask_pth", "", "--tile_w",
            "64", "--tile_h", "64"])
    return out


# ---- data-parallel training over each rank's device cache ----


def _cache_patches(n: int = 16, tile: int = 32, seed: int = 5) -> Dict:
    """``n`` u8 host patches with hybrid labels, in ``PatchDataset``'s
    batch form (every third row cls, reg, seg)."""
    rs = np.random.RandomState(seed)
    task = np.arange(n) % 3
    return {"image": rs.randint(0, 256, (n, tile, tile, 3)).astype(np.uint8),
            "seg_label": rs.randint(0, 4, (n, tile, tile)).astype(np.int32),
            "cls_label": np.where(task == 0, rs.randint(0, 4, n),
                                  -1).astype(np.int32),
            "reg_label": np.where(task == 1, rs.rand(n),
                                  0.0).astype(np.float32),
            "is_cls": (task == 0).astype(np.float32),
            "is_reg": (task == 1).astype(np.float32),
            "is_seg": (task == 2).astype(np.float32)}


def cached_dp_cases(device) -> Dict[str, object]:
    """``train --mesh N --device_cache``'s wiring
    (``device_cache.cached_training`` over this rank's rows of each host
    batch, ``cache_rows``) against the single-device cached step on the
    global batch, f64 sgd with the colour jitter (each rank drawing the
    global batch's factors): parameters, BatchNorm statistics and
    metrics, the largest relative gap over the ranks; the all-reduces
    the step made (``comm.ALLREDUCE_CALLS``), and those of the
    single-device step (none)."""
    from wsiseg_tpu_torch.optim import build_optimizer
    from wsiseg_tpu_torch.train.device_cache import (
        DeviceEpochCache, cache_rows, cached_training,
        make_cached_hybrid_train_step)
    from wsiseg_tpu_torch.train.state import TrainState
    mesh = rank_mesh(device)
    n, r = mesh_size(mesh), mesh_rank(mesh)
    b = 2 * n
    cfg = train_cfg(batch_size=b)
    data = _cache_patches(n=4 * b)
    batches = [{k: v[i:i + b] for k, v in data.items()}
               for i in range(0, 4 * b, b)]
    cut = cache_rows(cfg, mesh)
    model = ynet_f64(cfg, device)
    st = TrainState(model, build_optimizer(cfg, model.parameters()))
    cache, step, make_batches = cached_training(
        ({k: v[cut(b)] for k, v in bt.items()} for bt in batches), model,
        cfg, device, mesh, cls_weights=CW, seg_weights=SW)
    local = next(iter(make_batches(rows=None)))["idx"]
    calls = comm.ALLREDUCE_CALLS
    with comm.data_parallel(mesh):
        got = step(st, {"idx": torch.as_tensor(local, device=device)},
                   torch.Generator(device).manual_seed(11))
    calls = comm.ALLREDUCE_CALLS - calls

    # the global batch: each rank's local rows at its batch_rows
    m = b // n
    rows = np.concatenate([(local // m) * b + q * m + local % m
                           for q in range(n)])
    full = DeviceEpochCache.build(batches, cfg, device)
    ref = ynet_f64(cfg, device)
    ref_st = TrainState(ref, build_optimizer(cfg, ref.parameters()))
    single = comm.ALLREDUCE_CALLS
    want = make_cached_hybrid_train_step(
        ref, cfg, cls_weights=CW, seg_weights=SW)(
            ref_st, full.arrays, torch.as_tensor(rows, device=device),
            torch.Generator(device).manual_seed(11))
    single = comm.ALLREDUCE_CALLS - single
    gap = max([state_diff(ref, model)]
              + [rel_diff(got[k], want[k]) for k in want])
    return {"cached_dp": max_over_ranks(gap, device),
            "cache_rows": int(max_over_ranks(cache.n, device)),
            "local_batch": len(local), "rank": r,
            "allreduce_calls": calls, "single_calls": single}
