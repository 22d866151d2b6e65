"""Shared CLI plumbing — counterpart of ``wsiseg_tpu/cli/common.py``:
the Y-Net and the HR region ensemble with their optimizers and resume
(``setup_ynet``, ``setup_hr``), the eval restore, the device-side batch
preprocessing, the HR ensemble's serving forward, the meshes of
``--mesh`` and ``--sharded`` with the spawning of their ranks, and the
flag pre-parsers of the eval CLIs, the trainers and the preprocess and
paper tools (the JAX package's flags plus ``--device``)."""

from __future__ import annotations

import argparse
import os
import types
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.data.patches import normalize_batch_images
from wsiseg_tpu_torch.infer.engine import resolve_device
from wsiseg_tpu_torch.models import ensemble
from wsiseg_tpu_torch.models.torch_import import apply_pretrained
from wsiseg_tpu_torch.models.ynet import YNet, init_ynet
from wsiseg_tpu_torch.optim import build_optimizer
from wsiseg_tpu_torch.train.state import (TrainState, latest_checkpoint,
                                          restore_checkpoint,
                                          restore_train_state)


def _init(cfg: Config) -> YNet:
    """Fresh weights from ``cfg.seed``, with ``cfg.pretrained_pth``
    grafted over them when set."""
    model = init_ynet(cfg, torch.Generator().manual_seed(cfg.seed))
    if cfg.pretrained_pth:
        apply_pretrained(model, cfg.pretrained_pth)
        print(f"grafted pretrained weights from {cfg.pretrained_pth}")
    return model


def setup_ynet(cfg: Config, device="cuda") -> Tuple[TrainState, int]:
    """The Y-Net on ``device`` in ``cfg.param_dtype`` (``channels_last``
    on a CUDA device), its optimizer, and the start epoch, resumed from
    the latest ``cfg.train_model_pth`` checkpoint when
    ``cfg.continue_train`` (restored epoch + 1, reference
    utils/networks.py:4-12). Returns (state, start_epoch)."""
    return _setup(cfg, _init(cfg), device)


def setup_hr(cfg: Config, device="cuda") -> Tuple[TrainState, int]:
    """:func:`setup_ynet` for the multi-patch region ensemble (reference
    resnets_shift.resnet18, train_hr.py:21-22): fresh weights from
    ``cfg.seed``; ``cfg.pretrained_pth`` is grafted into the ``trunk``
    only, the dense heads stay random (resnets_shift.py:230-240)."""
    device = resolve_device(device)
    model = ensemble.init_ensemble(
        cfg, torch.Generator().manual_seed(cfg.seed))
    if cfg.pretrained_pth:
        apply_pretrained(model, cfg.pretrained_pth, encoder_name="trunk")
        print(f"grafted pretrained trunk from {cfg.pretrained_pth}")
    return _setup(cfg, model, device)


def _setup(cfg: Config, model, device) -> Tuple[TrainState, int]:
    device = resolve_device(device)
    model = model.to(device, getattr(torch, cfg.param_dtype))
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    state = TrainState(model, build_optimizer(cfg, model.parameters()))
    start_epoch = cfg.start_epoch
    if cfg.continue_train:
        pth = latest_checkpoint(cfg.train_model_pth)
        if pth:
            start_epoch = restore_train_state(pth, state)
            print(f"resumed from {pth} (epoch {start_epoch})")
    return state, start_epoch


def restore_for_eval(cfg: Config, setup=setup_ynet):
    """The model ``setup`` builds (:func:`setup_ynet`'s Y-Net or
    :func:`setup_hr`'s ensemble, on the CPU) with the latest
    ``cfg.eval_model_pth`` checkpoint, or its fresh (and grafted) weights
    with a warning when there is none. Returns (model, epoch) like the JAX
    function."""
    model = setup(cfg, device="cpu")[0].model
    pth = latest_checkpoint(cfg.eval_model_pth)
    if pth:
        model, epoch = restore_checkpoint(pth, model)
        print(f"restored {pth} (epoch {epoch - 1})")
    else:
        epoch = cfg.start_epoch
        print(f"WARNING: no checkpoint at {cfg.eval_model_pth}; "
              "using fresh weights")
    return model, epoch - 1


def make_preprocess(cfg: Config, train: bool = True) -> Callable:
    """``fn(batch, generator, rows=None)``: the batch's u8 images →
    normalized float on their device, with the train jitter drawn from
    ``generator`` when ``train``. An HR batch's (B, P, H, W, 3) patches
    are normalized as B·P images (B·P jitter draws). ``rows = (n, index)``
    marks the batch as rows ``index`` of an n-row global batch
    (:func:`~wsiseg_tpu_torch.data.patches.normalize_batch_images`)."""

    def preprocess(batch: Dict, generator=None, rows=None) -> Dict:
        out = dict(batch)
        img = batch["image"]
        flat = img.reshape(-1, *img.shape[-3:])
        if rows is not None and img.ndim == 5:
            p = img.shape[1]
            idx = (rows[1][:, None] * p + torch.arange(
                p, device=rows[1].device)).reshape(-1)
            rows = (rows[0] * p, idx)
        out["image"] = normalize_batch_images(
            flat, cfg, generator, train=train, rows=rows).reshape(img.shape)
        return out

    return preprocess


def make_hr_apply(model, cfg: Config, device="cuda") -> Callable:
    """``fn(images_u8 (B, P, h, w, 3) numpy) -> (per_patch (B, P, C),
    ensemble (B, C))`` as float32 numpy: the patches to ``device``,
    normalized, through the ensemble's compute copy in
    ``cfg.compute_dtype`` (JAX's ``make_hr_forward`` with both outputs)."""
    dev = resolve_device(device)
    net = ensemble.compute_copy(model, getattr(torch, cfg.compute_dtype))
    net = net.to(dev)

    @torch.no_grad()
    def apply(images_u8):
        x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(dev)
        per_patch, ens = net(make_preprocess(cfg, train=False)(
            {"image": x})["image"])
        return per_patch.cpu().numpy(), ens.cpu().numpy()

    return apply


def mesh_ranks(spec: str, device="cuda") -> int:
    """The ranks a ``--mesh`` value asks for (JAX ``make_train_mesh``):
    ``""``, ``none``, ``0`` and ``1`` one device; ``all`` every visible
    card (on ``cuda`` only: the CPU's ranks are given as ``N``); ``N`` N
    ranks; ``NxM`` N·M ranks, N-way data × M-way space (``1x1`` one
    device)."""
    spec = (spec or "").strip().lower()
    if spec in ("", "none", "0", "1"):
        return 1
    grid = mesh_grid(spec)
    if grid:
        return grid[0] * grid[1]
    if spec == "all":
        if torch.device(device).type != "cuda":
            raise ValueError("--mesh all counts the visible cards; with "
                             "--device cpu give the gloo ranks as --mesh N")
        return torch.cuda.device_count()
    return int(spec)


def mesh_grid(spec: str) -> Optional[Tuple[int, int]]:
    """(N, M) of an ``NxM`` ``--mesh`` value; None for any other."""
    spec = (spec or "").strip().lower()
    return tuple(int(v) for v in spec.split("x")) if "x" in spec else None


def _mesh_of(cfg: Config, n: int, device, shape=None, axes=None):
    from wsiseg_tpu_torch.parallel.mesh import make_mesh
    if dist.get_world_size() != n:
        raise ValueError(f"--mesh asks for {n} ranks; the process group "
                         f"has {dist.get_world_size()}")
    return make_mesh(devices=[resolve_device(device)] * n,
                     shape=shape or (n,), axes=axes or (cfg.mesh_axes[0],))


def make_train_mesh(cfg: Config, n: int, device="cuda"):
    """The trainers' mesh over this process group's ``n`` ranks
    (:func:`mesh_ranks`), each on ``device``: the data mesh, or for
    ``--mesh NxM`` the (``cfg.mesh_axes[0]``, ``space``) mesh of JAX's
    ``make_train_mesh`` (``common.py:166-171``); None for one device."""
    if n <= 1:
        return None
    grid = mesh_grid(cfg.mesh)
    if grid:
        return _mesh_of(cfg, n, device, grid, (cfg.mesh_axes[0], "space"))
    return _mesh_of(cfg, n, device)


def make_eval_mesh(cfg: Config, n: int, device="cuda"):
    """``--sharded``'s mesh over this process group's ``n`` ranks, each on
    ``device``: one data dim whatever ``--mesh``'s shape, as JAX's
    ``make_eval_mesh`` (``common.py:150-152``) takes every device."""
    return _mesh_of(cfg, n, device)


def needs_ranks(n: int, sharded: bool = False) -> bool:
    """True when this process must start the ranks: several asked for (or
    any, for ``--sharded``) and no process group running yet (ranks the
    launcher spawned and ``torchrun``'s run with one)."""
    return (n > 1 or sharded) and not dist.is_initialized()


def _call_rank(device, fn: Callable, kwargs: Dict):
    out = fn(**kwargs)
    history = getattr(out, "history", None)
    return out if history is None else types.SimpleNamespace(
        history=history)


def spawn_ranks(n: int, on, fn: Callable, **kwargs):
    """``fn(**kwargs)`` on ``n`` ranks on device type ``on``
    (``parallel.launch.run_ranks``: one card a rank on ``cuda``, raising
    when fewer are visible; gloo ranks on the CPU, sharing its cores).
    Returns rank 0's result; a trainer's as a namespace with its
    ``history``."""
    from wsiseg_tpu_torch.parallel.launch import run_ranks
    threads: Optional[int] = None
    if torch.device(on).type == "cpu":
        threads = max(1, (os.cpu_count() or 1) // max(1, n))
    return run_ranks(_call_rank, n, on, args=(fn, kwargs), threads=threads)


def add_device_flag(p: argparse.ArgumentParser, where: str) -> None:
    """``--device cpu|cuda`` on ``p``; ``where`` says what runs there. The
    default is cuda, which raises (:func:`resolve_device`) when no CUDA
    device is present."""
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                   help=f"where {where} (default cuda; raises when no CUDA "
                        "device is present)")


def parse_device_flag(argv, where: str):
    """Pre-parse ``--device`` ahead of ``Config.parse_args``. Returns
    (namespace, remaining argv)."""
    p = argparse.ArgumentParser(add_help=False)
    add_device_flag(p, where)
    return p.parse_known_args(argv)


def parse_train_flags(argv):
    """``--device`` for the trainers (default cuda; raises when no CUDA
    device is present). Returns (namespace, remaining argv)."""
    return parse_device_flag(argv, "the model trains")


def parse_eval_flags(argv):
    """Mode pre-parser for the eval CLIs (the JAX package's flags plus
    ``--device``). FCN is the default; ``--grid`` selects the reference
    overlap-add oracle, ``--streamed`` the host-decoded tile batches;
    ``--sharded`` splits each slide's tiles over the ranks of
    :func:`make_eval_mesh` (the grid, or with ``--streamed`` the streamed
    row-sharded route)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--grid", action="store_true",
                   help="exact reference overlap-add stitching")
    p.add_argument("--fcn", action="store_true",
                   help="(default) ScanNet-style FCN mode")
    p.add_argument("--sharded", action="store_true",
                   help="shard each slide's tile stream over all devices")
    p.add_argument("--streamed", action="store_true",
                   help="host-streamed tile decode")
    p.add_argument("--slides_in_flight", type=int, default=4,
                   help="serve up to N consecutive same-geometry slides as "
                        "one batched forward; 1 disables")
    add_device_flag(p, "the engine runs")
    ns, rest = p.parse_known_args(argv)
    if ns.fcn and (ns.grid or ns.streamed or ns.sharded):
        p.error("--fcn is mutually exclusive with --grid/--streamed/"
                "--sharded (FCN is already the default; drop --fcn)")
    ns.fcn = not (ns.grid or ns.streamed or ns.sharded)
    return ns, rest
