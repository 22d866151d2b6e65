"""Shared CLI plumbing — counterpart of ``wsiseg_tpu/cli/common.py``:
the Y-Net and the HR region ensemble with their optimizers and resume
(``setup_ynet``, ``setup_hr``), the eval restore, the device-side batch
preprocessing, the HR ensemble's serving forward, and the flag
pre-parsers of the eval CLIs, the trainers and the preprocess and paper
tools (the JAX package's flags plus ``--device``)."""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.data.patches import normalize_batch_images
from wsiseg_tpu_torch.infer.engine import MULTI_GPU_ITEM, resolve_device
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
    """``fn(batch, generator)``: the batch's u8 images → normalized float
    on their device, with the train jitter drawn from ``generator`` when
    ``train``. An HR batch's (B, P, H, W, 3) patches are normalized as
    B·P images (B·P jitter draws)."""

    def preprocess(batch: Dict, generator=None) -> Dict:
        out = dict(batch)
        img = batch["image"]
        flat = img.reshape(-1, *img.shape[-3:])
        out["image"] = normalize_batch_images(
            flat, cfg, generator, train=train).reshape(img.shape)
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


def check_single_device(cfg: Config) -> None:
    """``--mesh`` asks for training over several devices, which waits for
    the Multi-GPU item (JAX ``make_train_mesh``)."""
    if cfg.mesh and cfg.mesh not in ("none", "0", "1"):
        raise NotImplementedError(f"--mesh {cfg.mesh}: {MULTI_GPU_ITEM}")


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
    ``--sharded`` is parsed so that the eval entry can refuse it by
    name."""
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
