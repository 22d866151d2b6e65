"""The program's training set-up from a cell, as the ``train`` command
wires it: the seeded weights, the config, a patch set's class weights
and the model with its optimizer (``TrainState``). The training drivers
build from these."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from portbench.drivers.train import class_weights
from portbench.harness.weights import make_state
from portbench.reference.ynet import build as build_reference


def patch_class_weights(data: Dict[str, np.ndarray],
                        nc: int) -> Tuple[np.ndarray, np.ndarray]:
    """(class, pixel) weights of a patch set: over its classification
    rows' classes and its segmentation rows' pixels."""
    rows = data["is_cls"] > 0
    cls_w = class_weights(np.bincount(data["cls_label"][rows],
                                      minlength=nc)[:nc])
    seg_rows = data["is_seg"] > 0
    seg_w = class_weights(np.bincount(
        data["seg_label"][seg_rows].reshape(-1).astype(np.int64),
        minlength=nc)[:nc])
    return cls_w, seg_w


def initial_state(cfg_json: Dict,
                  gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """The seeded weights, under the reference's names, on ``gen``'s
    device."""
    with torch.device("meta"):
        skeleton = build_reference(cfg_json)
    return make_state(skeleton, gen, cfg_json.get("init_scale"))


def train_config(cell, **extra):
    """The program's ``Config`` for the cell: its model, the traffic's
    patches, batch and Adam, the seed; ``extra`` as the command's flags
    set it."""
    from wsiseg_tpu_torch.config import default_config

    c, t = cell.config, cell.traffic
    return default_config(
        model_name=c["model_name"], arch_encoder=c["arch_encoder"],
        num_classes=c["num_classes"], class_probs=tuple(c["class_probs"]),
        dataset_mean=tuple(c["dataset_mean"]),
        dataset_std=tuple(c["dataset_std"]),
        compute_dtype=c["compute_dtype"], param_dtype=c["param_dtype"],
        tile_w=t["tile"], tile_h=t["tile"], batch_size=t["batch_size"],
        optim="adam", lr=t["lr"], weight_decay=t["weight_decay"],
        beta1=t["beta1"], beta2=t["beta2"], save_models=0,
        validate_model=0, raw_val_pth="", wsi_mask_pth="", seed=cell.seed,
        **extra)


def train_state(cfg_json: Dict, cfg, state0: Dict[str, torch.Tensor],
                dev: torch.device):
    """The program's Y-Net loaded from ``state0`` on ``dev`` (channels
    last on a card) and its optimizer, as a ``TrainState``."""
    from wsiseg_tpu_torch.models.ynet import YNet
    from wsiseg_tpu_torch.optim import build_optimizer
    from wsiseg_tpu_torch.train.state import TrainState

    with torch.device("meta"):
        model = YNet(cfg_json["arch_encoder"], cfg_json["num_classes"], 1,
                     cfg_json["model_name"])
    model = model.to_empty(device=dev)
    model.load_state_dict(state0)
    model = model.to(dev, getattr(torch, cfg_json["param_dtype"]))
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return TrainState(model, build_optimizer(cfg, model.parameters()))
