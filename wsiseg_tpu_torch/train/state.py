"""Checkpoints — counterpart of ``wsiseg_tpu/train/state.py``.

A checkpoint is ``model_<arch>_<epoch>.pt`` holding ``{"epoch",
"state_dict", "optimizer", "step"}`` — the reference's ``torch.save``
payload (train.py:111-118) plus the count of optimizer steps — with the
run's configuration beside it in ``<ckpt>.config.json``. Eval checkpoints
without ``"optimizer"`` restore too. Naming, the ``latest_checkpoint``
search and resume at ``epoch + 1`` (reference utils/networks.py:4-12)
mirror the JAX package's ``.msgpack`` files.
"""

from __future__ import annotations

import glob
import json
import os
import re
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.utils.filesystem import make_folder


@dataclass
class TrainState:
    """The model, its optimizer and the count of optimizer steps taken
    (JAX ``TrainState``'s params, batch_stats, opt_state and step)."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def checkpoint_path(model_save_pth: str, arch: str, epoch: int) -> str:
    return os.path.join(model_save_pth, f"model_{arch}_{epoch}.pt")


def save_checkpoint(model: nn.Module, directory: str, arch: str, epoch: int,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    step: int = 0, cfg: Optional[Config] = None) -> str:
    make_folder(directory)
    pth = checkpoint_path(directory, arch, epoch)
    payload = {"epoch": epoch, "state_dict": model.state_dict(),
               "step": step}
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    torch.save(payload, pth)
    if cfg is not None:
        with open(pth + ".config.json", "w") as f:
            json.dump(cfg.asdict(), f, indent=1)
    return pth


def save_train_state(state: TrainState, cfg: Config, epoch: int) -> str:
    """:func:`save_checkpoint` of a training run into
    ``cfg.model_save_pth``, with its configuration."""
    return save_checkpoint(state.model, cfg.model_save_pth,
                           cfg.arch_encoder, epoch, state.optimizer,
                           state.step, cfg)


def restore_checkpoint(pth: str, model: nn.Module) -> Tuple[nn.Module, int]:
    """Load a checkpoint into ``model`` (strict). Returns (model,
    start_epoch) with start_epoch = saved epoch + 1, as the JAX
    package."""
    model, start, _ = _restore(pth, model, None)
    return model, start


def restore_train_state(pth: str, state: TrainState) -> int:
    """A checkpoint into a :class:`TrainState`: the model (strict), the
    optimizer state when the checkpoint has one, and the step count.
    Returns start_epoch."""
    _, start, state.step = _restore(pth, state.model, state.optimizer)
    return start


def _restore(pth, model, optimizer):
    payload = torch.load(pth, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["state_dict"], strict=True)
    if optimizer is not None and "optimizer" in payload:
        optimizer.load_state_dict(payload["optimizer"])
    return model, int(payload["epoch"]) + 1, int(payload.get("step", 0))


def latest_checkpoint(pattern_or_dir: str) -> Optional[str]:
    """Highest-epoch ``.pt`` checkpoint under a dir or glob."""
    if os.path.isdir(pattern_or_dir):
        pattern = os.path.join(pattern_or_dir, "model_*_*.pt")
    else:
        pattern = pattern_or_dir
        if not pattern.endswith(".pt"):
            pattern += ".pt"
    cands = []
    for p in glob.glob(pattern):
        m = re.search(r"_(\d+)\.pt$", p)
        if m:
            cands.append((int(m.group(1)), p))
    return max(cands)[1] if cands else None


def load_checkpoint_config(pth: str) -> Optional[Config]:
    """The configuration saved beside a checkpoint, or None."""
    cfg_pth = pth + ".config.json"
    if os.path.exists(cfg_pth):
        with open(cfg_pth) as f:
            return Config.fromdict(json.load(f))
    return None
