"""Checkpoint naming, discovery, save and restore — the subset of
``wsiseg_tpu/train/state.py`` that serving needs.

A checkpoint is ``model_<arch>_<epoch>.pt`` holding ``{"epoch",
"state_dict"}`` (the reference's ``torch.save`` payload minus the
optimizer, which waits for the training port). Naming and the
``latest_checkpoint`` search mirror the JAX package's ``.msgpack`` files.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional, Tuple

import torch
from torch import nn

from wsiseg_tpu.utils.filesystem import make_folder


def checkpoint_path(model_save_pth: str, arch: str, epoch: int) -> str:
    return os.path.join(model_save_pth, f"model_{arch}_{epoch}.pt")


def save_checkpoint(model: nn.Module, directory: str, arch: str,
                    epoch: int) -> str:
    make_folder(directory)
    pth = checkpoint_path(directory, arch, epoch)
    torch.save({"epoch": epoch, "state_dict": model.state_dict()}, pth)
    return pth


def restore_checkpoint(pth: str, model: nn.Module) -> Tuple[nn.Module, int]:
    """Load a checkpoint into ``model`` (strict). Returns (model,
    start_epoch) with start_epoch = saved epoch + 1, as the JAX package."""
    payload = torch.load(pth, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["state_dict"], strict=True)
    return model, int(payload["epoch"]) + 1


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
