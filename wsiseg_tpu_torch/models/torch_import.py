"""Pretrained torch weights grafted into the port's Y-Net — counterpart of
``wsiseg_tpu/models/torch_import.py`` (``apply_pretrained`` :259,
``graft_encoder`` :281).

The reference always trains from ImageNet encoders (train.py:29
``smp.Unet('resnet18', 'imagenet')``; resnets_shift.py:230-240 partial
state_dict load). The port's Y-Net already uses the reference's names
(torchvision's under ``encoder.``, smp's under ``decoder.`` and
``segmentation_head.``, the heads under ``classifier.``/``regressor.``),
so no conversion is needed, only routing:

* a checkpoint with ``encoder.``/``decoder.``/``segmentation_head.``
  keys is a whole reference model and loads into the whole Y-Net;
* plain torchvision names (``conv1.*``, ``bn1.*``, ``layer*``) load into
  the encoder (``encoder``; the HR ensemble's ``trunk``), and ``fc.*``
  (ImageNet's classifier) is dropped.

``module.`` prefixes are stripped, every loaded leaf's shape is checked
against the model's, and keys the checkpoint lacks keep their initial
values. As in JAX, a checkpoint whose ``decoder.*`` keys all miss the
model raises, a partial decoder match warns, and an encoder key the
model lacks (another encoder depth) raises.
"""

from __future__ import annotations

import re
import warnings
from typing import Dict, Mapping

import torch
from torch import nn

# torchvision ResNet names the JAX converter reads (torch_import.py:64-84)
_ENCODER_RE = re.compile(
    r"^(conv1\.weight|bn1\.\w+|layer\d+\.\d+\."
    r"(conv\d|bn\d|downsample\.[01])\.\w+)$")


def load_pretrained(path: str) -> Dict[str, torch.Tensor]:
    """A state_dict from a torch ``.pt``/``.pth`` file or an ``.npz``,
    unwrapped from a reference checkpoint's ``{'state_dict': ...}``, with
    ``module.`` prefixes stripped."""
    if path.endswith(".npz"):
        import numpy as np
        with np.load(path) as z:
            raw = {k: torch.from_numpy(z[k]) for k in z.files}
    else:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(obj, dict) and "state_dict" in obj:
            obj = obj["state_dict"]
        raw = {k: v.detach().cpu() for k, v in obj.items()
               if isinstance(v, torch.Tensor)}
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in raw.items()}


def _routed(sd: Mapping[str, torch.Tensor],
            encoder_name: str) -> Dict[str, torch.Tensor]:
    """Checkpoint keys → the model's keys (torchvision's under
    ``encoder_name``), BatchNorm's batch counters and torchvision's ``fc``
    left out."""
    full = any(k.startswith(("encoder.", "decoder.", "segmentation_head."))
               for k in sd)
    out = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        if full:
            out[k] = v
        elif _ENCODER_RE.match(k):
            out[f"{encoder_name}.{k}"] = v
    return out


@torch.no_grad()
def graft(model: nn.Module, sd: Mapping[str, torch.Tensor],
          encoder_name: str = "encoder") -> nn.Module:
    """Copy the checkpoint ``sd`` into ``model`` in place (see the module
    docstring for the routing and the checks). Returns ``model``."""
    own = model.state_dict()
    routed = _routed(sd, encoder_name)
    dec_missed = [k for k in routed if k.startswith("decoder.")
                  and k not in own]
    if dec_missed:
        if len(dec_missed) == sum(k.startswith("decoder.") for k in routed):
            raise ValueError(
                "checkpoint carries decoder.* keys but none map to this "
                "model's decoder (another family, or a real smp state_dict "
                "whose layout differs from the replicas: PARITY.md "
                "'deliberate narrowings'); first unmatched: "
                f"{dec_missed[:5]}")
        warnings.warn(f"graft: {len(dec_missed)} decoder key(s) did not "
                      f"map and keep their initial values, e.g. "
                      f"{dec_missed[:3]}", stacklevel=2)
    for k, v in routed.items():
        if k not in own:
            if _ENCODER_RE.match(k.split(".", 1)[-1]):
                raise KeyError(f"checkpoint key {k} not in the model")
            continue
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: model "
                             f"{tuple(own[k].shape)} vs checkpoint "
                             f"{tuple(v.shape)}")
        own[k].copy_(v.to(own[k].dtype))
    return model


def apply_pretrained(model: nn.Module, path: str,
                     encoder_name: str = "encoder") -> nn.Module:
    """Graft the pretrained torch weights at ``path`` into ``model`` (the
    trainers' ``cfg.pretrained_pth``), torchvision names into
    ``encoder_name``."""
    return graft(model, load_pretrained(path), encoder_name)
