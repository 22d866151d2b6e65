"""Flax Y-Net variables → the port's ``state_dict`` — counterpart (and
exact inverse) of ``wsiseg_tpu/models/torch_import.convert_ynet_state_dict``.

Input is the JAX ``{"params", "batch_stats"}`` tree as numpy arrays (no
JAX needed here); output keys are the smp/torchvision names the port's
:class:`~wsiseg_tpu_torch.models.ynet.YNet` uses. Conv kernels go HWIO →
OIHW with ``permute(3, 2, 0, 1)``, dense kernels (in, out) → (out, in).
Unet + BasicBlock trees only, like the rest of the port.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LAYER_RE = re.compile(r"^layer(\d+)_(\d+)$")


def _conv(k) -> torch.Tensor:
    return torch.from_numpy(np.array(
        np.asarray(k).transpose(3, 2, 0, 1), np.float32, order="C"))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32))


def _bn(sd: Dict, prefix: str, params: Mapping, stats: Mapping) -> None:
    sd[prefix + ".weight"] = _vec(params["scale"])
    sd[prefix + ".bias"] = _vec(params["bias"])
    sd[prefix + ".running_mean"] = _vec(stats["mean"])
    sd[prefix + ".running_var"] = _vec(stats["var"])
    sd[prefix + ".num_batches_tracked"] = torch.tensor(0)


def _dense(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = torch.from_numpy(
        np.array(np.asarray(p["kernel"]).T, np.float32, order="C"))
    sd[prefix + ".bias"] = _vec(p["bias"])


def from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` numpy tree → YNet ``state_dict``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    ep, eb = params["encoder"], stats["encoder"]
    sd["encoder.conv1.weight"] = _conv(ep["stem_conv"]["kernel"])
    _bn(sd, "encoder.bn1", ep["stem_bn"], eb["stem_bn"])
    for name, p in ep.items():
        m = _LAYER_RE.match(name)
        if m is None:
            continue
        pre = f"encoder.layer{m.group(1)}.{m.group(2)}"
        b = eb[name]
        for k in (1, 2):
            sd[f"{pre}.conv{k}.weight"] = _conv(p[f"conv{k}"]["kernel"])
            _bn(sd, f"{pre}.bn{k}", p[f"bn{k}"], b[f"bn{k}"])
        if "down_conv" in p:
            sd[f"{pre}.downsample.0.weight"] = _conv(p["down_conv"]["kernel"])
            _bn(sd, f"{pre}.downsample.1", p["down_bn"], b["down_bn"])

    dp, db = params["decoder"], stats["decoder"]
    for i in range(5):
        p, b = dp[f"block{i}"], db[f"block{i}"]
        for k in (1, 2):
            pre = f"decoder.blocks.{i}.conv{k}"
            sd[pre + ".0.weight"] = _conv(p[f"conv{k}"]["kernel"])
            _bn(sd, pre + ".1", p[f"bn{k}"], b[f"bn{k}"])
    sd["segmentation_head.0.weight"] = _conv(dp["seg_head"]["kernel"])
    sd["segmentation_head.0.bias"] = _vec(dp["seg_head"]["bias"])

    _dense(sd, "classifier.fc.0", params["classifier"]["fc"])
    _dense(sd, "regressor.fc.0", params["regressor"]["fc1"])
    _dense(sd, "regressor.fc.2", params["regressor"]["fc2"])
    return sd
