"""Flax Y-Net variables → the port's ``state_dict`` — counterpart (and
exact inverse) of ``wsiseg_tpu/models/torch_import.convert_ynet_state_dict``.

Input is the JAX ``{"params", "batch_stats"}`` tree as numpy arrays (no
JAX needed here); output keys are the smp/torchvision names the port's
:class:`~wsiseg_tpu_torch.models.ynet.YNet` uses. Conv kernels go HWIO →
OIHW with ``permute(3, 2, 0, 1)``, dense kernels (in, out) → (out, in).
Every decoder family (Unet, Linknet, FPN, PSPNet) and every encoder
(BasicBlock and Bottleneck); the decoder names are
``convert_ynet_state_dict``'s (``torch_import.py:106-117``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LAYER_RE = re.compile(r"^layer(\d+)_(\d+)$")
# flax decoder module path → the port's conv or BN prefix
_DECODER = tuple((re.compile(pat), target) for pat, target in (
    (r"^block(\d+)/conv(\d)$", "decoder.blocks.{0}.conv{1}.0"),
    (r"^block(\d+)/bn(\d)$", "decoder.blocks.{0}.conv{1}.1"),
    (r"^lat(\d)$", "decoder.lat{0}"),
    (r"^seg(\d)_conv(\d)$", "decoder.seg{0}.conv{1}.0"),
    (r"^seg(\d)_bn(\d)$", "decoder.seg{0}.conv{1}.1"),
    (r"^psp(\d)_conv$", "decoder.psp{0}.0"),
    (r"^psp(\d)_bn$", "decoder.psp{0}.1"),
    (r"^fuse_conv$", "decoder.fuse.0"),
    (r"^fuse_bn$", "decoder.fuse.1"),
    (r"^seg_head$", "segmentation_head.0"),
))


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


def _modules(tree: Mapping, prefix: str = ""):
    """(path, leaves) of every conv (``kernel``) or BatchNorm (``scale``)
    module under a flax params tree."""
    for name, node in tree.items():
        path = f"{prefix}{name}"
        if "kernel" in node or "scale" in node:
            yield path, node
        else:
            yield from _modules(node, path + "/")


def _decoder(sd: Dict, dp: Mapping, db: Mapping) -> None:
    for path, p in _modules(dp):
        for pattern, target in _DECODER:
            m = pattern.match(path)
            if m is not None:
                break
        else:
            raise ValueError(f"unknown flax decoder module {path!r}")
        prefix = target.format(*m.groups())
        if "scale" in p:
            stats = db
            for key in path.split("/"):
                stats = stats[key]
            _bn(sd, prefix, p, stats)
        else:
            sd[prefix + ".weight"] = _conv(p["kernel"])
            if "bias" in p:
                sd[prefix + ".bias"] = _vec(p["bias"])


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
        for k in (1, 2, 3):
            if f"conv{k}" in p:         # conv3/bn3: Bottleneck only
                sd[f"{pre}.conv{k}.weight"] = _conv(p[f"conv{k}"]["kernel"])
                _bn(sd, f"{pre}.bn{k}", p[f"bn{k}"], b[f"bn{k}"])
        if "down_conv" in p:
            sd[f"{pre}.downsample.0.weight"] = _conv(p["down_conv"]["kernel"])
            _bn(sd, f"{pre}.downsample.1", p["down_bn"], b["down_bn"])

    _decoder(sd, params["decoder"], stats["decoder"])

    _dense(sd, "classifier.fc.0", params["classifier"]["fc"])
    _dense(sd, "regressor.fc.0", params["regressor"]["fc1"])
    _dense(sd, "regressor.fc.2", params["regressor"]["fc2"])
    return sd
