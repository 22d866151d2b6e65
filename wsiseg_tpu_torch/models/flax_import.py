"""Flax Y-Net variables → the port's ``state_dict`` — counterpart (and
exact inverse) of ``wsiseg_tpu/models/torch_import.convert_ynet_state_dict``
— and the HR ensemble's (:func:`ensemble_from_flax`).

Input is the JAX ``{"params", "batch_stats"}`` tree as numpy arrays (no
JAX needed here); output keys are the smp/torchvision names the port's
:class:`~wsiseg_tpu_torch.models.ynet.YNet` uses. Conv kernels go HWIO →
OIHW with ``permute(3, 2, 0, 1)``, dense kernels (in, out) → (out, in).
Every decoder family (Unet, Linknet, FPN, PSPNet) and every encoder
(BasicBlock and Bottleneck); the decoder names are
``convert_ynet_state_dict``'s (``torch_import.py:106-117``). Arrays keep
their float dtype, float32 at least (float64 trees give float64 tensors).

:func:`optimizer_state_from_flax` carries an optax state across the same
way (adam and adabound ``count``/``mu``/``nu``, sgd's momentum
``trace``), so a state trained in JAX continues in the port, the
Y-Net's or the HR ensemble's.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping

import numpy as np
import torch

from wsiseg_tpu_torch.optim import AdaBound

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


def _float(x) -> np.dtype:
    return np.result_type(np.asarray(x).dtype, np.float32)


def _conv(k) -> torch.Tensor:
    k = np.asarray(k)
    return torch.from_numpy(np.array(k.transpose(3, 2, 0, 1), _float(k),
                                     order="C"))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, _float(v)))


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
    k = np.asarray(p["kernel"])
    sd[prefix + ".weight"] = torch.from_numpy(
        np.array(k.T, _float(k), order="C"))
    sd[prefix + ".bias"] = _vec(p["bias"])


def _encoder(sd: Dict, name: str, params: Mapping, stats: Mapping) -> None:
    """The flax ``ResNetEncoder`` under ``name`` (``encoder`` in the Y-Net,
    ``trunk`` in the ensemble) → torchvision keys under the same name."""
    ep, eb = params[name], stats[name]
    sd[f"{name}.conv1.weight"] = _conv(ep["stem_conv"]["kernel"])
    _bn(sd, f"{name}.bn1", ep["stem_bn"], eb["stem_bn"])
    for layer, p in ep.items():
        m = _LAYER_RE.match(layer)
        if m is None:
            continue
        pre = f"{name}.layer{m.group(1)}.{m.group(2)}"
        b = eb[layer]
        for k in (1, 2, 3):
            if f"conv{k}" in p:         # conv3/bn3: Bottleneck only
                sd[f"{pre}.conv{k}.weight"] = _conv(p[f"conv{k}"]["kernel"])
                _bn(sd, f"{pre}.bn{k}", p[f"bn{k}"], b[f"bn{k}"])
        if "down_conv" in p:
            sd[f"{pre}.downsample.0.weight"] = _conv(p["down_conv"]["kernel"])
            _bn(sd, f"{pre}.downsample.1", p["down_bn"], b["down_bn"])


def from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` numpy tree → YNet ``state_dict``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _encoder(sd, "encoder", params, stats)
    _decoder(sd, params["decoder"], stats["decoder"])

    _dense(sd, "classifier.fc.0", params["classifier"]["fc"])
    _dense(sd, "regressor.fc.0", params["regressor"]["fc1"])
    _dense(sd, "regressor.fc.2", params["regressor"]["fc2"])
    return sd


def ensemble_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``MultiPatchResNet``'s ``{"params", "batch_stats"}`` numpy
    tree → :class:`~wsiseg_tpu_torch.models.ensemble.MultiPatchResNet`
    ``state_dict``."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    _encoder(sd, "trunk", params, variables["batch_stats"])
    for name in ("fc0", "fc_1", "fc_2"):
        _dense(sd, name, params[name])
    return sd


def _optax_states(node):
    """The optax states (namedtuples) under a chain's nested tuples."""
    if hasattr(node, "_fields"):
        yield node
        return
    if isinstance(node, (tuple, list)):
        for x in node:
            yield from _optax_states(x)


def optimizer_state_from_flax(opt_state, variables: Mapping, model,
                              optimizer) -> dict:
    """A ``state_dict`` for ``optimizer`` (built over
    ``model.parameters()`` by :func:`wsiseg_tpu_torch.optim.
    build_optimizer`) from the JAX ``TrainState.opt_state`` of the same
    parameters, as numpy trees: ``mu``, ``nu`` and ``count`` of adam
    (``ScaleByAdamState``) and adabound (``AdaBoundState``) become
    ``exp_avg``, ``exp_avg_sq`` and ``step``; sgd's ``TraceState.trace``
    becomes ``momentum_buffer``. ``variables`` are the matching
    ``{"params", "batch_stats"}`` of a Y-Net or, with a ``trunk``, of the
    HR ensemble (the state's parameter trees are mapped by the same names
    as the parameters)."""
    names = [n for n, _ in model.named_parameters()]
    convert = (ensemble_from_flax if "trunk" in variables["params"]
               else from_flax)

    def by_name(tree) -> List[torch.Tensor]:
        sd = convert({"params": tree,
                      "batch_stats": variables["batch_stats"]})
        return [sd[n] for n in names]

    per_param = [dict() for _ in names]
    for st in _optax_states(opt_state):
        fields = st._fields
        if "mu" in fields and "nu" in fields:
            count = int(np.asarray(st.count))
            for d, m, v in zip(per_param, by_name(st.mu), by_name(st.nu)):
                d["exp_avg"], d["exp_avg_sq"] = m, v
                d["step"] = (count if isinstance(optimizer, AdaBound)
                             else torch.tensor(float(count)))
        elif "trace" in fields:
            for d, t in zip(per_param, by_name(st.trace)):
                d["momentum_buffer"] = t
    out = optimizer.state_dict()
    out["state"] = {i: d for i, d in enumerate(per_param) if d}
    return out
