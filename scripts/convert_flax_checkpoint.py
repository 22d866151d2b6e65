"""Convert a JAX/flax Y-Net or HR region-ensemble checkpoint into a
PyTorch one for ``wsiseg_tpu_torch``.

    python scripts/convert_flax_checkpoint.py \
        data/models/model_resnet18_194.msgpack out_dir/ [--arch resnet18]

Reads ``model_<arch>_<epoch>.msgpack`` with
``wsiseg_tpu.train.state.restore_checkpoint`` (so it runs where JAX and
flax are installed), converts the variables with
``wsiseg_tpu_torch.models.flax_import.from_flax`` — or, when the params
hold a ``trunk`` (a ``train-hr`` checkpoint), ``ensemble_from_flax`` —
and writes ``out_dir/model_<arch>_<epoch>.pt``, which ``python -m
wsiseg_tpu_torch eval-tumorbed --eval_model_pth out_dir`` (``slic`` and
``scannet`` for an HR checkpoint) restores. The model configuration comes
from the checkpoint's ``.config.json`` when present.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("msgpack", help="model_<arch>_<epoch>.msgpack")
    p.add_argument("out_dir", help="directory for model_<arch>_<epoch>.pt")
    p.add_argument("--arch", default=None,
                   help="encoder name (default: from the checkpoint config)")
    args = p.parse_args(argv)

    import flax.serialization
    import jax
    import numpy as np
    import torch

    from wsiseg_tpu.cli.common import setup_hr, setup_ynet
    from wsiseg_tpu.config import default_config
    from wsiseg_tpu.train.state import (load_checkpoint_config,
                                        restore_checkpoint)
    from wsiseg_tpu_torch.models.ensemble import build_ensemble
    from wsiseg_tpu_torch.models.flax_import import (ensemble_from_flax,
                                                     from_flax)
    from wsiseg_tpu_torch.models.ynet import build_ynet
    from wsiseg_tpu_torch.train.state import checkpoint_path

    cfg = load_checkpoint_config(args.msgpack) or default_config()
    if args.arch:
        cfg = cfg.replace(arch_encoder=args.arch)
    cfg = cfg.replace(continue_train=False, pretrained_pth=None)
    with open(args.msgpack, "rb") as f:
        hr = "trunk" in flax.serialization.msgpack_restore(f.read())[
            "params"]
    if hr:
        _, _, template, _ = setup_hr(cfg)
    else:
        _, _, template, _ = setup_ynet(cfg, tile_hw=(64, 64))
    state, start_epoch = restore_checkpoint(args.msgpack, template)
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats})
    model = build_ensemble(cfg) if hr else build_ynet(cfg)
    model.load_state_dict((ensemble_from_flax if hr else from_flax)(
        variables), strict=True)
    os.makedirs(args.out_dir, exist_ok=True)
    out = checkpoint_path(args.out_dir, cfg.arch_encoder, start_epoch - 1)
    torch.save({"epoch": start_epoch - 1, "state_dict": model.state_dict()},
               out)
    print(out)
    return out


if __name__ == "__main__":
    main()
