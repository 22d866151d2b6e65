"""Shared CLI plumbing — counterpart of ``wsiseg_tpu/cli/common.py``
(``restore_for_eval`` for ``.pt`` checkpoints and ``parse_eval_flags``)."""

from __future__ import annotations

import argparse

import torch

from wsiseg_tpu.config import Config
from wsiseg_tpu_torch.models.ynet import init_ynet
from wsiseg_tpu_torch.train.state import latest_checkpoint, \
    restore_checkpoint


def restore_for_eval(cfg: Config):
    """Y-Net with the latest ``cfg.eval_model_pth`` checkpoint, or fresh
    weights from ``cfg.seed`` (with a warning) when there is none.
    Returns (model, epoch) like the JAX function."""
    if cfg.pretrained_pth:
        raise NotImplementedError(
            "pretrained_pth grafting is not ported yet: ROADMAP.md, "
            "queue 1, 'training'")
    model = init_ynet(cfg, torch.Generator().manual_seed(cfg.seed))
    pth = latest_checkpoint(cfg.eval_model_pth)
    if pth:
        model, epoch = restore_checkpoint(pth, model)
        print(f"restored {pth} (epoch {epoch - 1})")
    else:
        epoch = cfg.start_epoch
        print(f"WARNING: no checkpoint at {cfg.eval_model_pth}; "
              "using fresh weights")
    return model, epoch - 1


def parse_eval_flags(argv):
    """Mode pre-parser for the eval CLIs (same flags as the JAX package).
    FCN is the default; ``--grid``, ``--streamed`` and ``--sharded`` are
    parsed so that the eval entry can refuse them by name."""
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
    ns, rest = p.parse_known_args(argv)
    if ns.fcn and (ns.grid or ns.streamed or ns.sharded):
        p.error("--fcn is mutually exclusive with --grid/--streamed/"
                "--sharded (FCN is already the default; drop --fcn)")
    ns.fcn = not (ns.grid or ns.streamed or ns.sharded)
    return ns, rest
