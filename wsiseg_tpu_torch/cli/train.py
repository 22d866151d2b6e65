"""Hybrid classification + regression + segmentation trainer — counterpart
of ``wsiseg_tpu/cli/train.py`` (reference ``train.py``).

Builds the Y-Net, trains on a gt.npy patch store with mixed cls/reg/seg
rows (routed by per-row task masks), validates with whole-slide dense
inference over ``raw_val_pth`` (reference train.py:108-109 →
``predict_wsis``), and checkpoints on the ``save_models`` cadence.
``--device_cache`` copies the u8 training set to the card once and
gathers each step's rows there
(:mod:`~wsiseg_tpu_torch.train.device_cache`).

Runs on the CUDA device unless ``--device cpu`` asks for the CPU; without
a CUDA device the default raises ``RuntimeError``. ``--mesh`` raises
``NotImplementedError`` (ROADMAP.md, Multi-GPU).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from wsiseg_tpu_torch.cli.common import (check_single_device,
                                         make_preprocess, parse_train_flags,
                                         setup_ynet)
from wsiseg_tpu_torch.config import Config, parse_args
from wsiseg_tpu_torch.data.patches import PatchDataset, cls_weights
from wsiseg_tpu_torch.train.loop import Trainer
from wsiseg_tpu_torch.train.steps import make_hybrid_train_step


def wsi_validation(cfg: Config, model, device):
    """validate_fn over the slides under ``cfg.raw_val_pth``: one engine
    on the training model, its weights refreshed before each run;
    returns the mean tumor-bed IoU."""
    cache = {}

    def validate_fn(state, epoch):
        if not os.path.isdir(cfg.raw_val_pth):
            return {}
        from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection
        from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
        from wsiseg_tpu_torch.infer.evaluators import predict_wsis
        if "collection" not in cache:
            cache["collection"] = SlideCollection(cfg.raw_val_pth, cfg)
            cache["engine"] = DenseInferenceEngine(model, cfg, device=device)
        if not len(cache["collection"]):
            return {}
        cache["engine"].refresh_weights()
        res = predict_wsis(cache["engine"], cache["collection"], epoch)
        return {"mean_tb_iou": res.get("_mean_tb_iou", float("nan"))}

    return validate_fn


def train(cfg: Config, device="cuda") -> Trainer:
    check_single_device(cfg)
    state, start_epoch = setup_ynet(cfg, device)
    model = state.model
    dev = next(model.parameters()).device
    wc, ws = cls_weights(cfg.train_image_pth, cfg)
    step = make_hybrid_train_step(model, cfg, cls_weights=wc,
                                  seg_weights=ws)
    ds = PatchDataset(cfg.train_image_pth, cfg)
    preprocess = make_preprocess(cfg)
    make_batches = lambda: ds.batches(drop_remainder=True)  # noqa: E731
    if cfg.device_cache:
        from wsiseg_tpu_torch.train.device_cache import (
            DeviceEpochCache, make_cached_hybrid_train_step)
        cache = DeviceEpochCache.build(
            ds.batches(drop_remainder=True), cfg, dev,
            max_bytes=int(cfg.device_cache_gb * 1e9), log=print)
        cstep = make_cached_hybrid_train_step(model, cfg, cls_weights=wc,
                                              seg_weights=ws)
        preprocess = None        # normalize + jitter run after the gather
        epochs = iter(range(10 ** 9))

        def step(st, b, g):
            return cstep(st, cache.arrays, b["idx"], g)

        def make_batches():
            ep = next(epochs)
            return ({"idx": ix} for ix in cache.index_batches(
                cfg.batch_size, seed=cfg.seed, epoch=ep))

    validate_fn = (wsi_validation(cfg, model, dev) if cfg.raw_val_pth
                   else None)
    trainer = Trainer(cfg, state, step, make_batches=make_batches,
                      preprocess_batch=preprocess, validate_fn=validate_fn)
    trainer.run(start_epoch=start_epoch)
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    ns, rest = parse_train_flags(argv)
    return train(parse_args(rest), device=ns.device)


if __name__ == "__main__":
    main()
