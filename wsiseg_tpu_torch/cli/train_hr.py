"""Multi-patch region-ensemble trainer — counterpart of
``wsiseg_tpu/cli/train_hr.py`` (reference ``train_hr.py``).

:class:`~wsiseg_tpu_torch.models.ensemble.MultiPatchResNet` over (B, 16,
64, 64, 3) region samples of an HR region store
(``--train_hr_image_pth``); class-weighted cross entropy on the ensemble
logits (train_hr.py:62), the weights the inverse of the store's class
ratios; validation through ``regions.validate_hr`` over
``--val_hr_image_pth`` (train_hr.py:74 → utils/regiontools.py:144-204).

Runs on the CUDA device unless ``--device cpu`` asks for the CPU; without
a CUDA device the default raises ``RuntimeError``. ``--mesh N`` trains
data-parallel over N ranks, ``--mesh NxM`` over an N-way data × M-way
space mesh (each rank a stripe of every tile; ``parallel/spatial.py``);
on ``cuda`` one card a rank, raising when fewer are visible, and gloo
ranks with ``--device cpu``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from wsiseg_tpu_torch.cli.common import (make_hr_apply, make_preprocess,
                                         make_train_mesh, mesh_ranks,
                                         needs_ranks, parse_train_flags,
                                         setup_hr, spawn_ranks)
from wsiseg_tpu_torch.config import Config, parse_args
from wsiseg_tpu_torch.data.regions import HRRegionDataset, validate_hr
from wsiseg_tpu_torch.train.loop import Trainer
from wsiseg_tpu_torch.train.steps import make_hr_train_step


def inverse_ratio_weights(ratios: np.ndarray) -> np.ndarray:
    """Class weights from the store's class ratios, as JAX computes them
    in float32: 1/ratio where the class occurs (else 0), over the largest
    (the reference records cls_ratios for this, dataset_hr.py:130-133)."""
    r = np.asarray(ratios, np.float32)
    w = np.where(r > 0, np.float32(1.0) / np.maximum(r, np.float32(1e-8)),
                 np.float32(0.0)).astype(np.float32)
    return w / np.maximum(w.max(), np.float32(1e-8))


def train(cfg: Config, duplicate_dataset: int = 1, device="cuda") -> Trainer:
    n = mesh_ranks(cfg.mesh, device)
    if needs_ranks(n):
        return spawn_ranks(n, device, train, cfg=cfg,
                           duplicate_dataset=duplicate_dataset,
                           device=device)
    state, start_epoch = setup_hr(cfg, device)
    dev = next(state.model.parameters()).device
    ds = HRRegionDataset(cfg.train_hr_image_pth, cfg,
                         duplicate_dataset=duplicate_dataset, device=dev)
    step = make_hr_train_step(state.model, cfg,
                              class_weights=inverse_ratio_weights(
                                  ds.cls_ratios))

    validate_fn = None
    if cfg.val_hr_image_pth:
        def validate_fn(st, epoch):
            if not os.path.isdir(cfg.val_hr_image_pth):
                return {}
            try:
                val = HRRegionDataset(cfg.val_hr_image_pth, cfg, eval=True,
                                      device=dev)
            except FileNotFoundError:
                return {}
            out = validate_hr(make_hr_apply(st.model, cfg, dev), val, cfg)
            return {"acc": out["acc"]}

    trainer = Trainer(cfg, state, step,
                      mesh=make_train_mesh(cfg, n, device),
                      make_batches=lambda rows=None: ds.batches(rows=rows),
                      preprocess_batch=make_preprocess(cfg),
                      validate_fn=validate_fn)
    trainer.run(start_epoch=start_epoch)
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    ns, rest = parse_train_flags(argv)
    return train(parse_args(rest, loss="xent"), device=ns.device)


if __name__ == "__main__":
    main()
