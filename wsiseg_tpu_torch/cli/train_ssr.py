"""Same-sized-region segmentation trainer — counterpart of
``wsiseg_tpu/cli/train_ssr.py`` (reference ``train_ssr.py``).

Pure segmentation on 512×512 region crops with a selectable loss (focal
by default, as in the reference) plus dice (train_ssr.py:45-46); each
validation reports pixel accuracy and binary (tumor/normal) accuracy
(:106-133) over ``val_image_pth``.

Runs on the CUDA device unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from wsiseg_tpu_torch.cli.common import (make_preprocess, make_train_mesh,
                                         mesh_ranks, needs_ranks,
                                         parse_train_flags, setup_ynet,
                                         spawn_ranks)
from wsiseg_tpu_torch.config import Config, parse_args
from wsiseg_tpu_torch.data.ssr import SSRSegDataset
from wsiseg_tpu_torch.models.ynet import compute_copy
from wsiseg_tpu_torch.train.loop import Trainer
from wsiseg_tpu_torch.train.steps import make_seg_train_step


@torch.no_grad()
def validate_ssr(model, cfg: Config, dataset) -> dict:
    """Pixel accuracy + binary accuracy over a validation set (reference
    train_ssr.py:106-133, minus the visualization grids), the model in
    ``cfg.compute_dtype`` in eval mode, as JAX's ``YNet.segment``."""
    dev = next(model.parameters()).device
    dtype = getattr(torch, cfg.compute_dtype)
    net = compute_copy(model, dtype)
    preprocess = make_preprocess(cfg, train=False)
    accs, baccs = [], []
    for batch in dataset.batches():
        x = preprocess({"image": torch.from_numpy(batch["image"]).to(dev)})
        x = x["image"].permute(0, 3, 1, 2).to(
            dtype, memory_format=torch.channels_last)
        pred = net.segment(x).argmax(1).cpu().numpy()
        gt = batch["seg_label"]
        accs.append(float(np.mean(pred == gt)))
        baccs.append(float(np.mean((pred > 1) == (gt > 1))))
    return {"acc": float(np.mean(accs)) if accs else 0.0,
            "binary_acc": float(np.mean(baccs)) if baccs else 0.0}


def train(cfg: Config, with_dice: bool = True, device="cuda") -> Trainer:
    n = mesh_ranks(cfg.mesh, device)
    if needs_ranks(n):
        return spawn_ranks(n, device, train, cfg=cfg, with_dice=with_dice,
                           device=device)
    state, start_epoch = setup_ynet(cfg, device)
    step = make_seg_train_step(state.model, cfg, with_dice=with_dice)
    ds = SSRSegDataset(cfg.train_image_pth, cfg)

    validate_fn = None
    if cfg.val_image_pth:
        def validate_fn(st, epoch):
            if not os.path.isdir(cfg.val_image_pth):
                return {}
            try:
                val = SSRSegDataset(cfg.val_image_pth, cfg, eval=True)
            except FileNotFoundError:
                return {}
            return validate_ssr(st.model, cfg, val)

    trainer = Trainer(cfg, state, step,
                      mesh=make_train_mesh(cfg, n, device),
                      make_batches=lambda rows=None: ds.batches(rows=rows),
                      preprocess_batch=make_preprocess(cfg),
                      validate_fn=validate_fn)
    trainer.run(start_epoch=start_epoch)
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    ns, rest = parse_train_flags(argv)
    return train(parse_args(rest, loss="focal"), device=ns.device)


if __name__ == "__main__":
    main()
