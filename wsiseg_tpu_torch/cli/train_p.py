"""Pure patch-classification trainer — counterpart of
``wsiseg_tpu/cli/train_p.py`` (reference ``train_p.py``).

The reference trains a pretrainedmodels backbone with a replaced final
linear (train_p.py:26-27); here, as in JAX, it is the Y-Net encoder +
classifier head trained through ``YNet.classify``, on the store's cls
rows oversampled ×10. Each validation reports accuracy and F1 over
``val_image_pth`` (train_p.py:82-113).

Runs on the CUDA device unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from wsiseg_tpu_torch.cli.common import (make_preprocess, make_train_mesh,
                                         mesh_ranks, needs_ranks,
                                         parse_train_flags, setup_ynet,
                                         spawn_ranks)
from wsiseg_tpu_torch.config import Config, parse_args
from wsiseg_tpu_torch.data.patches import PatchDataset, cls_weights
from wsiseg_tpu_torch.infer.evaluators import predict_cls
from wsiseg_tpu_torch.train.loop import Trainer
from wsiseg_tpu_torch.train.steps import make_cls_train_step


def train(cfg: Config, device="cuda") -> Trainer:
    n = mesh_ranks(cfg.mesh, device)
    if needs_ranks(n):
        return spawn_ranks(n, device, train, cfg=cfg, device=device)
    state, start_epoch = setup_ynet(cfg, device)
    dev = next(state.model.parameters()).device
    wc, _ = cls_weights(cfg.train_image_pth, cfg, ignore_seg=True)
    step = make_cls_train_step(state.model, cfg, class_weights=wc)
    ds = PatchDataset(cfg.train_image_pth, cfg, duplicate_dataset=10)

    validate_fn = None
    if cfg.val_image_pth:
        def validate_fn(st, epoch):
            if not os.path.isdir(cfg.val_image_pth):
                return {}
            try:
                val = PatchDataset(cfg.val_image_pth, cfg, eval=True)
            except FileNotFoundError:
                return {}
            out = predict_cls(st.model, cfg, val.batches(), device=dev)
            return {"acc": out["acc"], "f1": out["f1"]}

    trainer = Trainer(cfg, state, step,
                      mesh=make_train_mesh(cfg, n, device),
                      make_batches=lambda rows=None: ds.batches(
                          drop_remainder=True, rows=rows),
                      preprocess_batch=make_preprocess(cfg),
                      validate_fn=validate_fn)
    trainer.run(start_epoch=start_epoch)
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    ns, rest = parse_train_flags(argv)
    return train(parse_args(rest, loss="xent"), device=ns.device)


if __name__ == "__main__":
    main()
