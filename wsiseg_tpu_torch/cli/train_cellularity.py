"""Three-head cellularity trainer — counterpart of
``wsiseg_tpu/cli/train_cellularity.py`` (reference
``train_cellularity.py``).

Y-Net with classifier + regressor + decoder heads; batch rows route by
is_cls/is_reg/is_seg masks and the three losses sum
(train_cellularity.py:86-108). Validation writes the BreastPathQ CSV
(:122-128) when ``patch_folder``/``label_csv_path`` are set, else reports
the TTA regression over ``val_image_pth``.

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
from wsiseg_tpu_torch.infer.evaluators import (predict_breastpathq,
                                               predict_reg)
from wsiseg_tpu_torch.train.loop import Trainer
from wsiseg_tpu_torch.train.steps import make_hybrid_train_step


def train(cfg: Config, device="cuda") -> Trainer:
    n = mesh_ranks(cfg.mesh, device)
    if needs_ranks(n):
        return spawn_ranks(n, device, train, cfg=cfg, device=device)
    state, start_epoch = setup_ynet(cfg, device)
    model = state.model
    dev = next(model.parameters()).device
    wc, ws = cls_weights(cfg.train_image_pth, cfg)
    step = make_hybrid_train_step(model, cfg, cls_weights=wc,
                                  seg_weights=ws)
    ds = PatchDataset(cfg.train_image_pth, cfg)

    validate_fn = None
    if cfg.patch_folder and cfg.label_csv_path:
        def validate_fn(st, epoch):
            pth = predict_breastpathq(st.model, cfg, epoch,
                                      cfg.patch_folder, cfg.label_csv_path,
                                      device=dev)
            print(f"wrote submission {pth}")
            return {}
    elif cfg.val_image_pth:
        def validate_fn(st, epoch):
            if not os.path.isdir(cfg.val_image_pth):
                return {}
            try:
                val_ds = PatchDataset(cfg.val_image_pth, cfg, eval=True)
            except FileNotFoundError:
                return {}
            return predict_reg(st.model, cfg, val_ds.batches(), device=dev)

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
    return train(parse_args(rest), device=ns.device)


if __name__ == "__main__":
    main()
