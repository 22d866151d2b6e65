"""Tumor-bed heatmap generation over validation WSIs: restore checkpoint →
plan slides → dense FCN inference → ``<slide>_<stride>_heatmap.png`` +
overlay — counterpart of ``wsiseg_tpu/cli/eval_tumorbed.py``.

Runs on the CUDA device when one is present, else on the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from wsiseg_tpu.config import Config, parse_args
from wsiseg_tpu_torch.cli.common import parse_eval_flags, restore_for_eval
from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection
from wsiseg_tpu_torch.infer.engine import ROUTES_ITEM, DenseInferenceEngine
from wsiseg_tpu_torch.infer.evaluators import predict_tumorbed


def _eval(cfg: Config, mode: str = "seg", fcn: bool = True,
          sharded: bool = False, streamed: bool = False,
          slides_in_flight: int = 1, device=None) -> dict:
    if not fcn or sharded or streamed:
        raise NotImplementedError(f"--grid/--sharded/--streamed: "
                                  f"{ROUTES_ITEM}")
    device = device or ("cuda" if torch.cuda.is_available() else "cpu")
    model, epoch = restore_for_eval(cfg)
    engine = DenseInferenceEngine(model, cfg, mode=mode, device=device)
    engine.slides_in_flight = slides_in_flight
    collection = SlideCollection(cfg.raw_val_pth, cfg)
    return predict_tumorbed(engine, collection, epoch)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ns, rest = parse_eval_flags(argv)
    return _eval(parse_args(rest), fcn=ns.fcn, sharded=ns.sharded,
                 streamed=ns.streamed, slides_in_flight=ns.slides_in_flight)


if __name__ == "__main__":
    main()
