"""Tumor-bed heatmap generation over validation WSIs: restore checkpoint →
plan slides → dense inference (FCN by default; ``--grid``, the reference
overlap-add oracle; ``--streamed``, host-decoded tile batches) →
``<slide>_<stride>_heatmap.png`` + overlay — counterpart of
``wsiseg_tpu/cli/eval_tumorbed.py``. ``--sharded`` is not ported yet.

Runs on the CUDA device unless ``--device cpu`` asks for the CPU; without
a CUDA device the default raises ``RuntimeError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from wsiseg_tpu_torch.config import Config, parse_args
from wsiseg_tpu_torch.cli.common import parse_eval_flags, restore_for_eval
from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection
from wsiseg_tpu_torch.infer.engine import MULTI_GPU_ITEM, \
    DenseInferenceEngine, resolve_device
from wsiseg_tpu_torch.infer.evaluators import predict_tumorbed


def _eval(cfg: Config, mode: str = "seg", fcn: bool = False,
          sharded: bool = False, streamed: bool = False,
          slides_in_flight: int = 1, device="cuda") -> dict:
    if sharded:
        raise NotImplementedError(f"--sharded: {MULTI_GPU_ITEM}")
    device = resolve_device(device)
    model, epoch = restore_for_eval(cfg)
    engine = DenseInferenceEngine(model, cfg, mode=mode, device=device)
    engine.slides_in_flight = slides_in_flight
    collection = SlideCollection(cfg.raw_val_pth, cfg)
    return predict_tumorbed(engine, collection, epoch, fcn=fcn,
                            streamed=streamed)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ns, rest = parse_eval_flags(argv)
    return _eval(parse_args(rest), fcn=ns.fcn, sharded=ns.sharded,
                 streamed=ns.streamed, slides_in_flight=ns.slides_in_flight,
                 device=ns.device)


if __name__ == "__main__":
    main()
