"""Full-WSI segmentation evaluation — counterpart of
``wsiseg_tpu/cli/eval.py`` (reference ``eval.py``): restore the checkpoint,
plan every slide under ``raw_val_pth`` (then ``raw_val1_pth`` when set),
and run dense inference with the tumor bed, the metrics and the color
mask (:func:`~wsiseg_tpu_torch.infer.evaluators.predict_wsis`). FCN by
default; ``--grid``, ``--streamed`` as in ``eval-tumorbed``;
``--sharded`` splits each slide's tiles over ranks (every visible card
on ``cuda``; ``--mesh N`` asks for N, and gives the gloo ranks with
``--device cpu``), which this command spawns unless it runs under a
process group already (``torchrun``).

Runs on the CUDA device unless ``--device cpu`` asks for the CPU; without
a CUDA device the default raises ``RuntimeError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from wsiseg_tpu_torch.cli.common import (make_eval_mesh, mesh_ranks,
                                         needs_ranks, parse_eval_flags,
                                         restore_for_eval, spawn_ranks)
from wsiseg_tpu_torch.config import Config, parse_args
from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection
from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine, \
    resolve_device
from wsiseg_tpu_torch.infer.evaluators import predict_wsis


def _eval(cfg: Config, fcn: bool = False, sharded: bool = False,
          streamed: bool = False, slides_in_flight: int = 1,
          device="cuda") -> dict:
    device = resolve_device(device)
    mesh = None
    if sharded:
        n = mesh_ranks(cfg.mesh or "all", device)
        if needs_ranks(n, sharded=True):
            return spawn_ranks(n, device, _eval, cfg=cfg, fcn=fcn,
                               sharded=True, streamed=streamed,
                               slides_in_flight=slides_in_flight,
                               device=device)
        mesh = make_eval_mesh(cfg, n, device)
    model, epoch = restore_for_eval(cfg)
    engine = DenseInferenceEngine(model, cfg, device=device)
    engine.slides_in_flight = slides_in_flight
    results = {}
    for src in filter(None, [cfg.raw_val_pth, cfg.raw_val1_pth]):
        collection = SlideCollection(src, cfg)
        if len(collection):
            results.update(predict_wsis(engine, collection, epoch, fcn=fcn,
                                        mesh=mesh, streamed=streamed))
    return results


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ns, rest = parse_eval_flags(argv)
    return _eval(parse_args(rest), fcn=ns.fcn, sharded=ns.sharded,
                 streamed=ns.streamed, slides_in_flight=ns.slides_in_flight,
                 device=ns.device)


if __name__ == "__main__":
    main()
