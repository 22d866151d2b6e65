"""Device seconds per slide of the whole-slide routes, for comparing two
trees of the port on one card in one call:

    python3 wsiseg_tpu_torch/route_throughput.py [--root DIR] [--iters 10] \
        [--model_name Unet] [--arch_encoder resnet18]

For the default route and, where the model has one (Unet on resnet18/34),
the fold route (``engine.fcn_fold``), at the bench geometry (a 4096×3072
level-2 synthetic slide, 4 classes, bf16, random weights from
``torch.Generator().manual_seed(0)``; resnet18 Unet unless the flags name
another decoder family or encoder):
``engine.device_throughput(mode="fcn")`` with 1 and 2 slides in flight.
``--root`` (default: this file's tree) is put first on ``sys.path``, so the
package measured is the one under DIR — e.g. a parent commit unpacked by
``git archive`` beside this one; run parent, this tree, this tree, parent.
Prints one JSON line; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH_HW = (3072, 4096)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--model_name", default="Unet")
    p.add_argument("--arch_encoder", default="resnet18")
    ns = p.parse_args(argv)
    sys.path.insert(0, str(Path(ns.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("route_throughput needs a CUDA device")
    from wsiseg_tpu_torch.config import default_config
    from wsiseg_tpu_torch.data.bench_slide import level2_image
    from wsiseg_tpu_torch.data.wsi_tiles import plan_slide
    from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
    from wsiseg_tpu_torch.models.ynet import init_ynet
    from wsiseg_tpu_torch.slides import VirtualPyramidSlide

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = default_config(wsi_mask_pth="", model_name=ns.model_name,
                         arch_encoder=ns.arch_encoder)
    engine = DenseInferenceEngine(
        init_ynet(cfg, torch.Generator().manual_seed(0)), cfg)
    fold_ok = ns.model_name == "Unet" and ns.arch_encoder in ("resnet18",
                                                              "resnet34")
    slide = VirtualPyramidSlide({2: level2_image(*BENCH_HW, seed=20)},
                                num_levels=3)
    plan = plan_slide("bench", slide, cfg)
    out = {"root": ns.root, "device": torch.cuda.get_device_name(0),
           "model_name": ns.model_name, "arch_encoder": ns.arch_encoder}
    for fold in (False, True) if fold_ok else (False,):
        engine.fcn_fold = fold
        route = "fold" if fold else "default"
        for nsf in (1, 2):
            out[f"{route}_sec_per_slide_{nsf}"] = engine.device_throughput(
                plan, mode="fcn", iters=ns.iters,
                slides_in_flight=nsf)["sec_per_slide"]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
