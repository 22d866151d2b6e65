"""SPIE BreastPathQ submission writer — counterpart of
``wsiseg_tpu/cli/eval_spie.py`` (reference ``eval_spie.py``): restore the
checkpoint → TTA regression over the test patch folder →
``Ozan_Results_<ep>.csv`` in the working directory.

Runs on the CUDA device unless ``--device cpu`` asks for the CPU; without
a CUDA device the default raises ``RuntimeError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from wsiseg_tpu_torch.cli.common import parse_device_flag, restore_for_eval
from wsiseg_tpu_torch.config import Config, parse_args
from wsiseg_tpu_torch.infer.engine import resolve_device
from wsiseg_tpu_torch.infer.evaluators import predict_breastpathq


def _eval(cfg: Config, out_dir: str = ".", device="cuda") -> str:
    device = resolve_device(device)
    model, epoch = restore_for_eval(cfg)
    if not (cfg.patch_folder and cfg.label_csv_path):
        raise SystemExit(
            "eval-spie requires --patch_folder and --label_csv_path")
    return predict_breastpathq(model, cfg, epoch, cfg.patch_folder,
                               cfg.label_csv_path, out_dir=out_dir,
                               device=device)


def main(argv: Optional[Sequence[str]] = None) -> str:
    ns, rest = parse_device_flag(argv, "the model runs")
    out = _eval(parse_args(rest), device=ns.device)
    print(out)
    return out


if __name__ == "__main__":
    main()
