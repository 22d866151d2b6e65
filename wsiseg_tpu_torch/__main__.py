"""``python -m wsiseg_tpu_torch <command> [flags]`` — CLI dispatcher.

The port serves every command of the JAX package's dispatcher: the
evaluation commands (``eval``, ``eval-tumorbed``, ``eval-spie``), the
trainers (``train``, ``train-cellularity``, ``train-p``, ``train-ssr``,
``train-hr``), the region-proposal demos (``slic``, ``scannet``), the
training-data generators (``preprocess <generator>``) and the paper tools
(``overlay-tb``, ``check-fp``, ``closest-regionproposal``). Slide
conversion runs as ``python -m wsiseg_tpu_torch.cli.convert_slide``, as
in the JAX package.
"""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "eval": ("wsiseg_tpu_torch.cli.eval",
             "full-WSI segmentation eval (eval.py)"),
    "eval-tumorbed": ("wsiseg_tpu_torch.cli.eval_tumorbed",
                      "tumor-bed heatmap generation (eval_tumorbed.py)"),
    "eval-spie": ("wsiseg_tpu_torch.cli.eval_spie",
                  "BreastPathQ submission writer (eval_spie.py)"),
    "train": ("wsiseg_tpu_torch.cli.train",
              "hybrid cls+reg+seg trainer (train.py)"),
    "train-cellularity": ("wsiseg_tpu_torch.cli.train_cellularity",
                          "3-head cls+reg+seg trainer "
                          "(train_cellularity.py)"),
    "train-p": ("wsiseg_tpu_torch.cli.train_p",
                "patch classification trainer (train_p.py)"),
    "train-ssr": ("wsiseg_tpu_torch.cli.train_ssr",
                  "same-sized-region segmentation trainer (train_ssr.py)"),
    "train-hr": ("wsiseg_tpu_torch.cli.train_hr",
                 "multi-patch region-ensemble trainer (train_hr.py)"),
    "slic": ("wsiseg_tpu_torch.cli.slic_demo",
             "SLIC proposal demo (slic.py)"),
    "scannet": ("wsiseg_tpu_torch.cli.scannet_demo",
                "CC proposal demo (scannet.py)"),
    "preprocess": ("wsiseg_tpu_torch.preprocess.__main__",
                   "training-data generators (preprocess/*.py)"),
    "overlay-tb": ("wsiseg_tpu_torch.paper_tools.overlay_tb_wsi",
                   "tumor-bed overlay rendering (paper_tools)"),
    "check-fp": ("wsiseg_tpu_torch.paper_tools.check_for_false_positives",
                 "slide-level FP screening (paper_tools)"),
    "closest-regionproposal": (
        "wsiseg_tpu_torch.paper_tools.closest_regionproposal",
        "region perimeter/keypoint analysis (closest_regionproposal.py)"),
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m wsiseg_tpu_torch <command> [flags]\n\n"
              "commands:")
        for name, (_, desc) in COMMANDS.items():
            print(f"  {name:20s} {desc}")
        return None
    cmd = argv[0]
    if cmd not in COMMANDS:
        raise SystemExit(
            f"unknown command {cmd!r}; try: {', '.join(COMMANDS)} (the "
            "JAX package's commands, every one ported; ROADMAP.md §4 lists "
            "the configurations the port does not yet run)")
    return importlib.import_module(COMMANDS[cmd][0]).main(argv[1:])


if __name__ == "__main__":
    main()
