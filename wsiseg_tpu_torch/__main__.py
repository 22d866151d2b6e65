"""``python -m wsiseg_tpu_torch <command> [flags]`` — CLI dispatcher.

The port serves the evaluation commands (``eval``, ``eval-tumorbed``,
``eval-spie``); the JAX package's other commands are still to be ported,
in the order ROADMAP.md lists. Slide conversion runs as ``python -m
wsiseg_tpu_torch.cli.convert_slide``, as in the JAX package.
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
            f"command {cmd!r} is not ported to wsiseg_tpu_torch yet (see "
            f"ROADMAP.md, queue 1); ported: {', '.join(COMMANDS)}. "
            "The JAX package runs it: python -m wsiseg_tpu " + cmd)
    return importlib.import_module(COMMANDS[cmd][0]).main(argv[1:])


if __name__ == "__main__":
    main()
