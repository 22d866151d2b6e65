"""``python -m wsiseg_tpu_torch preprocess <generator> [flags]``
dispatcher — counterpart of ``wsiseg_tpu/preprocess/__main__.py``, with
the same generator names."""

from __future__ import annotations

import sys

GENERATORS = {
    "mk-gt": "wsiseg_tpu_torch.preprocess.mk_gt",
    "centered": "wsiseg_tpu_torch.preprocess.mk_traindata_centered",
    "no-tumors": "wsiseg_tpu_torch.preprocess.mk_traindata_no_tumors",
    "patch-to-gt": "wsiseg_tpu_torch.preprocess.patch_to_gt",
    "patch-to-cls": "wsiseg_tpu_torch.preprocess.patch_to_cls",
    "breastpathq-cells": "wsiseg_tpu_torch.preprocess.breastpathq_cells",
    "makedata-ssr": "wsiseg_tpu_torch.preprocess.makedata_ssr",
    "ssr-patch-to-gt": "wsiseg_tpu_torch.preprocess.ssr_patch_to_gt",
    "region-proposal-points":
        "wsiseg_tpu_torch.preprocess.region_proposal_points",
    "collage": "wsiseg_tpu_torch.preprocess.collage_of_patches",
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m wsiseg_tpu_torch preprocess <generator> "
              "[flags]\n")
        for name in GENERATORS:
            print(f"  {name}")
        return None
    name = argv[0]
    if name not in GENERATORS:
        raise SystemExit(f"unknown generator {name!r}; "
                         f"try: {', '.join(GENERATORS)}")
    import importlib
    return importlib.import_module(GENERATORS[name]).main(argv[1:])


if __name__ == "__main__":
    main()
