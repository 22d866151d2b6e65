"""Convert a slide to the ``.wsiraw`` mmap pyramid — counterpart (a copy) of
``wsiseg_tpu/cli/convert_slide.py``. One-time ingest for
formats the C++ fast path cannot decode (Aperio JPEG2000 SVS, compression
33003/33005; reference reads them via OpenSlide, utils/dataset.py:121).

Usage::

    python -m wsiseg_tpu_torch.cli.convert_slide in.svs out.wsiraw
    python -m wsiseg_tpu_torch.cli.convert_slide --dir slides/ --out_dir raw/

After conversion the native reader's threaded ``read_tiles`` serves the
dense-inference pipeline at full speed (slides/native.py).
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="slide → .wsiraw ingest")
    p.add_argument("src", nargs="?", help="input slide (.svs/.tif/.npy)")
    p.add_argument("dst", nargs="?", help="output .wsiraw path")
    p.add_argument("--dir", help="convert every slide (any supported "
                   "extension: svs/tif/tiff/ndpi) under this dir")
    p.add_argument("--out_dir", help="output dir for --dir mode")
    ns = p.parse_args(argv)

    from wsiseg_tpu_torch.slides.j2k import convert_to_wsiraw

    if ns.dir:
        out_dir = ns.out_dir or ns.dir
        os.makedirs(out_dir, exist_ok=True)
        from wsiseg_tpu_torch.slides.reader import glob_slides
        # .npy excluded (nothing to gain converting an array slide) and
        # .wsiraw naturally absent from glob results here would still be
        # skipped below as already-converted
        srcs = [s for s in glob_slides(ns.dir, include_npy=False)
                if not s.endswith(".wsiraw")]
        if not srcs:
            raise SystemExit(f"no slides under {ns.dir!r}")
        for src in srcs:
            stem = os.path.splitext(os.path.basename(src))[0]
            dst = os.path.join(out_dir, stem + ".wsiraw")
            convert_to_wsiraw(src, dst)
            print(f"{src} -> {dst}")
    else:
        if not ns.src or not ns.dst:
            raise SystemExit("need SRC DST (or --dir/--out_dir)")
        convert_to_wsiraw(ns.src, ns.dst)
        print(f"{ns.src} -> {ns.dst}")


if __name__ == "__main__":
    main()
