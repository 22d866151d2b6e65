"""Re-render a saved heatmap as a WSI overlay with a convex-hull tumor-bed
perimeter — counterpart of ``wsiseg_tpu/paper_tools/overlay_tb_wsi.py``
(reference ``paper_tools/overlay_tb_wsi.py``).

Pipeline (reference :44-72): heatmap ≥ 0.9 → 30×30 opening → masked heatmap;
tumor-bed perimeter = dilate(bwperim(chull(mask)), 20); overlay =
0.65·wsi + 0.35·heatmap with the perimeter painted black. The morphology
runs on ``device`` (ops/morphology), the convex hull on the host
(ops/hull), as in JAX.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from wsiseg_tpu_torch.cli.common import add_device_flag
from wsiseg_tpu_torch.infer.engine import resolve_device
from wsiseg_tpu_torch.slides.reader import open_slide


def overlay_tumor_bed(wsi_rgb: np.ndarray, heatmap_u8: np.ndarray,
                      thresh: float = 0.9, open_size: int = 30,
                      dilate_size: int = 20, device="cuda") -> dict:
    """Returns dict with 'overlay', 'tb_perim', 'heatmap' uint8 arrays."""
    from wsiseg_tpu_torch.ops.hull import convex_hull_image
    from wsiseg_tpu_torch.ops.morphology import bwperim, dilate, opening

    dev = resolve_device(device)
    hm = np.asarray(heatmap_u8)
    mask = np.uint8(hm / 255.0 >= thresh)
    mask = opening(torch.from_numpy(mask).to(dev),
                   open_size).cpu().numpy().astype(np.uint8)

    masked_heat = (hm * mask)[..., None].repeat(3, axis=2)

    tb = convex_hull_image(mask)
    perim = dilate(bwperim(torch.tensor(tb, device=dev)),
                   dilate_size).cpu().numpy()

    overlay = 0.65 * np.asarray(wsi_rgb, np.float64) + 0.35 * masked_heat
    overlay[perim > 0] = 0
    return {"overlay": overlay.astype(np.uint8),
            "tb_perim": (255 * (perim > 0)).astype(np.uint8),
            "heatmap": hm}


def run(svs_path: str, heatmap_path: str, out_dir: str = ".",
        downscale: int = 4, device="cuda") -> dict:
    device = resolve_device(device)
    slide = open_slide(svs_path)
    wsi = slide.read_level(2)
    hm_img = Image.open(heatmap_path).convert("L")
    x, y = hm_img.size
    wsi = np.asarray(Image.fromarray(wsi).resize((x, y)))
    out = overlay_tumor_bed(wsi, np.asarray(hm_img), device=device)

    paths = {}
    for key, name in (("overlay", "overlay_tumor_bed.png"),
                      ("tb_perim", "tumor_bed_perim.png"),
                      ("heatmap", "heatmap.png")):
        pth = os.path.join(out_dir, name)
        Image.fromarray(out[key]).resize((x // downscale,
                                          y // downscale)).save(pth)
        paths[key] = pth
    wsi_pth = os.path.join(out_dir, "wsi.png")
    Image.fromarray(wsi).resize((x // downscale, y // downscale)).save(wsi_pth)
    paths["wsi"] = wsi_pth
    return paths


def main(argv: Optional[Sequence[str]] = None) -> dict:
    import argparse
    p = argparse.ArgumentParser(description="tumor-bed overlay rendering")
    p.add_argument("image_id")
    p.add_argument("--raw_val_pth", default="data/test/wsi")
    p.add_argument("--val_save_pth", default="data/val/out")
    p.add_argument("--out_dir", default=".")
    add_device_flag(p, "the opening, perimeter and dilation run")
    ns = p.parse_args(argv)
    resolve_device(ns.device)

    svs_path = None
    for root, _, names in os.walk(ns.raw_val_pth):
        # every routable slide extension (reader.SLIDE_EXTS) + .npy
        for ext in (".svs", ".tif", ".tiff", ".ndpi", ".wsiraw", ".npy"):
            if f"{ns.image_id}{ext}" in names:
                svs_path = os.path.join(root, f"{ns.image_id}{ext}")
                break
        if svs_path:
            break
    if not svs_path:
        raise SystemExit(f"slide {ns.image_id} not found under {ns.raw_val_pth}")

    from wsiseg_tpu_torch.utils.filesystem import find_heatmaps
    heatmaps = find_heatmaps(ns.val_save_pth, ns.image_id)
    if not heatmaps:
        raise SystemExit(f"no heatmap for {ns.image_id} under {ns.val_save_pth}")
    paths = run(svs_path, heatmaps[0], ns.out_dir, device=ns.device)
    print(paths)
    return paths


if __name__ == "__main__":
    main()
