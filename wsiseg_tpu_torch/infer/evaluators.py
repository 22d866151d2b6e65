"""High-level evaluators — counterpart of ``wsiseg_tpu/infer/evaluators.py``
(reference utils/eval.py), each on an explicit device:

* :func:`predict_wsis` — dense inference, tumor bed, metrics and the color
  mask (utils/eval.py:22-152)
* :func:`predict_tumorbed` — dense inference, heatmap and overlay
  (utils/eval.py:155-286)
* :func:`predict_reg` — 4-way TTA regression over patch batches
  (utils/eval.py:289-351)
* :func:`predict_breastpathq` — TTA regression and the submission CSV
  (utils/eval.py:354-412)
* :func:`predict_cls` — classification accuracy and F1
  (utils/eval.py:415-449)

The slide evaluators run over every branch of :func:`_pipelined_results`
(grid, streamed, FCN, and each of them over a mesh, where every rank runs
the evaluator and rank 0 alone computes the metrics, writes the PNGs and
returns the results). The patch evaluators run the Y-Net in
``cfg.compute_dtype`` (:func:`~wsiseg_tpu_torch.models.ynet.compute_copy`,
``channels_last``), as the grid's tile forward does."""

from __future__ import annotations

import csv
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List

import numpy as np
import torch
from torch.profiler import record_function

from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.data.patches import normalize_batch_images
from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection, resize_mask_to
from wsiseg_tpu_torch.infer import metrics as M
from wsiseg_tpu_torch.infer import writers
from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine, \
    extract_tumor_bed, resolve_device
from wsiseg_tpu_torch.models.ynet import YNet, compute_copy
from wsiseg_tpu_torch.ops.threshold import pred_to_mask


def _load_gt_artifacts(plan, shape_hw):
    """GT rasters saved by preprocess/mk_gt.py beside the slide:
    ``<slide>_mask.png`` (class codes) and ``<slide>_tumor_bed.png``,
    resized NEAREST to ``shape_hw`` (bicubic would interpolate class codes
    into invalid classes at boundaries)."""
    out = {}
    if plan.path:
        from PIL import Image
        mask_pth = plan.path + "_mask.png"
        if os.path.exists(mask_pth):
            g = Image.open(mask_pth).resize((shape_hw[1], shape_hw[0]),
                                            Image.NEAREST)
            out["gt"] = np.array(g)
        tb_pth = plan.path + "_tumor_bed.png"
        if os.path.exists(tb_pth):
            tb = Image.open(tb_pth).convert("L").resize(
                (shape_hw[1], shape_hw[0]), Image.NEAREST)
            out["tb_gt"] = (np.array(tb) > 0).astype(np.uint8)
    return out


def _pipelined_results(engine: DenseInferenceEngine,
                       collection: SlideCollection, fcn: bool = False,
                       mesh=None, streamed: bool = False):
    """Iterate (name, plan, result) (JAX ``evaluators.py:56-172``).

    - ``streamed``: each slide's tile batches decoded on the host and
      prefetched (``predict_slide_streamed``).
    - ``fcn``: groups of up to ``engine.slides_in_flight`` consecutive
      slides with one ``engine.fcn_group_key`` run as one batched forward
      (``predict_slides_fcn``, :func:`_fcn_groups`); a slide without one
      is a group of its own (``predict_slide_fcn``). The route runs one
      group deep: a group of two or more slides is called with the next
      group as its ``ahead`` when that one shares a forward too, so the
      engine enqueues group g+1 before the host waits for group g, and
      group g's copies and heat to f32 run under g+1's forward; group
      g+1 stays pending on the engine until the next call returns its
      results. A single-slide group, and a group before one, is served
      synchronously. A worker thread stages (reads, pads, uploads) two
      groups ahead of the one being finished, so the next group's images
      are there when it is launched; ``stage_slide_fcn`` stages nothing
      for a slide the fused route does not take (over
      ``fcn_fast_max_px``: the banded route, one band at a time; cls
      mode, ``scan_resize`` ≠ 1). Each wait on a group's staging is range
      ``pipeline.stage_wait``. Closing the generator early waits for and
      drops a pending group (``engine.drop_ahead``).
    - otherwise the grid: slide k+1's level image is staged
      (``stage_slide``) while slide k computes.

    With ``mesh`` (JAX ``evaluators.py:70-101``) every rank iterates:
    ``fcn`` runs the row-striped FCN (``predict_slide_fcn_sharded_rows``)
    with slide k+1's stripe staged while slide k computes; ``streamed``
    runs ``predict_slide_streamed_sharded``; the grid runs
    ``predict_slide_sharded``."""
    if streamed and fcn:
        raise ValueError("fcn and streamed are mutually exclusive")
    items = list(collection.items())
    if mesh is not None and fcn:
        with ThreadPoolExecutor(max_workers=1) as pool:
            staged = (pool.submit(engine.stage_slide_fcn_rows, items[0][1],
                                  mesh) if items else None)
            for i, (name, plan) in enumerate(items):
                nxt = (pool.submit(engine.stage_slide_fcn_rows,
                                   items[i + 1][1], mesh)
                       if i + 1 < len(items) else None)
                res = engine.predict_slide_fcn_sharded_rows(
                    plan, mesh, staged=staged.result())
                staged = nxt
                yield name, plan, res
        return
    if streamed:
        for name, plan in items:
            res = (engine.predict_slide_streamed_sharded(plan, mesh)
                   if mesh is not None
                   else engine.predict_slide_streamed(plan))
            yield name, plan, res
        return
    if mesh is not None:
        for name, plan in items:
            yield name, plan, engine.predict_slide_sharded(plan, mesh)
        return
    if fcn:
        groups = _fcn_groups(engine, items)

        def stage_group(g):
            return [engine.stage_slide_fcn(p) for _, p in g]

        def staged_images(gi):
            with record_function("pipeline.stage_wait"):
                imgs = staged[gi].result()
            staged[gi] = None
            return imgs

        with ThreadPoolExecutor(max_workers=1) as pool:
            staged = [pool.submit(stage_group, g) for g in groups[:2]]
            imgs = None
            try:
                for gi, g in enumerate(groups):
                    if gi + 2 < len(groups):
                        staged.append(pool.submit(stage_group,
                                                  groups[gi + 2]))
                    if imgs is None:
                        imgs = staged_images(gi)
                    plans = [p for _, p in g]
                    if len(g) == 1:
                        res_list = [engine.predict_slide_fcn(plans[0],
                                                             img=imgs[0])]
                        imgs = None
                    else:
                        nxt = groups[gi + 1] if gi + 1 < len(groups) else []
                        ahead = (([p for _, p in nxt], staged_images(gi + 1))
                                 if len(nxt) > 1 else None)
                        res_list = engine.predict_slides_fcn(
                            plans, imgs=imgs, ahead=ahead)
                        # the next group's images, already in its launch
                        imgs = ahead[1] if ahead else None
                    for (name, plan), res in zip(g, res_list):
                        yield name, plan, res
            finally:
                engine.drop_ahead()
        return
    with ThreadPoolExecutor(max_workers=1) as pool:
        staged = pool.submit(engine.stage_slide, items[0][1]) \
            if items else None
        for idx, (name, plan) in enumerate(items):
            nxt = (pool.submit(engine.stage_slide, items[idx + 1][1])
                   if idx + 1 < len(items) else None)
            res = engine.predict_slide(plan, level_img=staged.result())
            staged = nxt
            yield name, plan, res


def _fcn_groups(engine: DenseInferenceEngine, items) -> List[List]:
    """``items`` ((name, plan) in order) cut into the FCN branch's groups:
    runs of up to ``engine.slides_in_flight`` consecutive slides with one
    ``engine.fcn_group_key``; a slide whose key is None is a group of its
    own."""
    n_flight = max(1, int(engine.slides_in_flight))
    groups, cur, cur_key = [], [], None
    for it in items:
        key = engine.fcn_group_key(it[1])
        if cur and (len(cur) == n_flight or key != cur_key or key is None):
            groups.append(cur)
            cur = []
        cur_key = key
        cur.append(it)
    if cur:
        groups.append(cur)
    return groups


def predict_wsis(engine: DenseInferenceEngine, collection: SlideCollection,
                 ep, fcn: bool = False, mesh=None, streamed: bool = False,
                 log: Callable = print) -> Dict:
    """Per slide: dense prediction, tumor-bed extraction on the engine's
    device, the metric report against the GT rasters beside the slide, and
    the color mask with the tumor bed's perimeter in white. Returns
    {slide: metrics dict} plus '_mean_tb_iou' (with a mesh: on rank 0;
    the other ranks return {}). The grid is the default, as in JAX; the CLI
    defaults to FCN."""
    cfg = engine.cfg
    max_class = float(cfg.num_classes - 1)
    results = {}
    ious_tb = []
    lead = _lead(mesh)
    for name, plan, res in _pipelined_results(engine, collection, fcn,
                                               mesh=mesh, streamed=streamed):
        if not lead:
            continue
        h2w2 = plan.canvas_hw
        tb_filled, tb_perim = extract_tumor_bed(res.labels,
                                                device=engine.device)
        gts = _load_gt_artifacts(plan, h2w2)
        mask2 = plan_mask_resized(plan, h2w2)

        rec = {"num_tiles": res.num_tiles, "seconds": res.seconds,
               "patches_per_sec": res.patches_per_sec}
        if "gt" in gts:
            gt = gts["gt"]
            p = res.labels
            rec["acc"] = M.masked_pixel_accuracy(p, gt)
            rec["s"] = M.spie_score(p, gt, max_class=max_class)
            p_masked = mask2 * p
            rec["acc_masked"] = M.masked_pixel_accuracy(p_masked, gt)
            rec["s_masked"] = M.spie_score(p_masked, gt, max_class=max_class)
            rec["iou_fg"] = M.foreground_iou(p_masked, gt)
        if "tb_gt" in gts:
            rec["iou_tb"] = M.iou(tb_filled, gts["tb_gt"], eps=cfg.epsilon)
            ious_tb.append(rec["iou_tb"])

        # color mask with a white tumor-bed perimeter (utils/eval.py:139-145)
        rgb = pred_to_mask(torch.from_numpy(res.labels).to(engine.device),
                           cfg.num_classes).cpu().numpy()
        rgb = mask2[..., None] * rgb
        rgb[tb_perim > 0] = [255, 255, 255]
        writers.save_color_mask(cfg, ep, name, rgb)

        log(f"{name}, s {rec.get('s_masked', float('nan')):.3f}"
            f"({rec.get('s', float('nan')):.3f}), "
            f"acc {rec.get('acc_masked', float('nan')):.3f}"
            f"({rec.get('acc', float('nan')):.3f}), "
            f"fg iou {rec.get('iou_fg', float('nan')):.3f}, "
            f"tb iou {rec.get('iou_tb', -1):.3f}, "
            f"{res.patches_per_sec:.0f} patches/s")
        results[name] = rec

    if not lead:
        return results
    mean_tb = float(np.mean(ious_tb)) if ious_tb else float("nan")
    log(f"Average tb iou: {mean_tb:.3f}")
    results["_mean_tb_iou"] = mean_tb
    return results


def _lead(mesh) -> bool:
    """This rank writes and reports: always on one device, rank 0 of a
    mesh."""
    if mesh is None:
        return True
    from wsiseg_tpu_torch.parallel.mesh import mesh_rank
    return mesh_rank(mesh) == 0


def plan_mask_resized(plan, hw) -> np.ndarray:
    """The slide's tissue mask at ``hw``, NEAREST as PIL resizes it."""
    return resize_mask_to(plan.mask, hw)


def predict_tumorbed(engine: DenseInferenceEngine,
                     collection: SlideCollection, ep, fcn: bool = False,
                     mesh=None, streamed: bool = False,
                     log: Callable = print) -> Dict:
    """Heatmap + overlay artifacts per slide (reference
    utils/eval.py:155-286). The grid is the default, as in JAX; the CLI
    defaults to FCN (``parse_eval_flags``). With a mesh, rank 0 writes and
    returns the artifacts; the other ranks return {}."""
    cfg = engine.cfg
    results = {}
    lead = _lead(mesh)
    for name, plan, res in _pipelined_results(engine, collection, fcn,
                                               mesh=mesh, streamed=streamed):
        if not lead:
            continue
        heat_pth = writers.save_heatmap(cfg, ep, name, res.heatmap)
        wsi2 = plan.slide.read_level(2)
        overlay_pth = writers.save_overlay(cfg, ep, name, wsi2, res.heatmap)
        results[name] = {"heatmap": heat_pth, "overlay": overlay_pth,
                         "num_tiles": res.num_tiles,
                         "seconds": res.seconds,
                         "patches_per_sec": res.patches_per_sec}
        log(f"{name}: {res.num_tiles} tiles in {res.seconds:.2f}s "
            f"({res.patches_per_sec:.0f} patches/s)")
    return results


def _tta_variants(x: torch.Tensor) -> List[torch.Tensor]:
    """The reference's 4-way TTA set (utils/eval.py:308-313) on NCHW:
    identity, transpose(H, W), vertical flip, transpose then horizontal
    flip (JAX's NHWC ``x``, ``transpose(0, 2, 1, 3)``, ``x[:, ::-1]``,
    ``transpose(...)[:, :, ::-1]``)."""
    t = x.transpose(2, 3)
    return [x, t, x.flip(2), t.flip(3)]


class PatchNet:
    """The Y-Net in ``cfg.compute_dtype`` on ``device`` (a frozen
    ``channels_last`` copy, as the grid's tile forward runs it) for patch
    batches of (B, H, W, 3) uint8 numpy images: the patch evaluators'
    forward."""

    def __init__(self, model: YNet, cfg: Config, device):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.compute_dtype)
        self.net = compute_copy(model, self.dtype).to(self.device)

    def _inputs(self, image_u8) -> torch.Tensor:
        x = torch.from_numpy(np.array(image_u8)).to(self.device)
        return normalize_batch_images(x, self.cfg).permute(0, 3, 1, 2)

    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype, memory_format=torch.channels_last)

    @torch.no_grad()
    def regress_tta(self, image_u8) -> torch.Tensor:
        """(B,) TTA-averaged regression of the first output."""
        preds = [self.net.regress(self._cast(v))[:, 0]
                 for v in _tta_variants(self._inputs(image_u8))]
        return sum(preds) / len(preds)

    @torch.no_grad()
    def class_logits(self, image_u8) -> torch.Tensor:
        """(B, num_classes) f32 classifier logits."""
        return self.net.classify(self._cast(self._inputs(image_u8)))


def predict_reg(model: YNet, cfg: Config, batches: Iterable[Dict],
                device="cuda", log: Callable = print) -> Dict:
    """TTA-averaged regression over patch batches (utils/eval.py:289-351):
    L1, MSE (and Pearson r) over the samples with ``is_reg``."""
    net = PatchNet(model, cfg, device)
    preds, gts = [], []
    for b in batches:
        p = net.regress_tta(b["image"]).cpu().numpy()
        sel = b["is_reg"] > 0
        preds.extend(p[sel])
        gts.extend(b["reg_label"][sel])
    rep = M.regression_report(preds, gts)
    log(f"reg: l1 {rep['l1']:.3f}, mse {rep['mse']:.3f}")
    return rep


def predict_breastpathq(model: YNet, cfg: Config, ep, dataset_path: str,
                        label_csv_path: str, out_dir: str = ".",
                        device="cuda") -> str:
    """Reads the label CSV, TTA-regresses each referenced patch (one a
    call, resized to the tile with PIL's default resample), clamps to
    [0, 1] and writes the submission CSV. Returns its path."""
    from PIL import Image
    net = PatchNet(model, cfg, device)
    rows = []
    with open(label_csv_path) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            image_id, region_id = int(row[0]), int(row[1])
            pth = os.path.join(dataset_path, f"{image_id}_{region_id}.tif")
            img = Image.open(pth).convert("RGB").resize(
                (cfg.tile_w, cfg.tile_h))
            p = float(net.regress_tta(np.asarray(img)[None])[0])
            rows.append((image_id, region_id, min(max(p, 0.0), 1.0)))
    return writers.write_breastpathq_csv(ep, rows, out_dir)


def predict_cls(model: YNet, cfg: Config, batches: Iterable[Dict],
                device="cuda", log: Callable = print) -> Dict:
    """Classification eval (utils/eval.py:415-449): accuracy, binary F1
    and the class-wise accuracy over the samples with ``is_cls``."""
    net = PatchNet(model, cfg, device)
    preds, gts = [], []
    for b in batches:
        p = torch.argmax(net.class_logits(b["image"]), -1).cpu().numpy()
        sel = b["is_cls"] > 0
        preds.extend(p[sel])
        gts.extend(b["cls_label"][sel])
    preds, gts = np.asarray(preds), np.asarray(gts)
    out = {"acc": M.accuracy(gts, preds), "f1": M.f1_score(gts, preds)}
    cm = M.confusion_matrix(gts, preds, cfg.num_classes)
    out["classwise_acc"] = M.classwise_accuracy(cm).tolist()
    log(f"cls: acc {out['acc']:.3f}, f1 {out['f1']:.3f}")
    return out
