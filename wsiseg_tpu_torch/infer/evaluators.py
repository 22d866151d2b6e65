"""High-level evaluators — counterpart of ``wsiseg_tpu/infer/evaluators.py``:
:func:`predict_tumorbed` over the FCN branch of :func:`_pipelined_results`.
``predict_wsis``, the regression/cls evaluators and the grid, sharded and
streamed branches are still to be ported (ROADMAP.md, queue 1)."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict

from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection
from wsiseg_tpu_torch.infer import writers
from wsiseg_tpu_torch.infer.engine import ROUTES_ITEM, DenseInferenceEngine


def _pipelined_results(engine: DenseInferenceEngine,
                       collection: SlideCollection, fcn: bool = True,
                       mesh=None, streamed: bool = False):
    """Iterate (name, plan, result). Groups of up to
    ``engine.slides_in_flight`` consecutive same-geometry slides run as
    one batched forward (``predict_slides_fcn``); one-ahead staging on a
    worker thread overlaps the next group's host read and upload with the
    current group's compute."""
    if not fcn or mesh is not None or streamed:
        raise NotImplementedError(
            f"grid/sharded/streamed evaluation is {ROUTES_ITEM}")
    items = list(collection.items())
    n_flight = max(1, int(engine.slides_in_flight))
    groups, cur, cur_key = [], [], None
    for it in items:
        key = engine._fcn_fast_dims(*it[1].stitch_hw)
        if cur and (len(cur) == n_flight or key != cur_key):
            groups.append(cur)
            cur = []
        cur_key = key
        cur.append(it)
    if cur:
        groups.append(cur)

    def stage_group(g):
        return [engine.stage_slide_fcn(p) for _, p in g]

    with ThreadPoolExecutor(max_workers=1) as pool:
        staged = pool.submit(stage_group, groups[0]) if groups else None
        for gi, g in enumerate(groups):
            nxt = (pool.submit(stage_group, groups[gi + 1])
                   if gi + 1 < len(groups) else None)
            res_list = engine.predict_slides_fcn([p for _, p in g],
                                                 imgs=staged.result())
            staged = nxt
            for (name, plan), res in zip(g, res_list):
                yield name, plan, res


def predict_tumorbed(engine: DenseInferenceEngine,
                     collection: SlideCollection, ep, fcn: bool = True,
                     mesh=None, streamed: bool = False,
                     log: Callable = print) -> Dict:
    """Heatmap + overlay artifacts per slide."""
    cfg = engine.cfg
    results = {}
    for name, plan, res in _pipelined_results(engine, collection, fcn,
                                               mesh=mesh, streamed=streamed):
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
