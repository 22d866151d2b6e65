"""High-level evaluators — counterpart of ``wsiseg_tpu/infer/evaluators.py``:
:func:`predict_tumorbed` over every single-device branch of
:func:`_pipelined_results` (grid, streamed, FCN). ``predict_wsis`` and the
regression/cls evaluators are still to be ported (ROADMAP.md, queue 1,
"the other eval CLIs"); the mesh branches wait for "Multi-GPU"."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict

from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection
from wsiseg_tpu_torch.infer import writers
from wsiseg_tpu_torch.infer.engine import MULTI_GPU_ITEM, \
    DenseInferenceEngine


def _pipelined_results(engine: DenseInferenceEngine,
                       collection: SlideCollection, fcn: bool = False,
                       mesh=None, streamed: bool = False):
    """Iterate (name, plan, result) (JAX ``evaluators.py:56-172``).

    - ``streamed``: each slide's tile batches decoded on the host and
      prefetched (``predict_slide_streamed``).
    - ``fcn``: groups of up to ``engine.slides_in_flight`` consecutive
      slides that share the padded geometry and fit the fused planar
      route run as one batched forward (``predict_slides_fcn``); any other
      slide is a group of its own. One-ahead staging on a worker thread
      overlaps the next group's host read and upload with this group's
      compute; slides over ``fcn_fast_max_px`` are not staged (they take
      the banded route, one band at a time). Off the fused route (cls
      mode, ``scan_resize`` ≠ 1) nothing is staged.
    - otherwise the grid: slide k+1's level image is staged
      (``stage_slide``) while slide k computes.

    ``mesh`` raises: the sharded routes are not ported."""
    if streamed and fcn:
        raise ValueError("fcn and streamed are mutually exclusive")
    if mesh is not None:
        raise NotImplementedError(f"mesh evaluation is {MULTI_GPU_ITEM}")
    items = list(collection.items())
    if streamed:
        for name, plan in items:
            yield name, plan, engine.predict_slide_streamed(plan)
        return
    if fcn:
        if not engine._fcn_fast_ok():
            for name, plan in items:
                yield name, plan, engine.predict_slide_fcn(plan)
            return
        n_flight = max(1, int(engine.slides_in_flight))
        groups, cur, cur_key = [], [], None
        for it in items:
            plan = it[1]
            key = (engine._fcn_planar_ok(plan)
                   and engine._fcn_fast_fits(plan),
                   engine._fcn_fast_dims(*plan.stitch_hw))
            if cur and (len(cur) == n_flight or key != cur_key
                        or not key[0]):
                groups.append(cur)
                cur = []
            cur_key = key
            cur.append(it)
        if cur:
            groups.append(cur)

        def stage_group(g):
            return [engine.stage_slide_fcn(p)
                    if engine._fcn_fast_fits(p) else None for _, p in g]

        with ThreadPoolExecutor(max_workers=1) as pool:
            staged = pool.submit(stage_group, groups[0]) if groups else None
            for gi, g in enumerate(groups):
                nxt = (pool.submit(stage_group, groups[gi + 1])
                       if gi + 1 < len(groups) else None)
                imgs = staged.result()
                if len(g) == 1:
                    res_list = [engine.predict_slide_fcn(g[0][1],
                                                         img=imgs[0])]
                else:
                    res_list = engine.predict_slides_fcn(
                        [p for _, p in g], imgs=imgs)
                staged = nxt
                for (name, plan), res in zip(g, res_list):
                    yield name, plan, res
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


def predict_tumorbed(engine: DenseInferenceEngine,
                     collection: SlideCollection, ep, fcn: bool = False,
                     mesh=None, streamed: bool = False,
                     log: Callable = print) -> Dict:
    """Heatmap + overlay artifacts per slide (reference
    utils/eval.py:155-286). The grid is the default, as in JAX; the CLI
    defaults to FCN (``parse_eval_flags``)."""
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
