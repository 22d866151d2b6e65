"""The multi-rank dryrun — counterpart of
``__graft_entry__.dryrun_multichip`` (checks 1–5, at its sizes).

``python -m wsiseg_tpu_torch.parallel.dryrun N [--device cuda|cpu]`` starts
N ranks (one card a rank over NCCL by default, raising when fewer cards
are visible; gloo ranks with ``--device cpu``) and runs, on a data mesh
over all of them:

1. three data-parallel hybrid train steps of a resnet18 Unet Y-Net (32²
   tiles, 2 rows a rank, f32, adam at lr 1e-4) on a mixed-task batch with
   seg rows: finite and falling losses, a nonzero seg loss, and step 1's
   metrics equal to the single-device step on the whole batch;
2. the psum and row-sharded grid routes on ``SyntheticSlide(1024, 768,
   3, seed=4)``: equal labels;
3. slide-parallel FCN serving of N slides (seeds 40 + k), one a rank:
   each equal to the single-device fused route;
4. row-striped FCN against the chunked single-device oracle at
   ``fcn_stripe_geometry`` (halo 16), for Unet and Linknet;
5. for even N ≥ 4, the first hybrid step on an (N/2, 2) (data, space)
   mesh from check 1's initial weights and batch: its loss equal to the
   data-parallel step-0 loss within ``1e-3·max(1, loss)``, JAX's limit
   (``__graft_entry__.py:127``). At 32² tiles over 2 space ranks level 5
   is gathered (``parallel/spatial.py``).

"Falling" is JAX's heuristic for three adam steps, not a property of the
math: at 2 ranks (batch 4) the seed-0 Y-Net's third step raises the loss,
as three single-device steps on the same batch do; run it at 4 ranks or
more.
"""

from __future__ import annotations

import argparse
import copy
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from wsiseg_tpu_torch.parallel import comm
from wsiseg_tpu_torch.parallel.checks import rank_mesh, spatial_mesh
from wsiseg_tpu_torch.parallel.launch import run_ranks
from wsiseg_tpu_torch.parallel.mesh import (mesh_rank, mesh_size,
                                            replicate_tree, shard_batch,
                                            shard_batch_spatial)

TILE = 32
PER_RANK = 2
#: step 1's DP metrics against the single-device step, and check 5's
#: spatial step-0 loss against the DP one, × max(1, |ref|), f32 (the JAX
#: dryrun's own limit for its spatial-vs-DP loss)
STEP1_REL = 1e-3


def _batch(b: int) -> Dict[str, np.ndarray]:
    """The JAX dryrun's mixed-task batch (``__graft_entry__.py:88-98``)."""
    rs = np.random.RandomState(0)
    return {
        "image": rs.randn(b, TILE, TILE, 3).astype(np.float32),
        "seg_label": rs.randint(0, 4, (b, TILE, TILE)).astype(np.int64),
        "cls_label": np.tile(np.array([1, -1], np.int64), b // 2),
        "reg_label": rs.rand(b).astype(np.float32),
        "is_cls": np.tile(np.array([1.0, 0.0], np.float32), b // 2),
        "is_reg": np.tile(np.array([0.0, 0.5], np.float32), b // 2),
        "is_seg": np.tile(np.array([0.0, 1.0], np.float32), b // 2),
    }


def _rank(device) -> Dict[str, object]:
    from wsiseg_tpu_torch.config import default_config
    from wsiseg_tpu_torch.data.wsi_tiles import plan_slide
    from wsiseg_tpu_torch.infer.engine import (DenseInferenceEngine,
                                               fcn_stripe_geometry)
    from wsiseg_tpu_torch.models.ynet import init_ynet
    from wsiseg_tpu_torch.optim import build_optimizer
    from wsiseg_tpu_torch.slides.reader import SyntheticSlide
    from wsiseg_tpu_torch.train.state import TrainState
    from wsiseg_tpu_torch.train.steps import make_hybrid_train_step

    dev = torch.device(device)
    # f32 as the JAX dryrun computes it (on CPU devices): no TF32 convs or
    # GEMMs on a card, whose rounding a random deep net amplifies
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = rank_mesh(dev)
    n, r = mesh_size(mesh), mesh_rank(mesh)
    b = n * PER_RANK
    cfg = default_config(tile_w=TILE, tile_h=TILE, batch_size=b,
                         compute_dtype="float32", lr=1e-4)

    # 1. three DP hybrid steps; step 1 against the single-device step
    model = init_ynet(cfg, torch.Generator().manual_seed(0)).to(dev)
    state = replicate_tree(mesh, TrainState(
        model, build_optimizer(cfg, model.parameters())))
    ref = copy.deepcopy(model)
    ref_state = TrainState(ref, build_optimizer(cfg, ref.parameters()))
    sp_model = copy.deepcopy(model)
    host = _batch(b)
    ref_m = make_hybrid_train_step(ref, cfg)(
        ref_state, {k: torch.from_numpy(v).to(dev) for k, v in host.items()})
    local = shard_batch(mesh, host)
    step = make_hybrid_train_step(model, cfg)
    steps = []
    for _ in range(3):
        with comm.data_parallel(mesh):
            steps.append({k: float(v) for k, v in step(state,
                                                       local).items()})
    step1 = max(abs(steps[0][k] - float(v)) / max(1.0, abs(float(v)))
                for k, v in ref_m.items())
    losses = [m["loss"] for m in steps]

    # 5. the spatial step 0 on an (n/2, 2) mesh against the DP step 0
    spatial_loss = None
    if n % 2 == 0 and n >= 4:
        smesh = spatial_mesh(dev, n // 2, 2)
        sstate = TrainState(sp_model, build_optimizer(
            cfg, sp_model.parameters()))
        with comm.data_parallel(smesh), comm.spatial(smesh):
            spatial_loss = float(make_hybrid_train_step(sp_model, cfg)(
                sstate, shard_batch_spatial(smesh, host))["loss"])
    del sp_model

    # 2. psum == rows on the trained weights
    icfg = cfg.replace(tile_stride_w=TILE, tile_stride_h=TILE,
                       infer_batch_size=2, wsi_mask_pth="")
    plan = plan_slide("dryrun", SyntheticSlide(width=1024, height=768,
                                               num_levels=3, seed=4), icfg)
    engine = DenseInferenceEngine(model, icfg, device=dev)
    psum = engine.predict_slide_sharded(plan, mesh)
    rows = engine.predict_slide_sharded_rows(plan, mesh)
    psum_rows = bool((psum.labels == rows.labels).all())

    # 3. slide-parallel ×n: each rank checks its own slide
    plans = [plan_slide(f"sp{k}", SyntheticSlide(
        width=1024, height=768, num_levels=3, seed=40 + k), icfg)
        for k in range(n)]
    sp = engine.predict_slides_fcn_sharded(plans, mesh)
    own = engine.predict_slide_fcn(plans[r])
    slide_bad = not ((sp[r].labels == own.labels).all()
                     and np.array_equal(sp[r].heatmap, own.heatmap))

    # 4. row-striped FCN == the chunked oracle, Unet and Linknet
    lw, lh = plan.slide.level_dimensions[icfg.scan_level]
    ch, cw = fcn_stripe_geometry(lh, lw, n)
    fcn_bad = {}
    for fam, eng in (("Unet", engine), ("Linknet", DenseInferenceEngine(
            init_ynet(icfg.replace(model_name="Linknet"),
                      torch.Generator().manual_seed(2)),
            icfg.replace(model_name="Linknet"), device=dev))):
        got = eng.predict_slide_fcn_sharded_rows(plan, mesh, halo=16)
        oracle = eng.predict_slide_fcn(plan, chunk=(ch, cw), halo=16)
        fcn_bad[fam] = not (got.labels == oracle.labels).all()
    return {
        "world": n, "losses": losses, "seg_loss": steps[-1]["loss_seg"],
        "step1_rel": step1, "spatial_loss": spatial_loss,
        "n_tiles": len(plan.grid),
        "psum_rows": psum_rows,
        "slides_equal": not comm.any_rank(slide_bad, dev, mesh),
        "fcn_rows_equal": {k: not comm.any_rank(v, dev, mesh)
                           for k, v in fcn_bad.items()},
        "stripe": (ch, cw),
    }


def dryrun_multichip(n: int, device="cuda",
                     devices: Optional[Sequence] = None) -> Dict[str, object]:
    """Checks 1–5 on ``n`` ranks (module docstring; 5 for even n ≥ 4);
    raises
    ``AssertionError`` naming the first that fails, prints one line, and
    returns rank 0's summary. ``devices`` places the ranks (two ranks on
    one card run over gloo)."""
    out = run_ranks(_rank, n, device, devices=devices,
                    threads=1 if torch.device(device).type == "cpu" else None)
    losses = out["losses"]
    sl = out["spatial_loss"]
    failed = [msg for ok, msg in (
        (all(math.isfinite(x) for x in losses), f"non-finite {losses}"),
        (losses[-1] < losses[0], f"loss did not decrease: {losses}"),
        (out["seg_loss"] > 0.0, "seg path inactive under data parallelism"),
        (out["step1_rel"] <= STEP1_REL,
         f"DP step 1 != single-device step: rel {out['step1_rel']}"),
        (out["psum_rows"], "sharded psum/rows label mismatch"),
        (out["slides_equal"], "slide-parallel result != single-device"),
        (sl is None or abs(sl - losses[0]) < STEP1_REL * max(1.0, losses[0]),
         f"spatial step-0 loss {sl} != dp {losses[0]}"),
    ) + tuple((ok, f"{fam} row-striped FCN != chunked oracle")
              for fam, ok in out["fcn_rows_equal"].items()) if not ok]
    if failed:
        raise AssertionError(f"dryrun_multichip({n}): {failed[0]}")
    print(f"dryrun_multichip({n}): 3 hybrid train steps OK (loss "
          f"{losses[0]:.4f}->{losses[-1]:.4f}, seg {out['seg_loss']:.4f}, "
          f"step 1 == single device within {out['step1_rel']:.3g}), "
          f"sharded inference psum==rows over {out['n_tiles']} tiles, "
          f"slide-parallel fcn serving x{n} == single, row-striped FCN == "
          f"chunked oracle (Unet + Linknet), " + (
              f"check 5 OK: spatial ({n // 2}x2) step-0 loss {sl:.6f} == "
              f"DP {losses[0]:.6f}" if sl is not None else
              "check 5 (spatial) skipped: it needs an even world of 4 or "
              "more"))
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    p = argparse.ArgumentParser(
        prog="python -m wsiseg_tpu_torch.parallel.dryrun",
        description="the multi-rank dryrun (checks 1-5 of "
                    "__graft_entry__.dryrun_multichip)")
    p.add_argument("n", type=int, help="ranks")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="one card a rank (default; raises when fewer are "
                        "visible), or gloo ranks on the CPU")
    ns = p.parse_args(argv)
    return dryrun_multichip(ns.n, ns.device)


if __name__ == "__main__":
    main()
