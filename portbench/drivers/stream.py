"""Slide folders through the program's evaluator, closed loop.

Set-up makes a pool of level-2 slide images and the weights from the
seed, writes each slide's tissue mask where planning looks for it
(``mask_cache_dir``, as a folder re-evaluated with each checkpoint has
them), builds the program's engine (``DenseInferenceEngine``, the fused
FCN route) and runs one whole folder to warm every shape. The window
then evaluates folders back to back through
``infer.evaluators._pipelined_results(engine, folder, fcn=True)``, the
generator every slide evaluator of the program iterates; a slide is done
when its labels and heat are on the host. With ``replan`` each folder is
a new ``SlideCollection`` (planning: the level-2 read, the cached mask,
the tile grid); without it the collection planned in set-up is served
again, as the trainer's per-epoch validation keeps its collection.

The window ends at the first folder done after ``--seconds``, so the
rate is taken over whole folders, planning and serving alike. A sample
of the slides done, drawn from the seed, is judged against the plain
reference once the window has closed.
"""

from __future__ import annotations

import gc
import os
import random
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import slides as slide_gen
from portbench.harness.weights import make_state
from portbench.reference import lowp, postprocess
from portbench.reference.infer import model_from_state, slide_probs
from portbench.reference.ynet import build as build_reference


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.t = cell.traffic
        self.cfg_json = cell.config
        self.dev = cell.device

    # ---- set-up ----

    def setup(self) -> None:
        from wsiseg_tpu_torch.config import default_config
        from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
        from wsiseg_tpu_torch.models.ynet import YNet
        from wsiseg_tpu_torch.slides import VirtualPyramidSlide

        c, t = self.cfg_json, self.t
        self.cfg = default_config(
            model_name=c["model_name"], arch_encoder=c["arch_encoder"],
            num_classes=c["num_classes"],
            class_probs=tuple(c["class_probs"]),
            dataset_mean=tuple(c["dataset_mean"]),
            dataset_std=tuple(c["dataset_std"]),
            compute_dtype=c["compute_dtype"], param_dtype=c["param_dtype"],
            tile_w=t["tile"], tile_h=t["tile"], tile_stride_w=t["stride"],
            tile_stride_h=t["stride"], wsi_mask_pth="")
        gen = torch.Generator(device=self.dev).manual_seed(self.cell.seed)
        with torch.device("meta"):
            skeleton = build_reference(c)
        self.state = make_state(skeleton, gen, c.get("init_scale"))
        with torch.device("meta"):
            model = YNet(c["arch_encoder"], c["num_classes"], 1,
                         c["model_name"])
        model = model.to_empty(device=self.dev)
        model.load_state_dict(self.state)
        self.engine = DenseInferenceEngine(
            model, self.cfg, device=self.dev,
            dtype=getattr(torch, c["compute_dtype"]))
        self.engine.slides_in_flight = t["slides_in_flight"]

        h, w = t["level2_hw"]
        self.images = slide_gen.level2_images(t["pool_slides"], h, w, gen)
        names = [f"slide{k:02d}" for k in range(len(self.images))]
        order = [k % len(names) for k in range(t["folder_slides"])]
        self.folder = [(names[k], VirtualPyramidSlide({2: self.images[k]},
                                                      num_levels=3))
                       for k in order]
        self.index = {n: k for k, n in enumerate(names)}
        from PIL import Image
        self.mask_dir = os.path.join(self.cell.workdir, "masks")
        os.makedirs(self.mask_dir, exist_ok=True)
        for n, img in zip(names, self.images):
            Image.fromarray(slide_gen.tissue_mask(img)).save(
                os.path.join(self.mask_dir, f"{n}.png"))
        self.rng = random.Random(self.cell.seed)
        self.planned = None
        self._pass()

    def _collection(self):
        """The folder to evaluate: planned anew (``replan``), or the one
        collection planned in set-up, as the trainer's per-epoch
        validation keeps it."""
        from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection
        if self.t["replan"] or self.planned is None:
            self.planned = SlideCollection(self.folder, self.cfg,
                                           mask_cache_dir=self.mask_dir)
        return self.planned

    def _pass(self) -> None:
        """One folder through the evaluator, outside the window."""
        from wsiseg_tpu_torch.infer.evaluators import _pipelined_results
        for _ in _pipelined_results(self.engine, self._collection(),
                                    fcn=True):
            pass
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    # ---- the window ----

    def window(self, seconds: float) -> Dict:
        from wsiseg_tpu_torch.infer.evaluators import _pipelined_results
        from wsiseg_tpu_torch.ops import stem

        self.kept: List = []          # the reservoir: (slide, output)
        self.seen = 0
        launches0 = stem.LAUNCHES
        n = folder = 0
        t0 = time.perf_counter()
        while folder == 0 or time.perf_counter() - t0 < seconds:
            for name, _, res in _pipelined_results(
                    self.engine, self._collection(), fcn=True):
                n += 1
                self._offer(name, res)
            folder += 1
        wall = time.perf_counter() - t0
        return {"e2e": {"slide_s": wall / n}, "attempted": n, "failed": 0,
                "slides": n,
                "folders": folder, "k1_launches": stem.LAUNCHES - launches0,
                "wall_s": wall}

    def _offer(self, name: str, output) -> None:
        """Reservoir sampling of the slides done, from the seed."""
        k = self.t["check_slides"]
        self.seen += 1
        if len(self.kept) < k:
            self.kept.append((name, output))
            return
        j = self.rng.randrange(self.seen)
        if j < k:
            self.kept[j] = (name, output)

    # ---- after the window ----

    def release(self) -> None:
        self.engine = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _sampled(self) -> Dict[int, list]:
        """The sampled outputs by pool slide: [(labels, heat u8)]."""
        by_slide: Dict[int, list] = {}
        for name, res in self.kept:
            heat = np.rint(res.heatmap * 255.0).astype(np.uint8)
            by_slide.setdefault(self.index[name], []).append(
                (res.labels, heat))
        return by_slide

    def _mask(self, k: int) -> torch.Tensor:
        return torch.from_numpy(
            slide_gen.tissue_mask(self.images[k])).to(self.dev)

    def readings(self) -> Dict[str, float]:
        """The sampled outputs judged against the reference, one slide's
        reference forward at a time."""
        model = model_from_state(self.cfg_json, self.state, self.dev)
        found = []
        for k, outs in sorted(self._sampled().items()):
            probs = slide_probs(model, self.cfg_json, self.images[k], self.dev)
            mask = self._mask(k)
            found += [postprocess.judge(probs, mask, labels, heat)
                      for labels, heat in outs]
            del probs
        return postprocess.worst(found)

    def control_readings(self) -> Dict[str, float]:
        """The control in the program's place: the reference computed
        from fp8 operands, its labels and heat judged as the program's
        are, on the same sampled slides."""
        model = model_from_state(self.cfg_json, self.state, self.dev)
        found = []
        for k in sorted(self._sampled()):
            mask = self._mask(k)
            with lowp.fp8(model):
                low = slide_probs(model, self.cfg_json, self.images[k],
                                  self.dev)
            labels, heat = postprocess.labels_heat(low, mask)
            del low
            probs = slide_probs(model, self.cfg_json, self.images[k],
                                self.dev)
            found.append(postprocess.judge(probs, mask, labels.cpu().numpy(),
                                           heat.cpu().numpy()))
            del probs
        return postprocess.worst(found)
