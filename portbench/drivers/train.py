"""Training epochs over the device epoch cache: the ``train
--device_cache`` path.

Set-up makes an in-memory set of u8 patches with hybrid labels from the
seed (crops of synthetic slides; each row a segmentation map, a class or
a regression value, in the traffic's mix), the weights, the program's
Y-Net and Adam (``TrainState``), the ``DeviceEpochCache`` and the cached
hybrid step, wired to ``train.loop.Trainer`` as the ``train`` command
wires them. It then runs the first epoch: its first steps are the ones
the reference follows (the first step's forward output and the
parameters after them are kept), the rest warm up. The window
runs whole epochs back to back until ``--seconds`` have passed; each
ends when the trainer fetches its metrics (a synchronize).
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict

import numpy as np
import torch

from portbench.harness import slides as slide_gen
from portbench.harness.weights import make_state
from portbench.reference import lowp
from portbench.reference import train as ref_train
from portbench.reference.infer import model_from_state
from portbench.reference.ynet import build as build_reference


def class_weights(counts: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Inverse-frequency class weights scaled to a largest of 1, 0 for an
    absent class (the reference's ``utils/preprocessing.py`` rule)."""
    out = np.zeros(len(counts), np.float64)
    nz = np.nonzero(counts)[0]
    if len(nz):
        r = 1.0 / (counts[nz] / (eps + counts.sum()))
        out[nz] = r / (eps + r.max())
    return out


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.t = cell.traffic
        self.cfg_json = cell.config
        self.dev = cell.device

    # ---- data ----

    def _data(self, gen: torch.Generator) -> Dict[str, np.ndarray]:
        """The patch set: crops of synthetic slides, tasks in the traffic's
        mix, drawn from the seed."""
        t = self.t
        tile, n = t["tile"], t["patches"]
        ch, cw = t["slide_hw"]
        per = (ch // tile) * (cw // tile)
        slides = slide_gen.level2_images(-(-n // per), ch, cw, gen,
                                         labels=True)
        img = np.empty((n, tile, tile, 3), np.uint8)
        seg = np.empty((n, tile, tile), np.uint8)
        for i in range(n):
            s, k = divmod(i, per)
            y, x = divmod(k, cw // tile)
            im, lab = slides[s]
            img[i] = im[y * tile:(y + 1) * tile, x * tile:(x + 1) * tile]
            seg[i] = lab[y * tile:(y + 1) * tile, x * tile:(x + 1) * tile]
        mix = t["task_mix"]
        tasks = np.repeat(np.arange(3), [mix["seg"], mix["cls"], mix["reg"]])
        u = torch.rand((n, 3), generator=gen, device=gen.device,
                       dtype=torch.float64).cpu().numpy()
        task = tasks[(u[:, 0] * len(tasks)).astype(np.int64)]
        nc = self.cfg_json["num_classes"]
        is_seg, is_cls, is_reg = (task == 0), (task == 1), (task == 2)
        seg[~is_seg] = 0
        return {"image": img, "seg_label": seg,
                "cls_label": np.where(is_cls, (u[:, 1] * nc).astype(np.int32),
                                      -1).astype(np.int32),
                "reg_label": np.where(is_reg, u[:, 2], 0).astype(np.float32),
                "is_cls": is_cls.astype(np.float32),
                "is_reg": is_reg.astype(np.float32),
                "is_seg": is_seg.astype(np.float32)}

    # ---- set-up ----

    def setup(self) -> None:
        from wsiseg_tpu_torch.config import default_config
        from wsiseg_tpu_torch.models.ynet import YNet
        from wsiseg_tpu_torch.optim import build_optimizer
        from wsiseg_tpu_torch.train.device_cache import (
            DeviceEpochCache, make_cached_hybrid_train_step)
        from wsiseg_tpu_torch.train.loop import Trainer
        from wsiseg_tpu_torch.train.state import TrainState

        c, t = self.cfg_json, self.t
        self.cfg = default_config(
            model_name=c["model_name"], arch_encoder=c["arch_encoder"],
            num_classes=c["num_classes"],
            class_probs=tuple(c["class_probs"]),
            dataset_mean=tuple(c["dataset_mean"]),
            dataset_std=tuple(c["dataset_std"]),
            compute_dtype=c["compute_dtype"], param_dtype=c["param_dtype"],
            tile_w=t["tile"], tile_h=t["tile"], batch_size=t["batch_size"],
            optim="adam", lr=t["lr"], weight_decay=t["weight_decay"],
            beta1=t["beta1"], beta2=t["beta2"], device_cache=True,
            save_models=0, validate_model=0, raw_val_pth="",
            wsi_mask_pth="", seed=self.cell.seed)
        gen = torch.Generator(device=self.dev).manual_seed(self.cell.seed)
        with torch.device("meta"):
            skeleton = build_reference(c)
        self.state0 = make_state(skeleton, gen, c.get("init_scale"))
        self.data = self._data(gen)
        nc = c["num_classes"]
        rows = self.data["is_cls"] > 0
        self.cls_w = class_weights(np.bincount(
            self.data["cls_label"][rows], minlength=nc)[:nc])
        seg_rows = self.data["is_seg"] > 0
        self.seg_w = class_weights(np.bincount(
            self.data["seg_label"][seg_rows].reshape(-1).astype(np.int64),
            minlength=nc)[:nc])

        with torch.device("meta"):
            model = YNet(c["arch_encoder"], nc, 1, c["model_name"])
        model = model.to_empty(device=self.dev)
        model.load_state_dict(self.state0)
        model = model.to(self.dev, getattr(torch, c["param_dtype"]))
        if self.dev.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        state = TrainState(model, build_optimizer(self.cfg,
                                                  model.parameters()))
        b = t["batch_size"]
        cache = DeviceEpochCache.build(
            ({k: v[i:i + b] for k, v in self.data.items()}
             for i in range(0, t["patches"], b)), self.cfg, self.dev,
            max_bytes=int(self.cfg.device_cache_gb * 1e9))
        cstep = make_cached_hybrid_train_step(model, self.cfg,
                                              cls_weights=self.cls_w,
                                              seg_weights=self.seg_w)
        self.first: Dict = {}
        self.start = {n: p.detach().float().clone()
                      for n, p in model.named_parameters()}
        k = t["checked_steps"]

        def step(st, batch, g):
            hook = (st.model.register_forward_hook(self._keep_output)
                    if self.steps_run == 0 else None)
            out = cstep(st, cache.arrays, batch["idx"], g)
            if hook is not None:
                hook.remove()
            self.steps_run += 1
            if self.steps_run == k:
                self.first["params"] = {
                    n: p.detach().float().clone()
                    for n, p in st.model.named_parameters()}
            return out

        epochs = iter(range(10 ** 9))

        def make_batches():
            ep = next(epochs)
            return ({"idx": ix} for ix in cache.index_batches(
                self.cfg.batch_size, seed=self.cfg.seed, epoch=ep))

        self.steps_run = 0
        self.trainer = Trainer(self.cfg, state, step,
                               make_batches=make_batches,
                               preprocess_batch=None, validate_fn=None,
                               log_fn=lambda s: None)
        self.epoch = 1
        self._epoch()
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def _keep_output(self, _module, _args, out) -> None:
        """The first step's forward output, as the program's step made
        it."""
        self.first["out"] = {k: v.detach().clone() for k, v in out.items()}

    def _epoch(self) -> None:
        self.trainer.run(start_epoch=self.epoch, num_epochs=1)
        self.epoch += 1

    # ---- the window ----

    def window(self, seconds: float) -> Dict:
        s0 = self.steps_run
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._epoch()
        wall = time.perf_counter() - t0
        steps = self.steps_run - s0
        patches = steps * self.t["batch_size"]
        return {"e2e": {"train_patches_per_s": patches / wall},
                "attempted": steps, "failed": 0, "steps": steps,
                "patches": patches, "wall_s": wall}

    # ---- after the window ----

    def release(self) -> None:
        self.trainer = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _reference_inputs(self):
        """The rows and jitter generators of the first steps, and the
        class weights, as the reference takes them."""
        k, b = self.t["checked_steps"], self.t["batch_size"]
        order = ref_train.epoch_order(self.cfg.seed, 0,
                                      len(self.data["image"]))
        batches, gens = [], []
        for i in range(k):
            idx = order[i * b:(i + 1) * b]
            batches.append({key: torch.from_numpy(v[idx]).to(self.dev)
                            for key, v in self.data.items()})
            gens.append(ref_train.step_generator(self.cfg.seed, 1, i,
                                                 self.dev))
        cls_w = torch.tensor(self.cls_w, dtype=torch.float32, device=self.dev)
        seg_w = torch.tensor(self.seg_w, dtype=torch.float32, device=self.dev)
        return batches, gens, cls_w, seg_w

    def reference_steps(self, control: bool = False) -> Dict:
        """The reference's first steps on the same rows, jitter and
        weights (``control``: computed from fp8 operands and
        gradients)."""
        batches, gens, cls_w, seg_w = self._reference_inputs()
        model = model_from_state(self.cfg_json, self.state0, self.dev)
        with lowp.fp8(model) if control else contextlib.nullcontext():
            return ref_train.run_steps(model, batches, gens, self.cfg_json,
                                       self.t, cls_w, seg_w)

    def program_steps(self) -> Dict:
        """The program's first steps; its first forward output's loss row
        by row is taken by the reference's rule on the reference's rows."""
        batches, _, cls_w, seg_w = self._reference_inputs()
        out = self.first["out"]
        n = min(out["seg"].shape[0], batches[0]["image"].shape[0])
        rows = ref_train.row_losses({k: v[:n] for k, v in out.items()},
                                    {k: v[:n] for k, v in batches[0].items()},
                                    cls_w, seg_w)
        return {"rows": rows, "params": self.first["params"]}

    def readings(self) -> Dict[str, float]:
        return ref_train.gaps(self.program_steps(), self.reference_steps(),
                              self.start)

    def control_readings(self) -> Dict[str, float]:
        return ref_train.gaps(self.reference_steps(control=True),
                              self.reference_steps(), self.start)
