"""Epoch-driven training loop shared by the trainer CLIs — counterpart of
``wsiseg_tpu/train/loop.py``.

One skeleton for the reference's trainers: epoch loop over host batches →
device step → running metrics → periodic validation and checkpointing
(the ``validate_model`` / ``save_models`` cadence, myargs.py:73-78).

The metric sums stay on the device during the epoch and are fetched once
at its end, so no step waits for the device (``loop.py:146-171``). Each
step gets its own ``torch.Generator`` on the device, seeded from (seed,
epoch, step), for the jitter of its batch: deterministic per step,
independent of the global RNG. (The JAX package's ``host_step_keys``
derives threefry keys on the host for the same purpose.)
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.data.pipeline import prefetch_to_device
from wsiseg_tpu_torch.train.state import TrainState, save_train_state


def step_generator(seed: int, epoch: int, step: int,
                   device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, epoch, step) through
    numpy's ``SeedSequence``."""
    s = np.random.SeedSequence([seed, epoch, step]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s) >> 1)


class Trainer:
    def __init__(self, cfg: Config, state: TrainState, step_fn: Callable,
                 make_batches: Callable[[], Iterable[Dict]],
                 preprocess_batch: Optional[Callable] = None,
                 validate_fn: Optional[Callable] = None,
                 log_fn: Callable[[str], None] = print):
        """
        Args:
          step_fn: (state, batch, generator) -> metrics dict of 0-dim
            device tensors; updates ``state`` in place.
          make_batches: a fresh iterator of host batches (dicts of numpy
            arrays) per epoch.
          preprocess_batch: optional device-side batch transform
            fn(batch, generator) (u8 → normalized float with the train
            jitter).
          validate_fn: fn(state, epoch) -> dict of metrics; the model is
            put back in train mode after it.
        """
        self.cfg = cfg
        self.state = state
        self.step_fn = step_fn
        self.make_batches = make_batches
        self.preprocess_batch = preprocess_batch
        self.validate_fn = validate_fn
        self.log = log_fn
        self.device = next(state.model.parameters()).device
        self.history: list[dict] = []

    def run(self, start_epoch: Optional[int] = None,
            num_epochs: Optional[int] = None) -> TrainState:
        cfg = self.cfg
        start = start_epoch if start_epoch is not None else cfg.start_epoch
        end = start + (num_epochs if num_epochs is not None
                       else cfg.num_epoch - start + 1)
        for epoch in range(start, end):
            t0 = time.time()
            sums: Dict[str, torch.Tensor] = {}
            count = n_samples = 0
            for i, batch in enumerate(prefetch_to_device(
                    self.make_batches(), depth=cfg.prefetch_depth,
                    device=self.device)):
                gen = step_generator(cfg.seed, epoch, i, self.device)
                if self.preprocess_batch is not None:
                    batch = self.preprocess_batch(batch, gen)
                n_samples += int(next(iter(batch.values())).shape[0])
                metrics = self.step_fn(self.state, batch, gen)
                count += 1
                for k, v in metrics.items():
                    sums[k] = v if k not in sums else sums[k] + v
            # one fetch drains the device queue, so dt covers the compute
            keys = sorted(sums)
            vals = (torch.stack([sums[k].float() for k in keys]).cpu()
                    .tolist() if keys else [])
            avg = {k: v / max(count, 1) for k, v in zip(keys, vals)}
            dt = time.time() - t0
            rate = n_samples / dt if dt > 0 else 0.0
            self.log(f"Epoch {epoch}: " +
                     ", ".join(f"{k} {v:.4f}" for k, v in avg.items()) +
                     f", {rate:.1f} patches/s")
            rec = {"epoch": epoch, **avg, "patches_per_sec": rate}

            if (self.validate_fn is not None and cfg.validate_model > 0
                    and epoch % cfg.validate_model == 0):
                val = self.validate_fn(self.state, epoch) or {}
                self.state.model.train()
                rec.update({f"val_{k}": v for k, v in val.items()})
                if val:
                    self.log("  val: " + ", ".join(
                        f"{k} {v:.4f}" for k, v in sorted(val.items())))

            if cfg.save_models > 0 and epoch % cfg.save_models == 0:
                rec["checkpoint"] = save_train_state(self.state, cfg, epoch)
            self.history.append(rec)
        return self.state
