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
derives threefry keys on the host for the same purpose.) A step's ranges
(``torch.profiler.record_function``): ``train.prepare`` (its generator,
the batch transform, the stripe) and ``train.step`` (``step_fn``); an
epoch's: ``train.fetch`` (the metric sums to the host).

With a ``mesh`` (JAX ``Trainer(mesh=...)``, ``loop.py:101-133``) the
training is data-parallel over its ranks, every rank running this loop:
rank 0's state is broadcast, each rank's host batches hold only its rows
of every global batch (``make_batches(rows=...)``; the rows of
``parallel.mesh.batch_rows``, in microbatch order under ``grad_accum``),
each rank draws the global batch's jitter to take its rows' factors, and
every step runs inside ``comm.data_parallel`` (global BatchNorm
statistics and losses, all-reduced gradients). Rank 0 logs, validates
and saves the checkpoints.

On a (data, space) mesh (JAX's ``space`` branch, ``loop.py:108-121``) the
rows come by data coordinate and the ranks of one data row decode and
jitter the same whole tiles; each then keeps its stripe
(``parallel.mesh.take_stripe``: the jitter's contrast step takes each
whole image's mean, so it runs before the split), and the step runs
inside ``comm.spatial`` as well. BatchNorm, the losses, the metrics and
the gradients reduce over all the mesh's ranks; the batch size divides
over the data axis only.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from wsiseg_tpu_torch.config import Config
from wsiseg_tpu_torch.data.pipeline import prefetch_to_device
from wsiseg_tpu_torch.parallel import comm
from wsiseg_tpu_torch.parallel.mesh import take_stripe
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
                 log_fn: Callable[[str], None] = print,
                 mesh=None):
        """
        Args:
          step_fn: (state, batch, generator) -> metrics dict of 0-dim
            device tensors; updates ``state`` in place.
          make_batches: a fresh iterator of host batches (dicts of numpy
            arrays) per epoch. With a ``mesh`` it is called as
            ``make_batches(rows=fn)`` and yields only this rank's rows of
            each global batch: ``fn(b)``, the indices of a b-row batch
            that this rank keeps (the datasets' ``batches(rows=...)``).
          preprocess_batch: optional device-side batch transform
            fn(batch, generator, rows) (u8 → normalized float with the
            train jitter; ``rows`` as ``cli.common.make_preprocess``
            takes it, None on a single device).
          validate_fn: fn(state, epoch) -> dict of metrics; the model is
            put back in train mode after it.
          mesh: optional ``DeviceMesh`` (``parallel.mesh.make_mesh``):
            data-parallel training over its first dim, with the
            single-device step's math at the same global batch.
        """
        self.cfg = cfg
        self.state = state
        self.step_fn = step_fn
        self.make_batches = make_batches
        self.preprocess_batch = preprocess_batch
        self.validate_fn = validate_fn
        self.log = log_fn
        self.mesh = mesh
        self.device = next(state.model.parameters()).device
        self.history: list[dict] = []

    def _data_parallel(self):
        """(batches, rows_of, lead): a fresh epoch of host batches (this
        rank's rows), the (n, index) of a local batch for the jitter, and
        whether this rank logs, validates and saves (single device: every
        row, None, True)."""
        if self.mesh is None:
            return self.make_batches, (lambda n_local: None), True
        from wsiseg_tpu_torch.parallel.mesh import (batch_rows, is_lead,
                                                    mesh_size,
                                                    replicate_tree,
                                                    space_size)
        cfg, mesh = self.cfg, self.mesh
        n = mesh_size(mesh)
        m = space_size(mesh)
        if cfg.batch_size % n:
            raise ValueError(
                f"global batch_size {cfg.batch_size} must divide evenly "
                + (f"over {n} mesh devices" if m == 1 else
                   f"over the {n}-way data axis"))
        replicate_tree(mesh, self.state)
        ga = cfg.grad_accum

        def batches():
            return self.make_batches(rows=lambda b: batch_rows(
                mesh, b, microbatches=ga))

        cache = {}

        def rows_of(n_local):
            if n_local not in cache:
                cache[n_local] = (n_local * n, torch.as_tensor(
                    batch_rows(mesh, n_local * n, microbatches=ga),
                    device=self.device))
            return cache[n_local]

        lead = is_lead(mesh)
        if lead and m > 1:
            shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
            self.log(f"data×spatial training over {shape} "
                     f"({cfg.batch_size // n} per data shard)")
        elif lead:
            self.log(f"data-parallel training over {n} ranks "
                     f"({cfg.batch_size // n} per rank)")
        return batches, rows_of, lead

    def run(self, start_epoch: Optional[int] = None,
            num_epochs: Optional[int] = None) -> TrainState:
        cfg = self.cfg
        start = start_epoch if start_epoch is not None else cfg.start_epoch
        end = start + (num_epochs if num_epochs is not None
                       else cfg.num_epoch - start + 1)
        batches, rows_of, lead = self._data_parallel()
        n_rank = 1 if self.mesh is None else self.mesh.size(0)
        for epoch in range(start, end):
            t0 = time.perf_counter()
            sums: Dict[str, torch.Tensor] = {}
            count = n_samples = 0
            for i, batch in enumerate(prefetch_to_device(
                    batches(), depth=cfg.prefetch_depth,
                    device=self.device)):
                with record_function("train.prepare"):
                    gen = step_generator(cfg.seed, epoch, i, self.device)
                    n_local = int(next(iter(batch.values())).shape[0])
                    if self.preprocess_batch is not None:
                        batch = self.preprocess_batch(batch, gen,
                                                      rows=rows_of(n_local))
                    if self.mesh is not None:
                        batch = take_stripe(self.mesh, batch)
                n_samples += n_local * n_rank
                with comm.data_parallel(self.mesh), comm.spatial(self.mesh):
                    with record_function("train.step"):
                        metrics = self.step_fn(self.state, batch, gen)
                count += 1
                for k, v in metrics.items():
                    sums[k] = v if k not in sums else sums[k] + v
            # one fetch drains the device queue, so dt covers the compute
            keys = sorted(sums)
            with record_function("train.fetch"):
                vals = (torch.stack([sums[k].float() for k in keys]).cpu()
                        .tolist() if keys else [])
            avg = {k: v / max(count, 1) for k, v in zip(keys, vals)}
            dt = time.perf_counter() - t0
            rate = n_samples / dt if dt > 0 else 0.0
            if lead:
                self.log(f"Epoch {epoch}: " +
                         ", ".join(f"{k} {v:.4f}" for k, v in avg.items())
                         + f", {rate:.1f} patches/s")
            rec = {"epoch": epoch, **avg, "patches_per_sec": rate}

            if (lead and self.validate_fn is not None
                    and cfg.validate_model > 0
                    and epoch % cfg.validate_model == 0):
                val = self.validate_fn(self.state, epoch) or {}
                self.state.model.train()
                rec.update({f"val_{k}": v for k, v in val.items()})
                if val:
                    self.log("  val: " + ", ".join(
                        f"{k} {v:.4f}" for k, v in sorted(val.items())))

            if lead and cfg.save_models > 0 and epoch % cfg.save_models == 0:
                rec["checkpoint"] = save_train_state(self.state, cfg, epoch)
            self.history.append(rec)
        return self.state
