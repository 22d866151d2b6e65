"""Data-parallel training epochs over each rank's device cache: the
``train --mesh N --device_cache`` path, one card a rank over NCCL.

Rank 0 runs in the run's own process on card 0, so that the run's trace,
spans, peak memory and JAX check see it; ranks 1 to N−1 are spawned
(never forked), one card each (``--tiny``: N gloo ranks on the CPU).
Every rank makes the same patch set and weights from the seed
(:mod:`portbench.drivers.train`'s data, :mod:`portbench.harness.training`'s
weights and build) before it joins the group, so that rank 0's data
overlaps the other ranks' start, caches its rows of every host batch
(``train.device_cache.cached_training`` with ``cache_rows``, as the
``train`` command wires it under a mesh) and runs
``train.loop.Trainer`` over the data mesh: BatchNorm's moments and the
gradients all-reduced, every step. Rank 0 leads: before each epoch, and
before the end, it broadcasts what every rank does next. When rank 0
fails in set-up, the window or the release, it ends the other ranks
before the error propagates, so a failed run ends at once and not at
the collectives' timeout.

Set-up runs the first epoch, whose first steps the reference follows:
each rank's first-step loss row by row (the reference's rule on the
reference's rows) is gathered to rank 0 in ``batch_rows`` order, and rank
0 keeps the parameters after the checked steps. The window runs whole
epochs back to back until ``--seconds`` have passed; each ends when the
trainer fetches its metrics (a synchronize). Patches count the global
batch. After the window every rank compares its parameters with rank
0's (``replica_gap``).

The reference is the single-device float32 step over the whole global
batch: batch i of the first epoch holds, for each rank r in order, rank
r's i-th local batch of its cached rows (local row j of rank r is row
k·B + r·B/N + j mod B/N of the patch set, k = j div B/N; each epoch every
rank shuffles its rows with the epoch's permutation), with the jitter of
the global batch's generator.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from portbench.drivers import train as single
from portbench.harness import training
from portbench.reference import train as ref_train

#: commands rank 0 broadcasts
STOP, EPOCH, REPLICA = 0, 1, 2
#: how long a rank waits in a collective: more than a rank's data and
#: build, an epoch, or the traced window's collection on rank 0
TIMEOUT = datetime.timedelta(minutes=3)


def _devices(cell, world: int):
    if cell.tiny:
        return [torch.device("cpu")] * world
    return [torch.device("cuda", r) for r in range(world)]


def _claim(dev: torch.device, world: int) -> None:
    """This process's card, or its share of the CPU's threads."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))


def _join(cell, rank: int, world: int, dev: torch.device) -> None:
    """This process as ``rank`` of the run's group (a file store in the
    run's work directory): NCCL on cards, gloo on the CPU."""
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method="file://" + os.path.join(cell.workdir, "group"),
        rank=rank, world_size=world, timeout=TIMEOUT)


class Rank(single.Driver):
    """One rank's program: the patch set and weights from the seed, its
    cache of its rows, the trainer over the data mesh."""

    #: callables each rank calls before its set-up: a test's planted
    #: fault, in every rank (picklable, as the spawned ranks get them)
    faults = ()

    def __init__(self, cell, rank: int, world: int, dev: torch.device):
        super().__init__(cell)
        self.rank, self.world, self.dev = rank, world, dev

    def setup(self) -> None:
        from wsiseg_tpu_torch.parallel.mesh import make_mesh
        from wsiseg_tpu_torch.train.device_cache import (cache_rows,
                                                         cached_training)
        from wsiseg_tpu_torch.train.loop import Trainer

        c, t = self.cfg_json, self.t
        _claim(self.dev, self.world)
        gen = torch.Generator(device=self.dev).manual_seed(self.cell.seed)
        self.state0 = training.initial_state(c, gen)
        self.data = self._data(gen)
        self.cls_w, self.seg_w = training.patch_class_weights(
            self.data, c["num_classes"])
        _join(self.cell, self.rank, self.world, self.dev)

        self.cfg = training.train_config(self.cell, device_cache=True,
                                         mesh=str(self.world))
        self.mesh = make_mesh(shape=(self.world,), axes=("data",))
        state = training.train_state(c, self.cfg, self.state0, self.dev)
        model = state.model
        b, n = t["batch_size"], t["patches"]
        cut = cache_rows(self.cfg, self.mesh)
        _, cstep, make_batches = cached_training(
            ({k: v[i:i + b][cut(b)] for k, v in self.data.items()}
             for i in range(0, n - n % b, b)), model, self.cfg, self.dev,
            self.mesh, max_bytes=int(self.cfg.device_cache_gb * 1e9),
            cls_weights=self.cls_w, seg_weights=self.seg_w)
        self.first: Dict = {}
        self.start = {k: p.detach().float().clone()
                      for k, p in model.named_parameters()}
        k = t["checked_steps"]

        def step(st, batch, g):
            hook = (st.model.register_forward_hook(self._keep_output)
                    if self.steps_run == 0 else None)
            out = cstep(st, batch, g)
            if hook is not None:
                hook.remove()
                self.first["idx"] = batch["idx"].detach().cpu().numpy()
            self.steps_run += 1
            if self.steps_run == k:
                self.first["params"] = {
                    n: p.detach().float().clone()
                    for n, p in st.model.named_parameters()}
            return out

        self.steps_run = 0
        self.trainer = Trainer(self.cfg, state, step, mesh=self.mesh,
                               make_batches=make_batches,
                               preprocess_batch=None, validate_fn=None,
                               log_fn=lambda s: None)
        self.epoch = 1
        self._epoch()
        self._gather_first_rows()
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    # ---- the rows of the global batch ----

    def global_rows(self, local: np.ndarray, rank: int) -> np.ndarray:
        """Rows of the patch set of rank ``rank``'s local cache rows."""
        m = self.t["batch_size"] // self.world
        k, j = np.divmod(local, m)
        return k * self.t["batch_size"] + rank * m + j

    def _gather_first_rows(self) -> None:
        """Each rank's first-step loss row by row, by the reference's rule
        on the reference's rows, gathered in rank (``batch_rows``) order;
        a row the program left out is NaN."""
        out = self.first.pop("out")
        n = out["seg"].shape[0]
        rows = self.global_rows(self.first["idx"][:n], self.rank)
        cls_w, seg_w = self._weights()
        batch = {key: torch.from_numpy(v[rows]).to(self.dev)
                 for key, v in self.data.items()}
        mine = torch.full((len(self.first["idx"]),), float("nan"),
                          device=self.dev)
        mine[:n] = ref_train.row_losses(out, batch, cls_w, seg_w).float()
        got = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(got, mine)
        self.first["rows"] = torch.cat(got)

    def _weights(self):
        cls_w = torch.tensor(self.cls_w, dtype=torch.float32, device=self.dev)
        seg_w = torch.tensor(self.seg_w, dtype=torch.float32, device=self.dev)
        return cls_w, seg_w

    # ---- commands ----

    def command(self, cmd: int = STOP) -> int:
        """Rank 0's ``cmd``, on every rank."""
        t = torch.tensor([cmd], dtype=torch.int64, device=self.dev)
        dist.broadcast(t, 0)
        return int(t.item())

    def replica_gap(self) -> float:
        """The largest |θ_r − θ_0| over ranks and parameters."""
        params = [p.detach().float().reshape(-1)
                  for p in self.trainer.state.model.parameters()]
        mine = torch.cat(params)
        lead = mine.clone()
        dist.broadcast(lead, 0)
        gap = (mine - lead).abs().max().reshape(1)
        dist.all_reduce(gap, op=dist.ReduceOp.MAX)
        return float(gap.item())

    def follow(self) -> None:
        """A spawned rank: each command of rank 0 until ``STOP``."""
        while True:
            cmd = self.command()
            if cmd == EPOCH:
                self._epoch()
            elif cmd == REPLICA:
                self.replica_gap()
            else:
                return


def _follower(index: int, cell, world: int, faults) -> None:
    # the run's result is the last line rank 0 writes: a spawned rank
    # writes nothing to standard output
    devnull = os.open(os.devnull, os.O_WRONLY)
    os.dup2(devnull, 1)
    rank = index + 1
    for plant in faults:
        plant()
    try:
        r = Rank(cell, rank, world, _devices(cell, world)[rank])
        r.setup()
        r.follow()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Driver(Rank):
    """Rank 0, in the run's process."""

    def __init__(self, cell):
        self.world = cell.traffic["world"]
        super().__init__(cell, 0, self.world,
                         _devices(cell, self.world)[0])
        self.procs = None

    def setup(self) -> None:
        # a program without the data-parallel cache fails here, before
        # any rank starts
        from wsiseg_tpu_torch.train.device_cache import cached_training  # noqa: F401
        for plant in self.faults:
            plant()
        self.procs = torch.multiprocessing.start_processes(
            _follower, args=(self.cell, self.world, self.faults),
            nprocs=self.world - 1, join=False, start_method="spawn")
        self._or_end(super().setup)

    def _or_end(self, fn, *args):
        """``fn(*args)``; on an error, every other rank is ended and the
        group destroyed before the error propagates."""
        try:
            return fn(*args)
        except BaseException:
            if self.procs is not None:
                for p in self.procs.processes:
                    p.kill()
                for p in self.procs.processes:
                    p.join()
                self.procs = None
            if dist.is_initialized():
                dist.destroy_process_group()
            raise

    def window(self, seconds: float) -> Dict:
        return self._or_end(self._window, seconds)

    def _window(self, seconds: float) -> Dict:
        s0 = self.steps_run
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.command(EPOCH)
            self._epoch()
        wall = time.perf_counter() - t0
        steps = self.steps_run - s0
        patches = steps * self.t["batch_size"]
        return {"e2e": {"train_patches_per_s": patches / wall},
                "attempted": steps, "failed": 0, "steps": steps,
                "patches": patches, "wall_s": wall}

    def release(self) -> None:
        self._or_end(self._release)
        super().release()

    def _release(self) -> None:
        if dist.is_initialized():
            self.command(REPLICA)
            self.replica = self.replica_gap()
            self.command(STOP)
            dist.destroy_process_group()
        if self.procs is not None:
            while not self.procs.join():     # one rank at a time
                pass
            self.procs = None

    # ---- after the window ----

    def _reference_inputs(self):
        """The global batches of the checked steps (each rank's local
        batch at its ``batch_rows``), their jitter generators, and the
        class weights."""
        k, b = self.t["checked_steps"], self.t["batch_size"]
        m = b // self.world
        local = ref_train.epoch_order(self.cfg.seed, 0,
                                      self.t["patches"] // self.world)
        batches, gens = [], []
        for i in range(k):
            idx = np.concatenate([self.global_rows(local[i * m:(i + 1) * m],
                                                   r)
                                  for r in range(self.world)])
            batches.append({key: torch.from_numpy(v[idx]).to(self.dev)
                            for key, v in self.data.items()})
            gens.append(ref_train.step_generator(self.cfg.seed, 1, i,
                                                 self.dev))
        return (batches, gens) + self._weights()

    def program_steps(self) -> Dict:
        return {"rows": self.first["rows"], "params": self.first["params"]}

    def readings(self) -> Dict[str, float]:
        out = ref_train.gaps(self.program_steps(), self.reference_steps(),
                             self.start)
        out["replica_gap"] = self.replica
        return out

    def control_readings(self) -> Dict[str, float]:
        out = ref_train.gaps(self.reference_steps(control=True),
                             self.reference_steps(), self.start)
        out["replica_gap"] = self.replica
        return out
