"""Start a group of ranks: :func:`run_ranks`.

``run_ranks(fn, world, device)`` starts ``world`` processes (spawned,
never forked), joins them in one process group and calls
``fn(device_of_this_rank, *args)`` in each. The group is initialized
through a ``file://`` store in a fresh temporary directory, so concurrent
groups (tests under several workers) never race for a TCP port. NCCL
runs when the ranks sit on distinct cards, gloo otherwise: on CPU ranks,
and for ranks that share a card (gloo takes CUDA tensors for
``all_reduce`` and ``broadcast``; NCCL refuses two ranks on one device).

A world of 1 runs ``fn`` in this process, in a group of one. Under
``torchrun`` (``WORLD_SIZE`` set) the existing group is joined (or
initialized from the environment) and ``fn`` runs in this rank.

A spawned rank imports the module that defines ``fn``: keep rank
functions in the package, in modules that import no test harness.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


def rank_devices(world: int, device="cuda",
                 devices: Optional[Sequence] = None):
    """Each rank's device: ``devices`` as given, else one card per rank
    on ``cuda`` (raises when fewer are visible; no CPU fallback), else
    the CPU for every rank."""
    if devices is not None:
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        return [torch.device(d) for d in devices]
    device = torch.device(device)
    if device.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < world:
            raise RuntimeError(
                f"{world} ranks on cuda need {world} visible cards; "
                f"{have} visible. Pass --device cpu (CLI) or device='cpu' "
                "for gloo ranks on the CPU")
        return [torch.device("cuda", i) for i in range(world)]
    return [device] * world


def backend_for(devs) -> str:
    """NCCL for ranks on distinct cards, gloo otherwise."""
    cuda = [d for d in devs if d.type == "cuda"]
    if len(cuda) == len(devs) and len({d.index for d in cuda}) == len(devs):
        return "nccl"
    return "gloo"


#: how long a rank waits in a collective: rank 0 alone validates, writes
#: PNGs and checkpoints while the others wait in their next collective
#: (NCCL's default is 10 minutes; a validation over many slides is longer)
TIMEOUT = datetime.timedelta(hours=2)


def _enter(rank: int, world: int, devs, init_method: str, backend: str):
    dev = devs[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    return dev


def _rank_main(rank: int, world: int, devs, init_method: str, backend: str,
               fn: Callable, args, out_path: str, threads: Optional[int]):
    if threads:
        torch.set_num_threads(threads)
    dev = _enter(rank, world, devs, init_method, backend)
    try:
        out = fn(dev, *args)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, device="cuda",
              devices: Optional[Sequence] = None, args: Sequence = (),
              threads: Optional[int] = None):
    """``fn(device, *args)`` on each of ``world`` ranks; returns rank 0's
    (picklable) result. ``threads`` sets each spawned rank's
    ``torch.set_num_threads``."""
    if "WORLD_SIZE" in os.environ:
        return _under_torchrun(fn, device, args)
    devs = rank_devices(world, device, devices)
    backend = backend_for(devs)
    with tempfile.TemporaryDirectory(prefix="wsiseg_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        if world == 1:
            dev = _enter(0, 1, devs, init, backend)
            try:
                return fn(dev, *args)
            finally:
                dist.destroy_process_group()
        out_path = os.path.join(tmp, "rank0.pkl")
        torch.multiprocessing.start_processes(
            _rank_main, args=(world, devs, init, backend, fn, tuple(args),
                              out_path, threads),
            nprocs=world, join=True, start_method="spawn")
        with open(out_path, "rb") as f:
            return pickle.load(f)


def _under_torchrun(fn: Callable, device, args):
    """This rank of a ``torchrun`` job: its card is ``LOCAL_RANK`` on
    ``cuda``; the group is the launcher's (NCCL on cards, gloo on CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                timeout=TIMEOUT)
    return fn(device, *args)
