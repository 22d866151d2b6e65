"""Host→device prefetch — counterpart of ``prefetch_to_device`` in
``wsiseg_tpu/data/pipeline.py``, which feeds the engine's streamed route
and the trainers. That module's ``ThreadedBatcher`` has no caller on
either path and is not ported.

A worker thread pulls host batches, copies their numpy arrays into pinned
buffers and from there to the device on a side CUDA stream, and records
one event per batch; the consumer's stream waits on that event before it
reads the batch. At most ``depth`` batches wait in the queue.

Ranges (``torch.profiler.record_function``): on the consumer,
``loader.wait`` (each wait for the next batch: the first one starts the
worker, the last one ends the iterator) and ``loader.close`` (the worker stopped and joined); on the
worker, ``loader.next`` (the host iterator's next batch) and
``loader.copy`` (a batch staged to the device).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.profiler import record_function


class _Done:
    pass


_DONE = _Done()


class _PinnedRing:
    """``slots`` sets of pinned host buffers, one per batch key, reused in
    turn. A slot is refilled only after the copy last issued from it has
    finished (its event), so a buffer is never overwritten while the card
    still reads it."""

    def __init__(self, slots: int):
        self._bufs: List[Dict[str, torch.Tensor]] = [{} for _ in range(slots)]
        self._done: List[Optional[torch.cuda.Event]] = [None] * slots
        self._next = 0

    def stage(self, batch: dict, device: torch.device,
              stream: torch.cuda.Stream):
        k = self._next
        self._next = (k + 1) % len(self._bufs)
        if self._done[k] is not None:
            self._done[k].synchronize()
        bufs, out = self._bufs[k], {}
        with torch.cuda.stream(stream):
            for key, v in batch.items():
                if not isinstance(v, np.ndarray):
                    out[key] = v
                    continue
                src = torch.from_numpy(np.ascontiguousarray(v))
                buf = bufs.get(key)
                if buf is None or buf.shape != src.shape \
                        or buf.dtype != src.dtype:
                    buf = bufs[key] = torch.empty(src.shape, dtype=src.dtype,
                                                  pin_memory=True)
                buf.copy_(src)
                out[key] = buf.to(device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(stream)
        self._done[k] = ready
        return out, ready


def prefetch_to_device(batch_iter: Iterator[dict], depth: int = 2,
                       device=None) -> Iterator[dict]:
    """Wrap an iterator of host batches (dicts): each numpy array value
    arrives as a tensor on ``device`` (default: the current CUDA device),
    any other value unchanged. Batches are staged up to ``depth`` ahead of
    the consumer. On a CUDA device the copies come from a ring of
    ``depth + 2`` pinned buffer sets on a side stream, and each batch is
    yielded once the consumer's current stream waits on its copy's event.
    An exception in the worker (the host iterator's too) is raised in the
    consumer."""
    device = torch.device(device if device is not None else "cuda")
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    err: list = []
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            if cuda:
                torch.cuda.set_device(device)
                stream = torch.cuda.Stream(device)
                ring = _PinnedRing(max(1, depth) + 2)
            it = iter(batch_iter)
            while True:
                with record_function("loader.next"):
                    b = next(it, _DONE)
                if b is _DONE:
                    break
                with record_function("loader.copy"):
                    if cuda:
                        item = ring.stage(b, device, stream)
                    else:
                        item = ({k: torch.from_numpy(np.ascontiguousarray(v))
                                 .to(device) if isinstance(v, np.ndarray)
                                 else v for k, v in b.items()}, None)
                if not put(item):
                    return
        except BaseException as e:   # handed to the consumer, raised there
            err.append(e)
        finally:
            put(_DONE)

    t = threading.Thread(target=worker, daemon=True)
    try:
        while True:
            with record_function("loader.wait"):
                if t.ident is None:   # the first wait covers its start
                    t.start()
                item = q.get()
                if isinstance(item, _Done):
                    if err:
                        raise err[0]
                    return
                out, ready = item
                if ready is not None:
                    cur = torch.cuda.current_stream(device)
                    cur.wait_event(ready)
                    for v in out.values():
                        if isinstance(v, torch.Tensor):
                            v.record_stream(cur)
            yield out
    finally:
        with record_function("loader.close"):
            stop.set()
            t.join(timeout=10)
