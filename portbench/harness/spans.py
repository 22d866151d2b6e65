"""Host spans from the benchmark's own wrappers.

In a traced run the benchmark replaces named functions of the program's
modules (by attribute, for the run only) with wrappers that record the
wall time of each call, or of each step of an iterator, as a span:
(start, end, thread) on the ``perf_counter`` clock. What it wraps is
data: each ``portbench/spans/<span>.json`` names the span and its
targets (:func:`load`). The program's own ranges
(``torch.profiler.record_function``) are recorded too, under
``program:<name>`` (:meth:`Spans.annotations`), so that a range the
program adds can be read by a new metric reader alone.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import importlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Iterable, List, Optional, Tuple

import torch

SPANS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "spans")

# what a call served, by the name a span file gives it
ITEMS: dict = {"calls": None,
               "len": len,
               "rows": lambda out: out[0].shape[0]}


class Spans:
    def __init__(self):
        self.records = defaultdict(list)   # name → [(start, end, thread)]
        self.items = defaultdict(int)      # name → items its calls served
        self._lock = threading.Lock()

    def add(self, name: str, t0: int, t1: int, items: int = 1) -> None:
        with self._lock:
            self.records[name].append((t0, t1, threading.get_ident()))
            self.items[name] += items

    def total_s(self, name: str) -> float:
        """Wall seconds under span ``name``: the union of its intervals on
        each thread, so that a call nested in another of the same name
        counts once."""
        by_thread = defaultdict(list)
        for s, e, th in self.records.get(name, ()):
            by_thread[th].append((s, e))
        total = 0
        for ivs in by_thread.values():
            end = None
            for s, e in sorted(ivs):
                if end is None or s > end:
                    total += e - s
                    end = e
                elif e > end:
                    total += e - end
                    end = e
        return total / 1e9

    def count(self, name: str) -> int:
        return len(self.records.get(name, ()))

    def timed(self, fn, name: str, items=None):
        """``fn`` with each call recorded as a span ``name``; ``items``
        (result → int) counts what a call served (default 1)."""
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter_ns()
            out = fn(*args, **kwargs)
            self.add(name, t0, time.perf_counter_ns(),
                     1 if items is None else items(out))
            return out
        return wrapper

    def timed_iter(self, fn, name: str):
        """``fn``, a function that returns an iterator, with each wait for
        the iterator's next item recorded as a span ``name``."""
        spans = self

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            it = iter(fn(*args, **kwargs))
            while True:
                t0 = time.perf_counter_ns()
                try:
                    item = next(it)
                except StopIteration:
                    spans.add(name, t0, time.perf_counter_ns(), 0)
                    return
                spans.add(name, t0, time.perf_counter_ns())
                yield item
        return wrapper

    @contextlib.contextmanager
    def annotations(self):
        """Within the block, every ``record_function`` range the program
        opens and closes is also a span ``program:<name>``."""
        rf = torch.autograd.profiler.record_function
        enter, leave = rf.__enter__, rf.__exit__
        spans = self

        def _enter(this):
            this._portbench_t0 = time.perf_counter_ns()
            return enter(this)

        def _leave(this, *exc):
            out = leave(this, *exc)
            spans.add(f"program:{this.name}", this._portbench_t0,
                      time.perf_counter_ns())
            return out

        rf.__enter__, rf.__exit__ = _enter, _leave
        try:
            yield self
        finally:
            rf.__enter__, rf.__exit__ = enter, leave

    @contextlib.contextmanager
    def installed(self, targets: Iterable[Tuple]):
        """Within the block, each (owner, attribute, span, kind, items)
        has its attribute replaced by a wrapper (kind ``"call"`` or
        ``"iter"``; ``items``, result → int or None); the originals come
        back on exit."""
        saved: List[Tuple[object, str, object]] = []
        try:
            for owner, attr, name, kind, items in targets:
                fn = getattr(owner, attr)
                saved.append((owner, attr, fn))
                setattr(owner, attr,
                        self.timed(fn, name, items) if kind == "call"
                        else self.timed_iter(fn, name))
            yield self
        finally:
            for owner, attr, fn in reversed(saved):
                setattr(owner, attr, fn)


def _owner(at: str) -> Tuple[object, str]:
    """``"package.module:Class.attr"`` → (the module or class, "attr")."""
    mod, _, path = at.partition(":")
    *outer, attr = path.split(".")
    owner = importlib.import_module(mod)
    for part in outer:
        owner = getattr(owner, part)
    return owner, attr


def load(spans_dir: str = SPANS_DIR) -> List[Tuple[object, str, str, str,
                                                   Optional[Callable]]]:
    """Every span file's targets, as :meth:`Spans.installed` takes them.

    ``spans/<span>.json`` holds ``{"targets": [{"at": "module:attr",
    "kind": "call" | "iter", "items": "calls" | "len" | "rows"}]}``: the
    functions whose calls (or iterator steps) make up span ``<span>``
    and what a call serves (one item, ``len`` of its result, or the rows
    of its result's first element)."""
    out = []
    for path in sorted(glob.glob(os.path.join(spans_dir, "*.json"))):
        name = os.path.basename(path)[:-len(".json")]
        with open(path) as f:
            spec = json.load(f)
        for t in spec["targets"]:
            owner, attr = _owner(t["at"])
            out.append((owner, attr, name, t.get("kind", "call"),
                        ITEMS[t.get("items", "calls")]))
    return out
