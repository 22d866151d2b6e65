"""The traced window: ``torch.profiler`` on the device, the benchmark's
own spans on the host, and the readings taken from both.

Device activity (kernels, copies, fills) comes from the profiler's
kineto events; busy time is the union of their intervals, so two
streams that overlap count once. Host spans are the benchmark's wrappers
around calls into the program's layers (:mod:`.spans`); each idle gap of
the device is labelled with the host span that covers its middle.
The readings mirror the port's ``utils/profiling.trace`` (kernel time by
name, busy share), copied here so that the program cannot move them.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from portbench.harness.spans import Spans


@dataclass
class Trace:
    """What a traced window recorded. Times in seconds, from the window's
    start."""
    window_s: float
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    spans: Optional[Spans] = None
    host_offset_ns: int = 0        # kineto clock − perf_counter clock
    start_ns: int = 0              # window start on the kineto clock

    def device_time(self, *patterns: str) -> float:
        """Seconds of device activity whose name holds any of
        ``patterns`` (case-insensitive), summed."""
        pats = [p.lower() for p in patterns]
        return sum(d for n, _, d in self.kernels
                   if any(p in n.lower() for p in pats))

    def count(self, *patterns: str) -> int:
        pats = [p.lower() for p in patterns]
        return sum(1 for n, _, _ in self.kernels
                   if any(p in n.lower() for p in pats))

    def merged(self) -> List[Tuple[float, float]]:
        """Busy intervals: the union of every device interval."""
        out: List[Tuple[float, float]] = []
        for _, s, d in sorted(self.kernels, key=lambda k: k[1]):
            e = s + d
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged())

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The ``top`` longest stretches with nothing on the device, each
        named by the host span that covers its middle ("none" if no
        span does), as [name, seconds]."""
        gaps, t = [], 0.0
        for s, e in self.merged() + [(self.window_s, self.window_s)]:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:top]:
            out.append([self.host_at(0.5 * (s + e)), e - s])
        return out

    def host_at(self, t: float) -> str:
        """The innermost host span running at window time ``t``."""
        if self.spans is None:
            return "none"
        best, best_len = "none", None
        for name, recs in self.spans.records.items():
            for s, e, _ in recs:
                s0 = (s + self.host_offset_ns - self.start_ns) / 1e9
                e0 = (e + self.host_offset_ns - self.start_ns) / 1e9
                if s0 <= t <= e0 and (best_len is None or e0 - s0 < best_len):
                    best, best_len = name, e0 - s0
        return best

    def top_ops(self, top: int = 10) -> List[List]:
        """The device operations that took most time, as [name, s]."""
        by = defaultdict(float)
        for n, _, d in self.kernels:
            by[n[:120]] += d
        return [[n, s] for n, s in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]


@contextlib.contextmanager
def traced(spans: Spans, cuda: bool):
    """Profile the block; yields a dict that holds the :class:`Trace`
    under ``"trace"`` once the block has ended. The window runs from the
    block's entry to its exit (after a synchronize)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts = [torch.profiler.ProfilerActivity.CUDA]
    box: Dict[str, Trace] = {}
    with torch.profiler.profile(activities=acts) as prof:
        wall0, perf0 = time.time_ns(), time.perf_counter_ns()
        yield box
        if cuda:
            torch.cuda.synchronize()
        perf1 = time.perf_counter_ns()
    res = prof.profiler.kineto_results
    start = res.trace_start_ns()
    # the profiler's clock: the wall clock or a monotonic one
    offset = (wall0 - perf0 if abs(start - wall0) < abs(start - perf0)
              else 0)
    t0 = perf0 + offset
    kernels = []
    for ev in res.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        kernels.append((ev.name(), (ev.start_ns() - t0) / 1e9,
                        ev.duration_ns() / 1e9))
    box["trace"] = Trace(window_s=(perf1 - perf0) / 1e9, kernels=kernels,
                         spans=spans, host_offset_ns=offset, start_ns=t0)
