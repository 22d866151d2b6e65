"""Arithmetic the per-layer readers share (``portbench/metrics/*.py``).

Each reader returns a number, or None where its run holds nothing to
read (then the metric is left out of the result line); a share of a peak
or a roofline is never returned as 0 for want of a reading.
"""

from __future__ import annotations

from typing import Optional

from portbench.harness import flops, roofline


def span_ms_per(run, span: str, per: str = "items") -> Optional[float]:
    """Milliseconds of host wall under ``span`` per item its calls served
    (``per="items"``), or per step of the window (``"steps"``)."""
    n = (run.spans.items.get(span, 0) if per == "items"
         else run.window.get(per, 0))
    if not n or span not in run.spans.records:
        return None
    return 1e3 * run.spans.total_s(span) / n


def idle_share(run) -> Optional[float]:
    """% of the traced window in which nothing ran on the device."""
    t = run.trace
    if t is None or not t.kernels or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def stream_mfu(run) -> Optional[float]:
    """% of the card's bf16 peak: the reference's FLOPs of every slide done
    over the traced window."""
    peak = roofline.peak_flops(run.kind)
    slides = run.window.get("slides", 0)
    if peak is None or not slides or run.trace is None:
        return None
    h, w = run.cell.traffic["level2_hw"]
    f = flops.forward_flops(run.cell.config, 1, h, w)
    return 100.0 * f * slides / (run.trace.window_s * peak)


def train_mfu(run) -> Optional[float]:
    """% of the card's bf16 peak: 3 × the reference's forward FLOPs a
    patch (forward and the two products of the backward) × the patches of
    the traced window's complete steps, over the window."""
    peak = roofline.peak_flops(run.kind)
    patches = run.window.get("patches", 0)
    if peak is None or not patches or run.trace is None:
        return None
    tile = run.cell.traffic["tile"]
    f = flops.forward_flops(run.cell.config, 1, tile, tile, heads=True)
    return 100.0 * 3.0 * f * patches / (run.window["wall_s"] * peak)


def k1_roofline(run) -> Optional[float]:
    """% of K1's least time in its kernel time: the bytes bound of each
    launch in the window (u8 images read once, s2d(c1) and the pooled c1
    written once, weights once) over the summed ``stem_sm90_kernel``
    time. None unless the trace holds one kernel per recorded launch."""
    t = run.trace
    peak = roofline.peak_flops(run.kind)
    recs = run.spans.records.get("k1", [])
    if t is None or peak is None or not recs:
        return None
    if t.count("stem_sm90_kernel") != len(recs):
        return None
    kernel_s = t.device_time("stem_sm90_kernel")
    h, w = run.cell.traffic["level2_hw"]
    ops1, bytes1 = roofline.stem_cost(h, w, pool=True)
    wts = 147 * 64 * 2 + 64 * 4
    images = run.spans.items["k1"]
    bound = roofline.bound_s(ops1 * images,
                             (bytes1 - wts) * images + wts * len(recs), peak)
    return 100.0 * bound / kernel_s if kernel_s > 0 else None
