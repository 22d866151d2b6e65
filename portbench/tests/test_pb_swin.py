"""The Swin cell's arithmetic and reference: the window attention's and
the whole forward's FLOP counts against hand arithmetic, the readers on a
made-up trace, the reference's blocked window attention and imports, and
tiny sound, fault and control runs."""

from __future__ import annotations

import ast
import json
import os
from types import SimpleNamespace

import pytest
import torch

from pb_util import ROOT
from portbench.harness import swin_cost
from portbench.harness.spans import Spans
from portbench.harness.trace import Trace
from portbench.reference import swin_upernet
from test_pb_faults import _altered, restore  # noqa: F401
from test_pb_faults import _run as tiny_cell

with open(os.path.join(ROOT, "portbench", "configs",
                       "swinb_upernet.json")) as f:
    CFG = json.load(f)

DIMS, HEADS, DEPTHS, WS = (128, 256, 512, 1024), (4, 8, 16, 32), \
    (2, 2, 18, 2), 12


def up(a, b):
    return -(-a // b)


def maps(h, w):
    """Each stage's token map: ⌈h/4⌉, then halved rounding up."""
    out, hh, ww = [], up(h, 4), up(w, 4)
    for _ in range(4):
        out.append((hh, ww))
        hh, ww = up(hh, 2), up(ww, 2)
    return out


def attention_by_hand(h, w):
    ops = 0
    for (hh, ww), heads, depth in zip(maps(h, w), HEADS, DEPTHS):
        ops += depth * 4 * up(hh, WS) * up(ww, WS) * heads * 144 ** 2 * 32
    return ops


def macs_by_hand(h, w):
    """Swin-B's convs and linears (qkv and proj over the padded windows,
    the MLP over the real tokens), the patch mergings, UPerNet at 512
    channels and the 1×1 head."""
    ms = maps(h, w)
    mac = ms[0][0] * ms[0][1] * 128 * 3 * 16                 # patch embed
    for i, ((hh, ww), c, depth) in enumerate(zip(ms, DIMS, DEPTHS)):
        padded = up(hh, WS) * WS * up(ww, WS) * WS
        mac += depth * (padded * c * 4 * c + hh * ww * c * 8 * c)
        if i < 3:
            mac += up(hh, 2) * up(ww, 2) * 4 * c * 2 * c    # merging
    t = [a * b for a, b in ms]
    mac += sum(b * b for b in (1, 2, 3, 6)) * 1024 * 512     # PPM
    mac += t[3] * 9 * (1024 + 4 * 512) * 512                  # bottleneck
    for i in range(3):
        mac += t[i] * DIMS[i] * 512 + t[i] * 9 * 512 * 512    # lateral, fpn
    mac += t[0] * 9 * 2048 * 512 + t[0] * 512 * 4             # fuse, head
    return mac


@pytest.mark.parametrize("h,w", [(3072, 4096), (512, 2048)])
def test_forward_flops_by_hand(h, w):
    assert swin_cost.attention_cost(CFG, h, w)[0] == attention_by_hand(h, w)
    assert len(swin_cost.attention_shapes(CFG, h, w)) == 24
    assert swin_cost.forward_flops(CFG, h, w) == \
        2 * macs_by_hand(h, w) + attention_by_hand(h, w)


def test_bench_slide_totals():
    """A 3072×4096 slide: 28.4 TFLOP in all, 0.46 of them the window
    products; stage 1 is 768×1024 tokens padded to 768×1032, 5,504
    windows, 149 of them masked on a shifted block. At the paper's
    512×2048, 1201 G multiply-adds: 1.1 % above its 1188 G (qkv and proj
    here count the window padding, 132×516 stage-1 tokens)."""
    total = swin_cost.forward_flops(CFG, 3072, 4096)
    ops, nbytes = swin_cost.attention_cost(CFG, 3072, 4096)
    assert round(total / 1e12, 1) == 28.4 and round(ops / 1e12, 2) == 0.46
    assert round(nbytes / 1e9, 1) == 6.4
    assert swin_cost.attention_shapes(CFG, 3072, 4096)[:2] == [
        (5504, 4, 144, 32, 0), (5504, 4, 144, 32, 149)]
    macs = swin_cost.forward_flops(CFG, 512, 2048) / 2
    assert abs(macs / 1188e9 - 1) < 0.015


def _run(kernels, launches, slides=4, window_s=1.0):
    spans = Spans()
    for k in range(launches):
        spans.add(swin_cost.WATTN_RANGE, k, k + 1)
    trace = Trace(window_s=window_s, kernels=kernels, spans=spans)
    return SimpleNamespace(
        cell=SimpleNamespace(config=CFG, traffic={"level2_hw": [3072,
                                                                4096]}),
        window={"slides": slides}, trace=trace, spans=spans,
        kind="NVIDIA H100 80GB HBM3")


def test_readers_on_a_made_up_trace():
    """36 window-attention kernels of 0.1 s each (one group of four
    slides) and one other kernel of 4 s; the window 40 s."""
    attn = [(f"fmha_cutlassF_bf16_aligned_64x64_rf_sm80_{k}", 0.1 * k, 0.1)
            for k in range(36)]
    other = [("nvjet_tst_gemm", 26.0, 4.0)]
    run = _run(attn + other, 36, window_s=40.0)
    ops, nbytes = swin_cost.attention_cost(CFG, 3072, 4096)
    assert swin_cost.wattn_share(run) == pytest.approx(100 * 3.6 / 7.6)
    assert swin_cost.wattn_roofline(run) == pytest.approx(
        100 * 4 * nbytes / 3.35e12 / 3.6)
    total = swin_cost.forward_flops(CFG, 3072, 4096)
    assert swin_cost.mfu(run) == pytest.approx(100 * 4 * total / 40 / 989e12)
    # a kernel missing, or an unknown card: nothing to read
    assert swin_cost.wattn_roofline(_run(attn[1:] + other, 36)) is None
    assert swin_cost.wattn_share(_run(attn, 0)) is None
    run.kind = "cpu"
    assert swin_cost.wattn_roofline(run) is None and swin_cost.mfu(run) is None


def test_blocked_window_attention_equals_whole(monkeypatch):
    """Blocks of windows (a multiple of the map's windows, so each block
    meets its masks) give the unblocked product."""
    attn = swin_upernet.WindowAttention(64, 2, 12).eval()
    torch.nn.init.normal_(attn.relative_position_bias_table)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2 * 12, 144, 64, generator=g)
    mask = swin_upernet.shift_mask(36, 48, 12, 6, "cpu")
    with torch.no_grad():
        whole = attn(x, mask)
        monkeypatch.setattr(swin_upernet, "SCORE_BYTES", 4 * 2 * 144 * 144)
        torch.testing.assert_close(attn(x, mask), whole)


def test_reference_imports_nothing_of_the_program():
    path = os.path.join(ROOT, "portbench", "reference", "swin_upernet.py")
    tree = ast.parse(open(path).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    assert mods <= {"__future__", "typing", "torch", "portbench"}, mods


def test_tiny_sound_run_is_correct():
    assert tiny_cell("planned.swinb_upernet")["correct"]


def test_tiny_fault_is_not_correct(restore):  # noqa: F811
    assert not tiny_cell("planned.swinb_upernet", _altered,
                         restore)["correct"]


def test_tiny_control_is_not_correct():
    """The reference from fp8 operands in the program's place."""
    assert not tiny_cell("planned.swinb_upernet", control=True)["correct"]
