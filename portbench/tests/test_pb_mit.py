"""The MiT cell's arithmetic and reference: the attention and whole-forward
FLOP counts against hand arithmetic, the readers on a made-up trace, and
the SegFormer reference's blocked attention, fp8 switch and imports."""

from __future__ import annotations

import ast
import json
import os
from types import SimpleNamespace

import pytest
import torch

from pb_util import ROOT
from portbench.harness import mit_cost
from portbench.harness.spans import Spans
from portbench.harness.trace import Trace
from portbench.reference import segformer
from test_pb_faults import _altered, restore  # noqa: F401
from test_pb_faults import _run as tiny_cell

with open(os.path.join(ROOT, "portbench", "configs", "mitb5_fpn.json")) as f:
    CFG = json.load(f)

DIMS, HEADS, DEPTHS, SR = (64, 128, 320, 512), (1, 2, 5, 8), (3, 6, 40, 3), \
    (8, 4, 2, 1)


def stage_hw(h, w):
    """Each stage's map: h/4, then halved (the sides here divide)."""
    return [(h // 4 >> i, w // 4 >> i) for i in range(4)]


def attention_by_hand(h, w):
    ops = 0
    for (hh, ww), c, heads, depth, r in zip(stage_hw(h, w), DIMS, HEADS,
                                            DEPTHS, SR):
        n, m = hh * ww, (hh // r) * (ww // r)
        ops += depth * 4 * heads * n * m * (c // heads)
    return ops


def macs_by_hand(h, w):
    """Convs and linears of MiT-B5 + the program's FPN + the 1×1 head."""
    mac, cin = 0, 3
    for i, ((hh, ww), c, depth, r) in enumerate(zip(stage_hw(h, w), DIMS,
                                                    DEPTHS, SR)):
        n, m = hh * ww, (hh // r) * (ww // r)
        mac += n * c * cin * (49 if i == 0 else 9)          # patch embed
        block = n * c * c * 2 + m * c * 2 * c               # q, proj; kv
        block += m * c * c * r * r if r > 1 else 0          # reduction
        block += n * c * 4 * c * 2 + n * 4 * c * 9          # fc1, fc2; dw
        mac += depth * block
        cin = c
    for lvl, c in ((5, 512), (4, 320), (3, 128), (2, 64)):
        mac += (h >> lvl) * (w >> lvl) * c * 256             # lateral
        s, ch = lvl, 256
        for k in range(max(lvl - 2, 1)):
            mac += (h >> s) * (w >> s) * 9 * ch * 128
            ch = 128
            if k < lvl - 2:
                s -= 1
    return mac + (h // 4) * (w // 4) * 128 * 4


@pytest.mark.parametrize("h,w", [(3072, 4096), (512, 768)])
def test_attention_flops_by_hand(h, w):
    ops, nbytes = mit_cost.attention_cost(CFG, h, w)
    assert ops == attention_by_hand(h, w)
    assert len(mit_cost.attention_shapes(CFG, h, w)) == 52
    n1 = (h // 4) * (w // 4)
    assert mit_cost.attention_shapes(CFG, h, w)[0] == (
        n1, n1 // 64, 1, 64)


@pytest.mark.parametrize("h,w", [(3072, 4096), (512, 768)])
def test_forward_flops_by_hand(h, w):
    assert mit_cost.forward_flops(CFG, h, w) == \
        2 * macs_by_hand(h, w) + attention_by_hand(h, w)


def test_bench_slide_totals():
    """A 3072×4096 slide: 46.7 TFLOP of attention in 53.2 in all (88 %)."""
    att = mit_cost.attention_cost(CFG, 3072, 4096)[0]
    total = mit_cost.forward_flops(CFG, 3072, 4096)
    assert att == 46694884442112
    assert round(att / 1e12, 1) == 46.7 and round(total / 1e12, 1) == 53.2
    assert 0.87 < att / total < 0.89


def _run(kernels, calls, slides=4, window_s=1.0):
    spans = Spans()
    for k in range(calls):
        spans.add(mit_cost.ATTN_RANGE, k, k + 1)
    trace = Trace(window_s=window_s, kernels=kernels, spans=spans)
    return SimpleNamespace(
        cell=SimpleNamespace(config=CFG, traffic={"level2_hw": [3072,
                                                                4096]}),
        window={"slides": slides}, trace=trace, spans=spans,
        kind="NVIDIA H100 80GB HBM3")


def test_readers_on_a_made_up_trace():
    """52 attention kernels of 0.5 s each (one group of four slides) and
    one other kernel of 4 s; the window 40 s."""
    attn = [(f"cudnn_generated_fort_native_sdpa_sm90_flash_fprop_{k}",
             0.5 * k, 0.5) for k in range(52)]
    other = [("nvjet_tst_gemm", 26.0, 4.0)]
    run = _run(attn + other, 52, window_s=40.0)
    ops, nbytes = mit_cost.attention_cost(CFG, 3072, 4096)
    assert mit_cost.attn_share(run) == pytest.approx(100 * 26 / 30)
    assert mit_cost.attn_roofline(run) == pytest.approx(
        100 * 4 * ops / 989e12 / 26)
    total = mit_cost.forward_flops(CFG, 3072, 4096)
    assert mit_cost.mfu(run) == pytest.approx(100 * 4 * total / 40 / 989e12)
    # a kernel missing, or an unknown card: nothing to read
    assert mit_cost.attn_roofline(_run(attn[1:] + other, 52)) is None
    assert mit_cost.attn_share(_run(attn, 0)) is None
    run.kind = "cpu"
    assert mit_cost.attn_roofline(run) is None and mit_cost.mfu(run) is None


def test_blocked_attention_equals_whole(monkeypatch):
    """Blocks of queries give the unblocked product, and the fp8 switch
    moves it and switches back."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 2, 100, 64, generator=g)
    k, v = (torch.randn(2, 2, 12, 64, generator=g) for _ in range(2))
    whole = torch.softmax(q @ k.transpose(-2, -1) / 8, -1) @ v
    monkeypatch.setattr(segformer, "SCORE_BYTES", 4 * 2 * 2 * 12 * 7)
    torch.testing.assert_close(segformer.attention(q, k, v), whole)
    with segformer.fp8_attention():
        low = segformer.attention(q, k, v)
    assert (low - whole).abs().max() > 1e-3
    torch.testing.assert_close(segformer.attention(q, k, v), whole)


def test_reference_imports_nothing_of_the_program():
    path = os.path.join(ROOT, "portbench", "reference", "segformer.py")
    tree = ast.parse(open(path).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    assert mods <= {"__future__", "contextlib", "typing", "torch",
                    "portbench"}, mods


def test_tiny_sound_run_is_correct():
    assert tiny_cell("planned.mitb5_fpn")["correct"]


def test_tiny_fault_is_not_correct(restore):  # noqa: F811
    assert not tiny_cell("planned.mitb5_fpn", _altered, restore)["correct"]


def test_tiny_control_is_not_correct():
    """The reference from fp8 operands in the program's place."""
    assert not tiny_cell("planned.mitb5_fpn", control=True)["correct"]
