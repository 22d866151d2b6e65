"""The fused route one group deep (``predict_slides_fcn``'s ``ahead``):
``_pipelined_results(fcn=True)`` over folders whose groups take every
turn the pipeline has (a short last group, a single-slide group, a change
of padded dims mid-folder, a generator closed after its first yield)
returns what the same groups served one at a time return, array for
array and in order, and ``engine.AHEAD`` counts the groups finished with
a later one enqueued. A tiny resnet18 Unet on the CPU, two slides a
group."""

import numpy as np
import pytest
import torch

from wsiseg_tpu_torch.config import default_config
from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection
from wsiseg_tpu_torch.infer import engine as engine_mod
from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
from wsiseg_tpu_torch.infer.evaluators import _fcn_groups, \
    _pipelined_results
from wsiseg_tpu_torch.models.ynet import init_ynet
from wsiseg_tpu_torch.slides import SyntheticSlide

torch.set_num_threads(2)

#: level-0 (width, height) of each kind of slide: A pads to 96×256, B to
#: 128×256 (another group key), N to 192×256, over the engine's cap
SIZES = {"A": (2048, 1536), "B": (2048, 2048), "N": (2048, 3072)}
#: folder → (slide kinds in order, groups of two, AHEAD per pass)
FOLDERS = {
    "all_fused": ("AAAAAA", [2, 2, 2], 2),
    "one_group": ("AA", [2], 0),
    "short_last": ("AAAAA", [2, 2, 1], 1),
    "single_mid": ("AANAA", [2, 1, 2], 0),
    "key_change": ("AABBAA", [2, 2, 2], 2),
}


@pytest.fixture(scope="module")
def engine():
    cfg = default_config(tile_w=64, tile_h=64, tile_stride_w=32,
                         tile_stride_h=32, compute_dtype="float32",
                         wsi_mask_pth="")
    eng = DenseInferenceEngine(init_ynet(cfg, torch.Generator()
                                         .manual_seed(0)), cfg,
                               device="cpu", dtype=torch.float32)
    eng.slides_in_flight = 2
    eng.fcn_fast_max_px = 128 * 256          # N takes the banded route
    return eng


def _collection(engine, kinds):
    slides = [(f"{kind}{k}", SyntheticSlide(*SIZES[kind], num_levels=3,
                                            seed=60 + k))
              for k, kind in enumerate(kinds)]
    return SlideCollection(slides, engine.cfg)


def _one_group_at_a_time(engine, coll):
    out = []
    for g in _fcn_groups(engine, list(coll.items())):
        plans = [p for _, p in g]
        res = ([engine.predict_slide_fcn(plans[0])] if len(g) == 1
               else engine.predict_slides_fcn(plans))
        assert engine._ahead is None
        out += [(name, r) for (name, _), r in zip(g, res)]
    return out


def _assert_same(got, want):
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a.name == name
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.heatmap, b.heatmap)


@pytest.mark.parametrize("folder", sorted(FOLDERS))
def test_pipelined_equals_one_group_at_a_time(engine, folder):
    kinds, sizes, ahead = FOLDERS[folder]
    coll = _collection(engine, kinds)
    assert [len(g) for g in _fcn_groups(engine, list(coll.items()))] \
        == sizes
    want = _one_group_at_a_time(engine, coll)
    before = engine_mod.AHEAD
    got = [(name, res) for name, _, res in
           _pipelined_results(engine, coll, fcn=True)]
    assert engine_mod.AHEAD - before == ahead
    assert engine._ahead is None
    _assert_same(got, want)


def test_closed_early_leaves_nothing_pending(engine):
    """A generator closed after its first yield leaves no group pending,
    and a fresh pass over the folder then returns every slide as served
    one group at a time."""
    coll = _collection(engine, FOLDERS["all_fused"][0])
    want = _one_group_at_a_time(engine, coll)
    gen = _pipelined_results(engine, coll, fcn=True)
    name, _, first = next(gen)
    assert engine._ahead is not None
    gen.close()
    assert engine._ahead is None
    _assert_same([(name, first)], want[:1])
    before = engine_mod.AHEAD
    got = [(n, r) for n, _, r in _pipelined_results(engine, coll, fcn=True)]
    assert engine_mod.AHEAD - before == 2
    _assert_same(got, want)


def test_unmatched_pending_group_is_dropped(engine):
    """A call whose plans are not the pending group's drops that group
    and serves its own; a call without ``ahead`` leaves nothing pending."""
    coll = _collection(engine, "AAAAAA")
    plans = [p for _, p in coll.items()]
    want = _one_group_at_a_time(engine, coll)
    first = engine.predict_slides_fcn(plans[:2], ahead=(plans[2:4], None))
    assert engine._ahead is not None
    third = engine.predict_slides_fcn(plans[4:])
    assert engine._ahead is None
    second = engine.predict_slides_fcn(plans[2:4])
    got = [(r.name, r) for r in first + second + third]
    _assert_same(got, want)
