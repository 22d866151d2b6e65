"""The port's streamed grid and banded FCN (wsiseg_tpu_torch:
data/pipeline.prefetch_to_device, DenseInferenceEngine
.predict_slide_streamed, .predict_slide_fcn_banded, the oversize routing
and ``FCN_FAST_MAX_PX``) against the port's own resident and chunked
routes, which tests/test_torch_grid.py holds against the JAX engine:
streamed equals resident, banded equals chunked, exactly."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from wsiseg_tpu_torch.config import default_config
from wsiseg_tpu_torch.data.pipeline import prefetch_to_device
from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection, plan_slide
from wsiseg_tpu_torch.infer import engine as engine_mod
from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
from wsiseg_tpu_torch.infer.evaluators import _pipelined_results, \
    predict_tumorbed
from wsiseg_tpu_torch.models.ynet import init_ynet
from wsiseg_tpu_torch.slides import SyntheticSlide

torch.set_num_threads(2)


class _SpySlide:
    """Slide wrapper that records read sizes and whole-level reads
    (tests/test_banded_fcn.py's)."""

    def __init__(self, inner):
        self._inner = inner
        self.max_read_px = 0
        self.read_level_calls = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @property
    def level_dimensions(self):
        return self._inner.level_dimensions

    @property
    def level_downsamples(self):
        return self._inner.level_downsamples

    @property
    def level_count(self):
        return self._inner.level_count

    def read_region(self, location, level, size):
        self.max_read_px = max(self.max_read_px, size[0] * size[1])
        return self._inner.read_region(location, level, size)

    def read_level(self, level):
        self.read_level_calls += 1
        return self._inner.read_level(level)


@pytest.fixture(scope="module")
def cfg():
    return default_config(tile_w=64, tile_h=64, tile_stride_w=64,
                          tile_stride_h=64, compute_dtype="float32",
                          infer_batch_size=8, wsi_mask_pth="")


@pytest.fixture(scope="module")
def model(cfg):
    return init_ynet(cfg, torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def engine(cfg, model):
    return DenseInferenceEngine(model, cfg, device="cpu")


@pytest.fixture(scope="module")
def slide():
    return SyntheticSlide(width=2048, height=1536, num_levels=3, seed=2)


# ---- prefetch_to_device ----

def test_prefetch_keeps_order_and_values():
    r = np.random.RandomState(0)
    batches = [{"x": r.randint(0, 256, (3, 5)).astype(np.uint8),
                "ys": [k, k + 1], "k": k} for k in range(7)]
    got = list(prefetch_to_device(iter(batches), depth=2, device="cpu"))
    assert len(got) == 7
    for b, g in zip(batches, got):
        assert isinstance(g["x"], torch.Tensor)
        np.testing.assert_array_equal(g["x"].numpy(), b["x"])
        assert g["ys"] == b["ys"] and g["k"] == b["k"]


def test_prefetch_raises_worker_errors():
    def batches():
        yield {"x": np.zeros(2)}
        raise OSError("tile decode failed")

    it = prefetch_to_device(batches(), depth=1, device="cpu")
    next(it)
    with pytest.raises(OSError, match="tile decode failed"):
        next(it)


def test_prefetch_stops_its_worker_when_closed():
    """A consumer that stops early ends the worker thread, which is
    blocked on the full queue."""
    n0 = threading.active_count()
    it = prefetch_to_device(({"x": np.zeros(4)} for _ in range(1000)),
                            depth=1, device="cpu")
    next(it)
    it.close()
    assert threading.active_count() == n0


# ---- streamed == resident ----

@pytest.mark.parametrize("mode", ["seg", "cls"])
def test_streamed_matches_resident(cfg, model, mode):
    """At stride 32 every pixel is covered by up to 4 tiles, in batches
    of 4 with a padded last batch."""
    cfg = cfg.replace(tile_stride_w=32, tile_stride_h=32,
                      infer_batch_size=4)
    eng = DenseInferenceEngine(model, cfg, mode=mode, device="cpu")
    plan = plan_slide("s", SyntheticSlide(width=4096, height=3072,
                                          num_levels=3, seed=2), cfg)
    assert len(plan.grid) > 8 and len(plan.grid) % 4
    res = eng.predict_slide(plan, keep_canvas=True)
    st = eng.predict_slide_streamed(plan, nthreads=2, keep_canvas=True)
    np.testing.assert_array_equal(st.labels, res.labels)
    np.testing.assert_allclose(st.heatmap, res.heatmap, atol=1e-5)
    np.testing.assert_array_equal(st.canvas, res.canvas)


def test_streamed_native_read_tiles(cfg, engine, tmp_path):
    """Streamed mode through NativeSlide.read_tiles (the C++ threaded
    reader) equals the resident route on the same pyramid."""
    from wsiseg_tpu_torch.slides.native import NativeSlide, \
        write_raw_pyramid

    syn = SyntheticSlide(width=2048, height=1536, num_levels=3, seed=2)
    pth = str(tmp_path / "s.wsiraw")
    write_raw_pyramid(pth, [syn.read_level(k) for k in range(3)])
    nslide = NativeSlide(pth)
    plan_syn = plan_slide("a", syn, cfg)
    plan_nat = plan_slide("b", nslide, cfg)
    assert len(plan_nat.grid) == len(plan_syn.grid)
    res_nat = engine.predict_slide_streamed(plan_nat, nthreads=4)
    res_syn = engine.predict_slide(plan_syn)
    np.testing.assert_array_equal(res_nat.labels, res_syn.labels)
    np.testing.assert_allclose(res_nat.heatmap, res_syn.heatmap, atol=1e-5)


def test_streamed_evaluator_branch(cfg, engine, slide):
    coll = SlideCollection([("s", slide)], cfg)
    (name, plan, res), = list(_pipelined_results(engine, coll,
                                                 streamed=True))
    np.testing.assert_array_equal(res.labels,
                                  engine.predict_slide(plan).labels)
    with pytest.raises(ValueError, match="exclusive"):
        list(_pipelined_results(engine, coll, fcn=True, streamed=True))


# ---- banded == chunked ----

def test_banded_matches_chunked(cfg, engine, slide):
    """Same windows, same 255 frame → labels, heat and canvas equal the
    chunked route exactly. chunk=32, halo=16 at level dims 128×96 → 3
    bands of 4 chunks (64-px windows), the last band short."""
    plan = plan_slide("band", slide, cfg)
    res_b = engine.predict_slide_fcn_banded(plan, chunk=32, halo=16,
                                            keep_canvas=True,
                                            keep_probs=True)
    res_c = engine.predict_slide_fcn(plan, chunk=32, halo=16,
                                     keep_canvas=True, keep_probs=True)
    np.testing.assert_array_equal(res_b.labels, res_c.labels)
    np.testing.assert_array_equal(res_b.heatmap, res_c.heatmap)
    np.testing.assert_array_equal(res_b.canvas, res_c.canvas)
    np.testing.assert_array_equal(res_b.probs, res_c.probs)


def test_banded_bounded_reads(cfg, engine, slide):
    """The banded route reads at most one halo-padded band, and never the
    whole level."""
    plan = plan_slide("band", slide, cfg)
    spy = _SpySlide(plan.slide)
    engine.predict_slide_fcn_banded(dataclasses.replace(plan, slide=spy),
                                    chunk=32, halo=16)
    hs, ws = plan.stitch_hw
    assert spy.read_level_calls == 0
    assert 0 < spy.max_read_px <= (32 + 2 * 16) * ws
    assert spy.max_read_px < hs * ws


def test_oversize_autoroutes_to_banded(cfg, model, slide):
    """predict_slide_fcn on a slide over fcn_fast_max_px, nothing staged,
    takes the banded route (no whole-level read) and equals the explicit
    banded call."""
    eng = DenseInferenceEngine(model, cfg, device="cpu")
    eng.fcn_fast_max_px = 1000
    plan = plan_slide("band", slide, cfg)
    spy = _SpySlide(plan.slide)
    res = eng.predict_slide_fcn(dataclasses.replace(plan, slide=spy))
    assert spy.read_level_calls == 0
    ref = eng.predict_slide_fcn_banded(plan)
    np.testing.assert_array_equal(res.labels, ref.labels)
    np.testing.assert_array_equal(res.heatmap, ref.heatmap)


def test_evaluator_oversize_uses_banded(cfg, model, slide, tmp_path):
    """The FCN branch stages no oversize slide (it runs banded, one band
    at a time); read_level(2) is the overlay's only whole-level read."""
    cfg2 = cfg.replace(val_save_pth=str(tmp_path))
    eng = DenseInferenceEngine(model, cfg2, device="cpu")
    eng.fcn_fast_max_px = 1000
    spy = _SpySlide(slide)
    coll = SlideCollection([("s", spy)], cfg2, mask_cache_dir=None)
    n_plan_reads = spy.read_level_calls
    res = predict_tumorbed(eng, coll, ep=0, fcn=True, log=lambda s: None)
    assert "s" in res
    assert spy.read_level_calls == n_plan_reads + 1     # the overlay
    hs, ws = coll.plans["s"].stitch_hw
    assert spy.max_read_px <= (4096 + 2 * 128) * ws


# ---- the fused route's cap ----

def test_fcn_fast_max_px_arithmetic():
    """The cap is the device budget over the worst family's peak bytes
    per padded pixel times the CLI's default slides in flight."""
    assert engine_mod.FCN_FAST_MAX_PX == int(
        engine_mod.FCN_DEVICE_BUDGET
        // (engine_mod.FCN_PEAK_BYTES_PER_PX * engine_mod.FCN_GROUP_SLIDES))
    bench = 3072 * 4096
    assert bench < engine_mod.FCN_FAST_MAX_PX
    assert bench * engine_mod.FCN_PEAK_BYTES_PER_PX \
        * engine_mod.FCN_GROUP_SLIDES < engine_mod.FCN_DEVICE_BUDGET


def test_cap_routes_at_and_over(cfg, model, monkeypatch):
    """A slide padded exactly to the cap takes the fused route; one padded
    a row block (32 rows) over it takes the banded route."""
    eng = DenseInferenceEngine(model, cfg, device="cpu")
    at = plan_slide("at", SyntheticSlide(width=2048, height=1536,
                                         num_levels=3, seed=4), cfg)
    over = plan_slide("over", SyntheticSlide(width=2048, height=1536 + 128,
                                             num_levels=3, seed=4), cfg)
    hp, wp = eng._fcn_fast_dims(*at.stitch_hw)
    assert eng._fcn_fast_dims(*over.stitch_hw) == (hp + 32, wp)
    eng.fcn_fast_max_px = hp * wp
    routes = []
    monkeypatch.setattr(eng, "predict_slide_fcn_banded",
                        lambda plan, **kw: routes.append("banded"))
    monkeypatch.setattr(eng, "_predict_fcn_fast",
                        lambda plan, *a, **kw: routes.append("fused"))
    eng.predict_slide_fcn(at)
    eng.predict_slide_fcn(over)
    assert routes == ["fused", "banded"]


def test_group_fallback_equals_per_slide(cfg, engine):
    """predict_slides_fcn serves a group it cannot batch (mixed padded
    dims) slide by slide, with the per-slide results."""
    plans = [plan_slide(f"s{k}", SyntheticSlide(
        width=2048, height=1536 + 128 * k, num_levels=3, seed=40 + k), cfg)
        for k in range(2)]
    group = engine.predict_slides_fcn(plans)
    for p, g in zip(plans, group):
        one = engine.predict_slide_fcn(p)
        assert g.name == p.name
        np.testing.assert_array_equal(g.labels, one.labels)
        np.testing.assert_array_equal(g.heatmap, one.heatmap)
