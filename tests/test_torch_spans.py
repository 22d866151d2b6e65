"""The port's ``record_function`` ranges, recorded on the CPU by the
benchmark's own recorder (``portbench.harness.spans.Spans.annotations``):
planning, the staged FCN pipeline and the engine's ``_serve`` over a
folder of two slides served as one group, and ``Trainer.run`` over one
epoch of two steps. Each range is counted where it opens, on the thread
that opens it, nested where it belongs; recording changes no result."""

import threading

import numpy as np
import pytest
import torch

from portbench.harness.spans import Spans
from wsiseg_tpu_torch.config import default_config
from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection
from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
from wsiseg_tpu_torch.infer.evaluators import _pipelined_results
from wsiseg_tpu_torch.models.ynet import build_ynet
from wsiseg_tpu_torch.slides.reader import SyntheticSlide
from wsiseg_tpu_torch.train.loop import Trainer
from wsiseg_tpu_torch.train.state import TrainState

torch.set_num_threads(2)

PLAN = ("plan.slide", "plan.mask", "plan.filter")
SERVE = ("engine.inputs", "engine.launch", "engine.d2h", "engine.sync",
         "engine.tail")


def _recs(spans, name):
    return spans.records.get(f"program:{name}", [])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(spans, consumer thread, results recorded, results unrecorded) of
    a two-slide folder through ``_pipelined_results(fcn=True)`` in groups
    of two."""
    cfg = default_config(tile_w=64, tile_h=64, tile_stride_w=32,
                         tile_stride_h=32, compute_dtype="float32",
                         wsi_mask_pth="")
    torch.manual_seed(0)
    engine = DenseInferenceEngine(build_ynet(cfg), cfg, device="cpu")
    engine.slides_in_flight = 2
    slides = [(f"s{k}", SyntheticSlide(width=2048, height=1536,
                                       num_levels=3, seed=40 + k))
              for k in range(2)]
    masks = str(tmp_path_factory.mktemp("masks"))

    def serve(coll):
        return [(name, res.labels, res.heatmap)
                for name, _, res in _pipelined_results(engine, coll,
                                                       fcn=True)]

    spans = Spans()
    with spans.annotations():
        coll = SlideCollection(slides, cfg, mask_cache_dir=masks)
        recorded = serve(coll)
    return spans, threading.get_ident(), recorded, serve(coll)


@pytest.mark.parametrize("check", ["plan_once_a_slide",
                                   "serve_nested_in_order",
                                   "launch_holds_forward_then_postprocess",
                                   "stage_on_the_worker",
                                   "stage_wait_once_a_group"])
def test_pipeline_ranges(served, check):
    spans, consumer, _, _ = served
    if check == "plan_once_a_slide":
        for name in PLAN:
            assert len(_recs(spans, name)) == 2, name
        for (s, e, th), (ms, me, _), (fs, fe, _) in zip(
                _recs(spans, "plan.slide"), _recs(spans, "plan.mask"),
                _recs(spans, "plan.filter")):
            assert th == consumer and s <= ms < me <= fs < fe <= e
    elif check == "serve_nested_in_order":
        (s, e, th), = _recs(spans, "engine.serve")
        assert th == consumer
        t = s
        for name in SERVE:
            (cs, ce, cth), = _recs(spans, name)
            assert cth == consumer and t <= cs <= ce <= e, name
            t = ce
    elif check == "launch_holds_forward_then_postprocess":
        (s, e, _), = _recs(spans, "engine.launch")
        (fs, fe, _), = _recs(spans, "engine.forward")
        (ps, pe, _), = _recs(spans, "engine.postprocess")
        assert s <= fs < fe <= ps < pe <= e
    elif check == "stage_on_the_worker":
        recs = _recs(spans, "engine.stage")
        assert len(recs) == 2
        assert all(th != consumer for _, _, th in recs)
    else:
        (s, e, th), = _recs(spans, "pipeline.stage_wait")
        assert th == consumer
        (serve_s, _, _), = _recs(spans, "engine.serve")
        assert e <= serve_s


def test_recording_changes_no_result(served):
    _, _, recorded, plain = served
    assert [n for n, _, _ in recorded] == ["s0", "s1"]
    for (n, lab, heat), (n2, lab2, heat2) in zip(recorded, plain):
        assert n == n2
        np.testing.assert_array_equal(lab, lab2)
        np.testing.assert_array_equal(heat, heat2)


@pytest.fixture(scope="module")
def trained():
    """Spans of ``Trainer.run`` over one epoch of two steps on the CPU,
    and the consumer's thread."""
    cfg = default_config(seed=3, save_models=0, validate_model=0,
                         prefetch_depth=2)
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 2)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))

    def step(st, batch, gen):
        st.optimizer.zero_grad()
        loss = st.model(batch["x"]).square().mean()
        loss.backward()
        st.optimizer.step()
        return {"loss": loss.detach()}

    def batches():
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        return iter([{"x": x}, {"x": -x}])

    trainer = Trainer(cfg, state, step, make_batches=batches,
                      log_fn=lambda s: None)
    spans = Spans()
    with spans.annotations():
        trainer.run(start_epoch=1, num_epochs=1)
    assert trainer.history[0]["patches_per_sec"] > 0
    return spans, threading.get_ident()


@pytest.mark.parametrize("names,count", [
    (("train.prepare", "train.step"), 2),
    (("train.fetch",), 1),
    (("loader.wait",), 3),
    (("loader.close",), 1),
    (("loader.copy",), 2),
])
def test_trainer_ranges(trained, names, count):
    """Two steps: each step prepared and run once, one metric fetch; the
    consumer waits three times (the last wait ends the iterator) and
    closes once; the worker stages each batch."""
    spans, consumer = trained
    for name in names:
        recs = _recs(spans, name)
        assert len(recs) == count, name
        on_worker = name == "loader.copy"
        assert all((th != consumer) == on_worker for _, _, th in recs)


def test_same_range_on_two_threads():
    """Two threads inside a range of one name at once: each span keeps
    its own start and end (a fresh instance at every use)."""
    spans = Spans()
    inside = threading.Barrier(2, timeout=10)

    def work():
        with torch.profiler.record_function("pair.work"):
            inside.wait()

    with spans.annotations():
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    recs = _recs(spans, "pair.work")
    assert len(recs) == 2
    assert len({th for _, _, th in recs}) == 2
    assert len({s for s, _, _ in recs}) == 2
    assert all(s < e for s, e, _ in recs)
    assert max(s for s, _, _ in recs) < min(e for _, e, _ in recs)
