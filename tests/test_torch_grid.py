"""The port's grid, cls, chunked-FCN and keep_probs/keep_canvas routes
(wsiseg_tpu_torch: ops/stitch, ops/threshold, ops/resize, YNet.encode and
classify, decode_fast, DenseInferenceEngine) against the JAX package on
the same weights (flax variables carried across by ``from_flax``) and the
same slides, both sides in f32 where the JAX route has an f32 mode; and
the grid route against the numpy port of the reference stitch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from wsiseg_tpu.config import default_config
from wsiseg_tpu.data.wsi_tiles import plan_slide as jax_plan_slide
from wsiseg_tpu.infer.engine import DenseInferenceEngine as JaxEngine
from wsiseg_tpu.models.fast_decoder import \
    unet_segment_fast as jax_unet_segment_fast
from wsiseg_tpu.models.ynet import YNet as FlaxYNet
from wsiseg_tpu.models.ynet import init_ynet as flax_init_ynet
from wsiseg_tpu.ops import resize as jax_resize
from wsiseg_tpu.ops import stitch as jax_stitch
from wsiseg_tpu.ops import threshold as jax_threshold
from wsiseg_tpu.ops.color import normalize as jax_normalize
from wsiseg_tpu.slides import SyntheticSlide
from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection, plan_slide
from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
from wsiseg_tpu_torch.infer.evaluators import _pipelined_results
from wsiseg_tpu_torch.models.fast_decoder import prepare_decode_fast, \
    unet_segment_fast
from wsiseg_tpu_torch.models.flax_import import from_flax
from wsiseg_tpu_torch.models.ynet import build_ynet, compute_copy, init_ynet
from wsiseg_tpu_torch.ops import resize, stitch, threshold

torch.set_num_threads(2)

TILE, STRIDE = 64, 32
FLOORS = (0.1, 0.3, 0.2, 0.25)


def _base_cfg(**kw):
    return default_config(tile_w=TILE, tile_h=TILE, tile_stride_w=STRIDE,
                          tile_stride_h=STRIDE, compute_dtype="float32",
                          infer_batch_size=8, wsi_mask_pth="", **kw)


@pytest.fixture(scope="module")
def cfg():
    return _base_cfg()


@pytest.fixture(scope="module")
def flax_pair(cfg):
    return flax_init_ynet(cfg, jax.random.PRNGKey(0), tile_hw=(TILE, TILE))


def _port(cfg, variables):
    m = build_ynet(cfg)
    m.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray,
                                                       dict(variables))))
    return m.eval()


@pytest.fixture(scope="module")
def port_model(cfg, flax_pair):
    return _port(cfg, flax_pair[1])


@pytest.fixture(scope="module")
def slide():
    return SyntheticSlide(width=2048, height=1536, num_levels=3, seed=5)


def _agree(res, ref, canvas=True):
    """The satellite's limits: canvas within 1e-3·max|canvas|, labels
    ≥ 99.9 % equal, heat within 1/255 on ≥ 99.9 %."""
    assert res.labels.shape == ref.labels.shape
    assert (res.labels == np.asarray(ref.labels)).mean() >= 0.999
    assert (np.abs(res.heatmap - np.asarray(ref.heatmap))
            <= 1 / 255 + 1e-6).mean() >= 0.999
    if canvas:
        ref_c = np.asarray(ref.canvas)
        assert res.canvas.shape == ref_c.shape
        np.testing.assert_allclose(res.canvas, ref_c, rtol=0,
                                   atol=1e-3 * np.abs(ref_c).max())
        np.testing.assert_allclose(res.probs, np.asarray(ref.probs),
                                   rtol=0, atol=1e-3)


# ---- ops ----

def test_gather_and_scatter_match_jax():
    r = np.random.RandomState(0)
    img = r.randint(0, 256, (40, 52, 3)).astype(np.uint8)
    ys = np.array([0, 5, 24, 30, 3], np.int32)     # 30 clamps to 24
    xs = np.array([0, 7, 36, 2, 40], np.int32)     # 40 clamps to 36
    got = stitch.gather_tiles(torch.from_numpy(img), ys, xs, 16, 16)
    ref = jax_stitch.gather_tiles(jnp.asarray(img), jnp.asarray(ys),
                                  jnp.asarray(xs), 16, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    canvas = r.randn(40, 52, 4).astype(np.float32)
    tiles = r.randn(5, 16, 16, 4).astype(np.float32)
    got = stitch.scatter_add_tiles(torch.from_numpy(canvas.copy()),
                                   torch.from_numpy(tiles), ys, xs)
    ref = jax_stitch.scatter_add_tiles(jnp.asarray(canvas),
                                       jnp.asarray(tiles), jnp.asarray(ys),
                                       jnp.asarray(xs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    vals = r.randn(5, 4).astype(np.float32)
    got = stitch.scatter_add_scalar_tiles(torch.from_numpy(canvas.copy()),
                                          torch.from_numpy(vals), ys, xs,
                                          16, 16)
    ref = jax_stitch.scatter_add_scalar_tiles(
        jnp.asarray(canvas), jnp.asarray(vals), jnp.asarray(ys),
        jnp.asarray(xs), 16, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got = stitch.overlap_count((40, 52), ys, xs, 16, 16)
    ref = jax_stitch.overlap_count((40, 52), jnp.asarray(ys),
                                   jnp.asarray(xs), 16, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_scatter_writes_through_a_planar_view():
    """The engine may keep another layout and pass a permuted view."""
    r = np.random.RandomState(1)
    planar = torch.zeros(4, 20, 24)
    tiles = torch.from_numpy(r.randn(3, 8, 8, 4).astype(np.float32))
    stitch.scatter_add_tiles(planar.permute(1, 2, 0), tiles, [0, 4, 12],
                             [0, 8, 16])
    ref = stitch.scatter_add_tiles(torch.zeros(20, 24, 4), tiles,
                                   [0, 4, 12], [0, 8, 16])
    np.testing.assert_array_equal(planar.permute(1, 2, 0).numpy(),
                                  ref.numpy())


@pytest.mark.parametrize("planar", [False, True])
def test_threshold_matches_jax(planar):
    logits = (np.random.RandomState(2).randn(24, 32, 4) * 3).astype(
        np.float32)
    fn = "threshold_probs_planar" if planar else "threshold_probs"
    lab, pr = getattr(threshold, fn)(torch.from_numpy(logits), FLOORS)
    jl, jp = getattr(jax_threshold, fn)(jnp.asarray(logits), FLOORS)
    assert lab.dtype == torch.uint8
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jl))
    np.testing.assert_allclose(pr.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-6)


def test_pred_to_mask_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        threshold.pred_to_mask(torch.zeros(4, 4, dtype=torch.uint8), 4)


@pytest.mark.parametrize("shape,out", [((2, 40, 52, 3), (20, 26)),
                                       ((40, 52, 4), (17, 90)),
                                       ((33, 47), (64, 12))])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_resize_matches_jax(shape, out, dtype):
    r = np.random.RandomState(3)
    x = (r.rand(*shape) * 255).astype(dtype)
    got = resize.resize_bilinear(torch.from_numpy(x), *out)
    ref = np.asarray(jax_resize.resize_bilinear(jnp.asarray(x), *out))
    assert got.dtype == torch.from_numpy(x).dtype
    if dtype == np.uint8:   # rounding of values within 1e-6 of .5 may flip
        assert np.abs(got.numpy().astype(int) - ref.astype(int)).max() <= 1
        assert (got.numpy() == ref).mean() >= 0.999
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3)
    lab = r.randint(0, 4, shape).astype(np.uint8)
    np.testing.assert_array_equal(
        resize.resize_nearest(torch.from_numpy(lab), *out).numpy(),
        np.asarray(jax_resize.resize_nearest(jnp.asarray(lab), *out)))


# ---- models ----

def test_encode_classify_and_decode_fast_match_jax(cfg, flax_pair,
                                                   port_model):
    """YNet.encode / classify and unet_segment_fast (encoder + decode_fast,
    the s2d(2) block4 tail) of the f32 compute copy against the flax
    model's ``encode``, ``classify`` and JAX ``unet_segment_fast``."""
    model, variables = flax_pair
    x = np.random.RandomState(4).randn(2, TILE, TILE, 3).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    net = compute_copy(port_model, torch.float32)
    feats = net.encode(xt)
    jfeats = model.apply(variables, jnp.asarray(x), method=FlaxYNet.encode)
    for f, jf in zip(feats, jfeats):
        jf = np.asarray(jf).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(f.numpy(), jf, rtol=0,
                                   atol=1e-4 * np.abs(jf).max())
    cls = net.classify(xt).numpy()
    jcls = np.asarray(model.apply(variables, jnp.asarray(x),
                                  method=FlaxYNet.classify))
    np.testing.assert_allclose(cls, jcls, rtol=0,
                               atol=1e-4 * np.abs(jcls).max())
    prep = prepare_decode_fast(port_model, torch.float32)
    seg = unet_segment_fast(net, prep, xt, torch.float32).numpy()
    jseg = np.asarray(jax_unet_segment_fast(model, variables,
                                            jnp.asarray(x)))
    assert seg.shape == (2, 4, TILE, TILE)
    np.testing.assert_allclose(seg.transpose(0, 2, 3, 1), jseg, rtol=0,
                               atol=1e-4 * np.abs(jseg).max())
    with torch.no_grad():
        plain = port_model.segment(xt).numpy()
    np.testing.assert_allclose(seg, plain, rtol=0,
                               atol=1e-4 * np.abs(plain).max())


# ---- grid, cls, scan levels, chunked FCN ----

@pytest.mark.parametrize("mode", ["seg", "cls"])
def test_predict_slide_matches_jax(cfg, flax_pair, port_model, slide, mode):
    cfg_f = cfg.replace(class_probs=FLOORS)
    jeng = JaxEngine(flax_pair[0], flax_pair[1], cfg_f, mode=mode)
    eng = DenseInferenceEngine(port_model, cfg_f, mode=mode, device="cpu")
    plan = plan_slide("s", slide, cfg_f)
    assert len(plan.grid) > 4
    ref = jeng.predict_slide(jax_plan_slide("s", slide, cfg_f,
                                            mask_cache_dir=None),
                             keep_canvas=True, keep_probs=True)
    res = eng.predict_slide(plan, keep_canvas=True, keep_probs=True)
    assert res.canvas.shape == plan.stitch_hw + (4,)
    assert res.probs.shape == plan.canvas_hw + (4,)
    _agree(res, ref)


@pytest.mark.parametrize("kw", [{"scan_level": 1}, {"scan_resize": 2}])
def test_scan_level_and_resize_match_jax(flax_pair, port_model, slide, kw):
    """scan_level 1: tiles at level 1, the canvas resized to level 2 by
    the antialiased linear resize; scan_resize 2: each tile shrunk before
    the net and its logits enlarged after."""
    cfg = _base_cfg(**kw)
    jeng = JaxEngine(flax_pair[0], flax_pair[1], cfg)
    eng = DenseInferenceEngine(port_model, cfg, device="cpu")
    plan = plan_slide("s", slide, cfg)
    ref = jeng.predict_slide(jax_plan_slide("s", slide, cfg,
                                            mask_cache_dir=None),
                             keep_canvas=True, keep_probs=True)
    res = eng.predict_slide(plan, keep_canvas=True, keep_probs=True)
    assert res.labels.shape == plan.canvas_hw
    assert res.canvas.shape[:2] == plan.stitch_hw
    _agree(res, ref)


@pytest.mark.parametrize("mode,chunk", [("seg", 64), ("seg", (32, 96)),
                                        ("cls", None)])
def test_chunked_fcn_matches_jax(cfg, flax_pair, port_model, slide, mode,
                                 chunk):
    """Halo-padded chunks through the tile forward. In cls mode the fused
    route does not serve, and predict_slide_fcn runs the segmentation net
    over one chunk, as JAX does."""
    jeng = JaxEngine(flax_pair[0], flax_pair[1], cfg, mode=mode)
    eng = DenseInferenceEngine(port_model, cfg, mode=mode, device="cpu")
    assert eng._fcn_fast_ok() == (mode == "seg")
    kw = dict(chunk=chunk, halo=16, keep_canvas=True, keep_probs=True)
    ref = jeng.predict_slide_fcn(jax_plan_slide("s", slide, cfg,
                                                mask_cache_dir=None), **kw)
    res = eng.predict_slide_fcn(plan_slide("s", slide, cfg), **kw)
    _agree(res, ref)


def test_scan_level1_fcn_canvas_branch_matches_jax(flax_pair, port_model,
                                                   slide):
    """scan_level 1 on the fused route: not planar, so the whole-image
    logits are resized to level 2 in _postprocess (JAX's canvas branch of
    _predict_fcn_fast). bf16 on both sides (the JAX fused route has no f32
    mode), where the resize averages the rounding away."""
    cfg = _base_cfg(scan_level=1)
    jeng = JaxEngine(flax_pair[0], flax_pair[1], cfg)
    jeng.fcn_fast_interpret = True
    eng = DenseInferenceEngine(port_model, cfg, device="cpu")
    plan = plan_slide("s", slide, cfg)
    assert not eng._fcn_planar_ok(plan) and eng._fcn_fast_fits(plan)
    ref = jeng.predict_slide_fcn(jax_plan_slide("s", slide, cfg,
                                                mask_cache_dir=None))
    res = eng.predict_slide_fcn(plan)
    _agree(res, ref, canvas=False)


# ---- keep_probs / keep_canvas on the fused route ----

@pytest.fixture(scope="module")
def fused_slide():
    return SyntheticSlide(width=4096, height=3072, num_levels=3, seed=11)


def _fused_engine(model, cfg, fold, dtype):
    eng = DenseInferenceEngine(model, cfg, device="cpu", dtype=dtype)
    eng.fcn_fold = fold
    return eng


def _fpn_pair(cfg):
    from test_torch_families import _pair
    model, variables, port = _pair("FPN", "resnet18")
    return model, variables, port


@pytest.mark.parametrize("route", ["default", "FPN"])
def test_fused_keep_matches_jax_f32_model(cfg, flax_pair, port_model,
                                          fused_slide, route):
    """keep_canvas/keep_probs on the fused route, the port's engine in f32
    (stem, encoder and decoder: the kernels' plain versions), against the
    flax f32 Y-Net on the normalized 255-padded level image, postprocessed
    by the JAX engine as its route does: Unet's head planes by
    ``_postprocess_s2d`` (tissue mask at 1/4 resolution), FPN's native
    logits by ``_postprocess`` through the canvas branch. The fused route
    computes that model exactly, up to the stem's pad value
    round(255·mean) (within 0.5/255/std of normalized zero), so the
    comparison is 16 px inside the border. (The fold route keeps bf16
    between its layers, as JAX's: it is held against the JAX engine
    below.)"""
    from wsiseg_tpu.models.fast_decoder import space_to_depth
    if route == "FPN":
        model, variables, port = _fpn_pair(cfg)
    else:
        (model, variables), port = flax_pair, port_model
    eng = _fused_engine(port, cfg, False, torch.float32)
    plan = plan_slide("syn", fused_slide, cfg)
    assert eng._fcn_planar_ok(plan) and eng._fcn_fast_fits(plan)
    res = eng.predict_slide_fcn(plan, keep_canvas=True, keep_probs=True)
    hs, ws = plan.stitch_hw
    img = eng._read_padded_level(plan)
    x = jax_normalize(jnp.asarray(img, jnp.float32)[None] / 255.0,
                      cfg.dataset_mean, cfg.dataset_std)
    full = model.apply(variables, x, method=FlaxYNet.segment)
    truth = np.asarray(full)[0][:hs, :ws]
    jeng = JaxEngine(model, variables, cfg)
    mask = JaxEngine._resize_mask_to(plan.mask, (hs, ws))
    labels, probs, heat = jeng._postprocess(jnp.asarray(truth),
                                            jnp.asarray(mask))
    heat = np.asarray(heat)
    if route == "default":
        jplan = jax_plan_slide("syn", fused_slide, cfg, mask_cache_dir=None)
        y_s = space_to_depth(full, 4)[0]
        lab4, heat4, _ = jeng._postprocess_s2d(
            y_s, jeng._half_mask(jplan, y_s.shape[:2]))
        heat = jeng._interleave4(np.asarray(heat4), hs, ws)
        np.testing.assert_array_equal(
            jeng._interleave4(np.asarray(lab4), hs, ws), np.asarray(labels))
    assert res.canvas.shape == res.probs.shape == (hs, ws, 4)
    c = np.s_[16:-16, 16:-16]
    tol = 1e-3 * np.abs(truth).max()
    np.testing.assert_allclose(res.canvas[c], truth[c], rtol=0, atol=tol)
    assert (res.labels[c] == np.asarray(labels)[c]).mean() >= 0.999
    assert (np.abs(res.heatmap[c] - heat[c].astype(np.float32) / 255.0)
            <= 1 / 255 + 1e-6).mean() >= 0.999
    # softmax moves no probability by more than its largest logit change;
    # a probability at its class floor may flip to 0
    assert (np.abs(res.probs[c] - np.asarray(probs)[c]) <= tol).mean() \
        >= 0.999


@pytest.mark.parametrize("route", ["default", "fold", "FPN"])
def test_fused_keep_matches_jax_engine(cfg, flax_pair, port_model,
                                       fused_slide, route):
    """keep_canvas/keep_probs on the fused route against the JAX engine's
    (Pallas kernels in interpret mode), bf16 on both sides: the JAX fused
    route is bf16 only. Held to the bf16 limits the engine tests of these
    routes use (tests/test_torch_engine.py, test_torch_families_engine.py):
    canvas within 2^-5·max|canvas| (8 bf16 ulps), labels ≥ 99.8 % (fold,
    FPN: 99 %), heat within 2/255 on ≥ 99 % (FPN: 97 %). The keep route's
    labels equal the serving route's exactly, and so does its heat on the
    planar head (FPN's canvas branch masks the heat at full resolution,
    the served planes at 1/4, as in JAX)."""
    if route == "FPN":
        model, variables, port = _fpn_pair(cfg)
    else:
        (model, variables), port = flax_pair, port_model
    eng = _fused_engine(port, cfg, route == "fold", torch.bfloat16)
    jeng = JaxEngine(model, variables, cfg)
    jeng.fcn_fast_interpret = True
    jeng.fcn_fold = route == "fold"
    plan = plan_slide("syn", fused_slide, cfg)
    ref = jeng.predict_slide_fcn(jax_plan_slide("syn", fused_slide, cfg,
                                                mask_cache_dir=None),
                                 keep_canvas=True, keep_probs=True)
    res = eng.predict_slide_fcn(plan, keep_canvas=True, keep_probs=True)
    served = eng.predict_slide_fcn(plan)
    np.testing.assert_array_equal(res.labels, served.labels)
    if route != "FPN":
        np.testing.assert_array_equal(res.heatmap, served.heatmap)
    ref_c = np.asarray(ref.canvas)
    assert res.canvas.shape == ref_c.shape == plan.stitch_hw + (4,)
    np.testing.assert_allclose(res.canvas, ref_c, rtol=0,
                               atol=2 ** -5 * np.abs(ref_c).max())
    assert (res.labels == ref.labels).mean() >= (
        0.998 if route == "default" else 0.99)
    assert (np.abs(res.heatmap - ref.heatmap) <= 2 / 255 + 1e-6).mean() \
        >= (0.97 if route == "FPN" else 0.99)
    assert res.probs.shape == np.asarray(ref.probs).shape


# ---- the reference stitch ----

def _reference_oracle(cfg, tm, plan, mask_full):
    """Verbatim numpy port of the reference seg eval path on this plan's
    grid (copied from tests/test_artifact_parity.py; ``tm`` here is the
    port's own f32 Y-Net, whose ``segment`` gives the tile logits)."""
    hs, ws = plan.stitch_hw
    level = np.asarray(plan.slide.read_level(cfg.scan_level))
    C = cfg.num_classes
    # utils/eval.py:183-214 — planar f32 canvas, logits overlap-added
    pred = np.zeros((C, hs, ws), np.float64)
    mean = np.asarray(cfg.dataset_mean, np.float32)
    std = np.asarray(cfg.dataset_std, np.float32)
    dy, dx = cfg.tile_h, cfg.tile_w
    with torch.no_grad():
        for y, x in zip(plan.grid.ys, plan.grid.xs):
            tile = level[y:y + dy, x:x + dx].astype(np.float32) / 255.0
            tile = (tile - mean) / std
            seg = tm.segment(torch.from_numpy(
                tile.transpose(2, 0, 1)[None]))
            pred[:, y:y + dy, x:x + dx] += seg.numpy()[0]
    # utils/preprocessing.py:156-172 threshold_probs
    e = np.exp(pred - pred.max(axis=0, keepdims=True))
    probs = e / e.sum(axis=0, keepdims=True)
    for cj in range(C):
        probs[cj, probs[cj] < cfg.class_probs[cj]] = 0
    labels = np.argmax(probs, axis=0).astype(np.uint8)
    # utils/eval.py:217-229 — seg-mode heatmap, tissue-masked, u8 TRUNCATED
    heat = (probs[2] + probs[3]) * (mask_full > 0)
    heat_u8 = np.uint8(255 * heat)
    return pred, labels, heat_u8


def test_grid_matches_reference_stitch(cfg, slide):
    """The port's grid route (compute copy + decode_fast, sequential
    adds) against the numpy reference stitch of the plain f32 Y-Net, with
    random BN statistics. Canvas within 1e-3·max; labels equal away from
    decision boundaries; heat within one u8 step there (the engine rounds
    where the reference truncates); tumor-bed IoU ≈ 1 (the checks of
    tests/test_artifact_parity.py)."""
    tm = init_ynet(cfg, torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for mod in tm.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.3, generator=g)
                mod.running_var.uniform_(0.5, 1.5, generator=g)
    eng = DenseInferenceEngine(tm, cfg, device="cpu")
    plan = plan_slide("parity", slide, cfg)
    hs, ws = plan.stitch_hw
    mask_full = eng._resize_mask_to(plan.mask, (hs, ws))
    res = eng.predict_slide(plan, keep_canvas=True)
    pred, labels, heat_u8 = _reference_oracle(cfg, tm, plan, mask_full)
    canvas = res.canvas.transpose(2, 0, 1)
    assert np.abs(canvas - pred).max() <= 1e-3 * np.abs(pred).max()
    e = np.exp(pred - pred.max(axis=0, keepdims=True))
    probs = e / e.sum(axis=0, keepdims=True)
    top2 = np.sort(probs, axis=0)[-2:]
    decided = (top2[1] - top2[0]) > 1e-2
    assert decided.mean() > 0.5, "degenerate fixture: no decided pixels"
    np.testing.assert_array_equal(res.labels[decided], labels[decided])
    assert (res.labels != labels).mean() < 0.01
    eng_u8 = np.round(res.heatmap * 255).astype(np.int32)
    assert np.abs(eng_u8 - heat_u8.astype(np.int32))[decided].max() <= 1
    tb_e, tb_o = res.labels > 0, labels > 0
    assert (tb_e & tb_o).sum() / (tb_e | tb_o).sum() > 0.995


# ---- device_throughput, evaluator, CLI ----

def test_device_throughput_modes(cfg, port_model, slide):
    """grid, fcn with a chunk and fcn_raw run on the CPU; slides_in_flight
    > 1 is refused off the fused planar route, as in JAX."""
    eng = DenseInferenceEngine(port_model, cfg, device="cpu")
    plan = plan_slide("s", slide, cfg)
    for kw in ({"mode": "grid"}, {"mode": "fcn", "chunk": 64},
               {"mode": "fcn_raw"}):
        tp = eng.device_throughput(plan, iters=1, **kw)
        assert tp["sec_per_slide"] > 0 and tp["patches_per_sec"] > 0
    with pytest.raises(ValueError, match="slides_in_flight"):
        eng.device_throughput(plan, mode="grid", iters=1,
                              slides_in_flight=2)
    cls = DenseInferenceEngine(port_model, cfg, mode="cls", device="cpu")
    with pytest.raises(ValueError, match="fcn_raw"):
        cls.device_throughput(plan, mode="fcn_raw", iters=1)


def test_grid_evaluator_stages_next_slide(cfg, port_model):
    """_pipelined_results' grid branch (the evaluator's default, as in
    JAX) keeps each slide paired with its result and equals predict_slide."""
    slides = [(f"s{k}", SyntheticSlide(width=2048, height=1536,
                                       num_levels=3, seed=30 + k))
              for k in range(3)]
    coll = SlideCollection(slides, cfg)
    eng = DenseInferenceEngine(port_model, cfg, device="cpu")
    out = list(_pipelined_results(eng, coll))
    assert [name for name, _, _ in out] == ["s0", "s1", "s2"]
    for name, plan, res in out:
        assert res.name == name
        np.testing.assert_array_equal(res.labels,
                                      eng.predict_slide(plan).labels)
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        list(_pipelined_results(eng, coll, mesh=object()))


@pytest.mark.parametrize("flag", ["--grid", "--streamed"])
def test_cli_grid_and_streamed_write_heatmap(tmp_path, flag):
    from wsiseg_tpu_torch.__main__ import main
    slides = tmp_path / "slides"
    slides.mkdir()
    np.save(slides / "a.npy", SyntheticSlide(
        width=2048, height=1536, num_levels=1, seed=3).read_level(0))
    out = tmp_path / "out"
    res = main(["eval-tumorbed", flag, "--raw_val_pth", str(slides),
                "--eval_model_pth", str(tmp_path / "none"),
                "--val_save_pth", str(out), "--wsi_mask_pth", "",
                "--tile_w", "64", "--tile_h", "64", "--tile_stride_w", "32",
                "--tile_stride_h", "32", "--compute_dtype", "float32",
                "--device", "cpu"])
    assert sorted(res) == ["a.npy"] and res["a.npy"]["num_tiles"] > 0
    hm = np.asarray(Image.open(out / "0" / "a.npy_32_heatmap.png"))
    assert hm.shape == (96, 128)
    ov = np.asarray(Image.open(out / "0" / "a.npy_32_overlay.png"))
    assert ov.shape == (96, 128, 3)
