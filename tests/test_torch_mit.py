"""SegFormer's MiT-B5 encoder under the port's FPN (``models/mit.py``,
``ops/attention.py``), held on the CPU against the benchmark's plain
reference (``portbench/reference/segformer.py``): seeded random weights
at the published widths, one state dict loaded into both by name, small
images (96×128, not square, so every stage's map and its reduced keys
keep whole sides). The JAX package has no MiT, so the reference is the
oracle here.

Tolerances, both sides in float32 unless a test says otherwise: the two
models compute the same products and differ only in the order of their
float32 sums (the program's attention through SDPA's math backend
against the reference's explicit blocked product, the program's
channels_last views against NVlabs' reshapes), which read 7e-6 at
logits of |5| (about 2⁻¹⁷ relative); 1e-4 absolute and relative leaves
room for other thread counts and stays 100× under what one bf16 rounding
of the logits moves (2⁻⁸ relative)."""

import copy

import numpy as np
import pytest
import torch

from portbench.harness import slides as slide_gen
from portbench.harness.spans import Spans
from portbench.harness.weights import make_state
from portbench.reference import postprocess
from portbench.reference.infer import normalise, slide_probs
from portbench.reference.segformer import build as build_reference
from wsiseg_tpu_torch.config import default_config
from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection, plan_slide
from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
from wsiseg_tpu_torch.infer.evaluators import _pipelined_results
from wsiseg_tpu_torch.models.infer_fast import prepare_fast, \
    segment_from_image
from wsiseg_tpu_torch.models.mit import MiTEncoder
from wsiseg_tpu_torch.models.resnet import encoder_out_channels
from wsiseg_tpu_torch.models.ynet import YNet
from wsiseg_tpu_torch.ops import attention
from wsiseg_tpu_torch.parallel import comm
from wsiseg_tpu_torch.slides import VirtualPyramidSlide

torch.set_num_threads(2)

REF_CFG = {"model_name": "FPN", "arch_encoder": "mit_b5", "num_classes": 4,
           "class_probs": [0.0] * 4, "dataset_mean": [0.485, 0.456, 0.406],
           "dataset_std": [0.229, 0.224, 0.225]}
TOL = {"rtol": 1e-4, "atol": 1e-4}


@pytest.fixture(scope="module")
def pair():
    """(reference, program, state): one seeded state dict in both."""
    ref = build_reference(REF_CFG)
    state = make_state(ref, torch.Generator().manual_seed(19))
    ref.load_state_dict(state)
    prog = YNet("mit_b5", 4, 1, "FPN")
    prog.load_state_dict(state)
    return ref.eval(), prog.eval(), state


def _cfg(**kw):
    return default_config(model_name="FPN", arch_encoder="mit_b5",
                          tile_w=64, tile_h=64, tile_stride_w=32,
                          tile_stride_h=32, wsi_mask_pth="",
                          compute_dtype="float32", **kw)


def test_published_widths_and_names(pair):
    """smp's and NVlabs' parameter names, MiT-B5's 81.4 M encoder
    parameters (the paper's count), and the pyramid's channels."""
    _, prog, state = pair
    for key in ("encoder.patch_embed1.proj.weight",
                "encoder.block1.2.attn.sr.weight",
                "encoder.block3.39.attn.norm.weight",
                "encoder.block3.39.mlp.dwconv.dwconv.weight",
                "encoder.block4.2.attn.kv.bias", "encoder.norm4.weight"):
        assert key in state, key
    assert "encoder.block4.0.attn.sr.weight" not in state   # R = 1
    assert sum(p.numel() for p in prog.encoder.parameters()) == 81443008
    assert [len(getattr(prog.encoder, f"block{i}")) for i in range(1, 5)] \
        == [3, 6, 40, 3]
    assert state["encoder.patch_embed1.proj.weight"].shape == (64, 3, 7, 7)
    assert encoder_out_channels("mit_b5") == (512, 320, 128, 64, 0)
    cfg = default_config(model_name="FPN", arch_encoder="mit_b5")
    assert cfg.arch_encoder == "mit_b5"


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_equals_reference(pair, mode):
    """``segment`` and the three-head ``forward``, eval and train mode
    (the FPN's BatchNorm on the batch's statistics in train mode, on
    copies: train mode updates the running statistics, the program's as
    flax does)."""
    ref, prog = (copy.deepcopy(m) for m in pair[:2])
    getattr(ref, mode)()
    getattr(prog, mode)()
    x = torch.randn(2, 3, 96, 128, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(prog.segment(x), ref.segment(x), **TOL)
        a, b = prog(x), ref(x)
    for k in ("seg", "cls", "reg"):
        torch.testing.assert_close(a[k], b[k], **TOL)


def test_pyramid_shapes(pair):
    _, prog, _ = pair
    with torch.no_grad():
        feats = prog.encode(torch.zeros(1, 3, 96, 128))
    assert [tuple(f.shape[1:]) for f in feats] == [
        (512, 3, 4), (320, 6, 8), (128, 12, 16), (64, 24, 32), (0, 48, 64)]


def test_fused_route_equals_reference(pair):
    """The fused whole-image route's MiT branch (u8 in, normalised on the
    device) in float32 against the reference's forward of the normalised
    image; in bfloat16, within the logits' spread over 16 (one bf16
    rounding of each of 52 blocks' outputs stays well inside it)."""
    ref, prog, _ = pair
    img = np.random.RandomState(2).randint(0, 256, (96, 128, 3)) \
        .astype(np.uint8)
    with torch.no_grad():
        want = ref.segment(normalise(img, REF_CFG["dataset_mean"],
                                     REF_CFG["dataset_std"], "cpu"))
    fw = prepare_fast(prog, REF_CFG["dataset_mean"], REF_CFG["dataset_std"],
                      torch.float32)
    u8 = torch.from_numpy(img)[None]
    got = segment_from_image(fw, u8, planar_head=False)
    torch.testing.assert_close(got, want, **TOL)
    fw16 = prepare_fast(prog, REF_CFG["dataset_mean"],
                        REF_CFG["dataset_std"], torch.bfloat16)
    low = segment_from_image(fw16, u8, planar_head=False)
    assert low.dtype == torch.float32 and low.shape == want.shape
    spread = float(want.max() - want.min())
    assert float((low - want).abs().max()) < spread / 16


def _folder(n=2, h=128, w=256, seed=4):
    imgs = slide_gen.level2_images(n, h, w,
                                   torch.Generator().manual_seed(seed))
    return imgs, [(f"s{k}", VirtualPyramidSlide({2: imgs[k]}, num_levels=3))
                  for k in range(n)]


def test_pipelined_fused_route_equals_reference(pair, tmp_path):
    """Two slides through ``_pipelined_results(fcn=True)`` as one group of
    the fused route, f32, against the reference's labels and heat: heat
    within one u8 step (a value at a rounding boundary), no label the
    reference puts more than 1/255 below its best."""
    _pipelined_against_reference(pair, tmp_path, 128, 256)


def test_pipelined_unaligned_width_equals_reference(pair, tmp_path):
    """The same at 128×288, a width that is a multiple of 32 but not of
    256: the engine pads a MiT slide only to the FPN's multiples of 32,
    so no white column reaches the attention's keys and every pixel is
    the model's own whole-image output (a pad to 512 moves them all)."""
    _pipelined_against_reference(pair, tmp_path, 128, 288)


def test_mit_pads_to_multiples_of_32(pair):
    """A MiT engine pads both sides to multiples of 32; a ResNet engine
    still pads the width to the stem kernel's 256."""
    cfg = _cfg()
    eng = DenseInferenceEngine(pair[1], cfg, device="cpu",
                               dtype=torch.float32)
    assert eng._fcn_fast_dims(128, 288) == (128, 288)
    assert eng._fcn_fast_dims(100, 300) == (128, 320)
    res = DenseInferenceEngine(YNet("resnet18", 4, 1, "FPN"),
                               default_config(model_name="FPN"),
                               device="cpu", dtype=torch.float32)
    assert res._fcn_fast_dims(100, 300) == (128, 512)


def _pipelined_against_reference(pair, tmp_path, h, w):
    from PIL import Image

    _, prog, state = pair
    imgs, folder = _folder(h=h, w=w)
    for (name, _), img in zip(folder, imgs):
        Image.fromarray(slide_gen.tissue_mask(img)).save(
            tmp_path / f"{name}.png")
    cfg = _cfg()
    eng = DenseInferenceEngine(prog, cfg, device="cpu", dtype=torch.float32)
    eng.slides_in_flight = 2
    coll = SlideCollection(folder, cfg, mask_cache_dir=str(tmp_path))
    out = {name: res for name, _, res in _pipelined_results(eng, coll,
                                                            fcn=True)}
    ref = build_reference(REF_CFG)
    ref.load_state_dict(state)
    for (name, _), img in zip(folder, imgs):
        probs = slide_probs(ref.eval(), REF_CFG, img, "cpu")
        res = out[name]
        r = postprocess.judge(probs, torch.from_numpy(
            slide_gen.tissue_mask(img)), res.labels,
            np.rint(res.heatmap * 255).astype(np.uint8))
        assert r["heat_err"] <= 1 and r["label_miss"] == 0, (name, r)


@pytest.mark.parametrize("sr", [8, 4, 2, 1])
def test_sr_attention_equals_explicit(sr):
    """``sr_attention`` (SDPA's math backend here) against the explicit
    softmax(q kᵀ / 8) v in float64, at a stage-1 map of 24×32 tokens
    reduced R×R; float32 sums over at most 768 keys: 1e-5."""
    g = torch.Generator().manual_seed(sr)
    heads, n, m = {8: (1, 768, 12), 4: (2, 192, 12), 2: (5, 48, 12),
                   1: (8, 12, 12)}[sr]
    q = torch.randn(2, heads, n, 64, generator=g)
    k, v = (torch.randn(2, heads, m, 64, generator=g) for _ in range(2))
    launches, flops = attention.LAUNCHES, attention.FLOPS
    got = attention.sr_attention(q, k, v)
    assert attention.LAUNCHES == launches + 1
    assert attention.FLOPS == flops + 4 * 2 * heads * n * m * 64
    p = torch.softmax(q.double() @ k.double().transpose(-2, -1) / 8, -1)
    torch.testing.assert_close(got.double(), p @ v.double(), rtol=1e-5,
                               atol=1e-5)


def test_ranges_and_counts(pair):
    """One forward opens ``mit.stage`` 4 times and ``mit.attention`` once
    a block (52), each attention call counted."""
    _, prog, _ = pair
    spans = Spans()
    launches = attention.LAUNCHES
    with spans.annotations(), torch.no_grad():
        prog.segment(torch.zeros(1, 3, 96, 128))
    assert spans.count("program:mit.stage") == 4
    assert spans.count("program:mit.attention") == 52
    assert attention.LAUNCHES == launches + 52


def test_cls_grid_pass_runs(pair):
    """cls mode's grid pass: each 64² tile through ``YNet.classify`` in
    the tile dtype (the compute copy's LayerNorms in bf16 too)."""
    _, prog, _ = pair
    imgs, folder = _folder(n=1)
    cfg = _cfg().replace(compute_dtype="bfloat16")
    eng = DenseInferenceEngine(prog, cfg, mode="cls", device="cpu")
    plan = plan_slide("s0", folder[0][1], cfg)
    plan.mask = slide_gen.tissue_mask(imgs[0])
    res = eng.predict_slide(plan)
    assert res.labels.shape == (128, 256) and np.isfinite(res.heatmap).all()


def test_training_step_runs(pair):
    """One hybrid step of the cached path in float32: finite loss, every
    encoder block's weights moved."""
    from wsiseg_tpu_torch.optim import build_optimizer
    from wsiseg_tpu_torch.train.device_cache import \
        make_cached_hybrid_train_step
    from wsiseg_tpu_torch.train.state import TrainState

    _, _, state = pair
    gen = torch.Generator().manual_seed(7)
    n, t = 4, 64
    arrays = {"image": torch.randint(0, 256, (n, t, t, 3), generator=gen,
                                     dtype=torch.uint8),
              "seg_label": torch.randint(0, 4, (n, t, t), generator=gen,
                                         dtype=torch.uint8),
              "cls_label": torch.tensor([0, 2, -1, -1]),
              "reg_label": torch.rand(n, generator=gen),
              "is_cls": torch.tensor([1., 1, 0, 0]),
              "is_reg": torch.tensor([0., 0, 1, 0]),
              "is_seg": torch.tensor([0., 0, 0, 1])}
    cfg = _cfg(batch_size=n, seed=5).replace(tile_w=t, tile_h=t)
    model = YNet("mit_b5", 4, 1, "FPN")
    model.load_state_dict(state)
    st = TrainState(model, build_optimizer(cfg, model.parameters()))
    before = model.encoder.block3[39].mlp.fc1.weight.detach().clone()
    step = make_cached_hybrid_train_step(
        model, cfg, cls_weights=np.ones(4), seg_weights=np.ones(4))
    m = step(st, arrays, torch.arange(n), torch.Generator().manual_seed(5))
    assert all(np.isfinite(float(v)) for v in m.values())
    assert not torch.equal(before, model.encoder.block3[39].mlp.fc1.weight)


def _refusals(eng, plan, model):
    return {
        "chunked": lambda: eng.predict_slide_fcn(plan, chunk=64, halo=16),
        "banded": lambda: eng.predict_slide_fcn_banded(plan, halo=16),
        "sharded_rows": lambda: eng.predict_slide_fcn_sharded_rows(
            plan, None),
        "device_throughput_chunked": lambda: eng.device_throughput(
            plan, chunk=64, halo=16, iters=1),
        "fold": lambda: prepare_fast(model, (0.5,) * 3, (0.5,) * 3,
                                     torch.float32, fold=True),
    }


@pytest.mark.parametrize("route", ["chunked", "banded", "sharded_rows",
                                   "device_throughput_chunked", "fold",
                                   "fold_engine", "oversize", "cls_fcn",
                                   "spatial"])
def test_chunked_routes_refuse(pair, route):
    """Every route that cuts a slide (or a tile) into halo-padded pieces
    raises ``ValueError`` naming the encoder: no halo makes a piece of a
    global-attention model exact."""
    _, prog, _ = pair
    imgs, folder = _folder(n=1)
    eng = DenseInferenceEngine(prog, _cfg(), device="cpu",
                               dtype=torch.float32)
    plan = plan_slide("s0", folder[0][1], _cfg())
    plan.mask = slide_gen.tissue_mask(imgs[0])
    calls = _refusals(eng, plan, prog)
    if route == "fold_engine":
        eng.fcn_fold = True
        call = lambda: eng.predict_slide_fcn(plan)  # noqa: E731
    elif route == "oversize":
        eng.fcn_fast_max_px = 1000          # past the cap: the banded route
        call = lambda: eng.predict_slide_fcn(plan)  # noqa: E731
    elif route == "cls_fcn":
        cls = DenseInferenceEngine(prog, _cfg(), mode="cls", device="cpu")
        call = lambda: cls.predict_slide_fcn(plan)  # noqa: E731
    elif route == "spatial":
        def call():
            with comm.spatial(comm.Space(None, 0, 2)):
                prog(torch.zeros(2, 3, 64, 64))
    else:
        call = calls[route]
    with pytest.raises(ValueError, match="mit_b5"):
        call()


def test_other_decoders_refused():
    with pytest.raises(ValueError, match="mit_b5"):
        YNet("mit_b5", 4, 1, "Unet")
    with pytest.raises(ValueError):
        MiTEncoder("mit_b9")
