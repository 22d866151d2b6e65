"""The Swin Transformer Swin-B under UPerNet (``models/swin.py``,
``models/decoders.UPerNetDecoder``, ``ops/attention.window_attention``),
held on the CPU against the benchmark's plain reference
(``portbench/reference/swin_upernet.py``): seeded random weights at the
published widths, one state dict loaded into both by name, small
non-square images (96×160: every stage's map needs window padding, 24×40
→ 24×48 at stage 1 and 3×5 → 12×12 at stage 4, and the shift masks are
live in every stage). The relative position bias tables are drawn at
std 1 (100× the harness's draw), so that a wrong bias index moves the
logits. The JAX package has no Swin, so the reference is the oracle.

Tolerances, both sides in float32 unless a test says otherwise: the two
models compute the same products and differ only in the order of their
float32 sums (the program's attention through SDPA's math backend on
batched windows against the reference's explicit blocked product, its
channels_last views against Microsoft's reshapes), which read 3e-6 at
logits of |1.2| (about 2⁻¹⁸ relative); 1e-4 absolute and relative
leaves room for other thread counts and stays 30× under what one bf16
rounding of the logits moves (2⁻⁸ relative)."""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench.harness import slides as slide_gen
from portbench.harness.spans import Spans
from portbench.harness.weights import make_state
from portbench.reference import postprocess
from portbench.reference import swin_upernet as reference
from portbench.reference.infer import normalise, slide_probs
from wsiseg_tpu_torch.config import default_config
from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection, plan_slide
from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
from wsiseg_tpu_torch.infer.evaluators import _pipelined_results
from wsiseg_tpu_torch.models import swin
from wsiseg_tpu_torch.models.decoders import UPerNetDecoder, psp_pool
from wsiseg_tpu_torch.models.infer_fast import prepare_fast, \
    segment_from_image
from wsiseg_tpu_torch.models.resnet import encoder_out_channels
from wsiseg_tpu_torch.models.ynet import YNet
from wsiseg_tpu_torch.ops import attention
from wsiseg_tpu_torch.parallel import comm
from wsiseg_tpu_torch.slides import VirtualPyramidSlide

torch.set_num_threads(2)

REF_CFG = {"model_name": "UPerNet", "arch_encoder": "swin_b",
           "num_classes": 4, "class_probs": [0.0] * 4,
           "dataset_mean": [0.485, 0.456, 0.406],
           "dataset_std": [0.229, 0.224, 0.225]}
TOL = {"rtol": 1e-4, "atol": 1e-4}
BIAS_STD = 100.0          # × the harness's 0.01-std draw of a bias table


@pytest.fixture(scope="module")
def pair():
    """(reference, program, state): one seeded state dict in both."""
    ref = reference.build(REF_CFG)
    scale = {k: BIAS_STD for k in ref.state_dict()
             if k.endswith("relative_position_bias_table")}
    state = make_state(ref, torch.Generator().manual_seed(23), scale)
    ref.load_state_dict(state)
    prog = YNet("swin_b", 4, 1, "UPerNet")
    prog.load_state_dict(state)
    return ref.eval(), prog.eval(), state


def _cfg(**kw):
    return default_config(model_name="UPerNet", arch_encoder="swin_b",
                          tile_w=64, tile_h=64, tile_stride_w=32,
                          tile_stride_h=32, wsi_mask_pth="",
                          compute_dtype="float32", **kw)


def test_published_widths_and_names(pair):
    """Microsoft's and mmsegmentation's parameter names, Swin-B's
    86,880,376 encoder parameters (4 stage norms, no classifier), 120.4 M
    in all, and the pyramid's channels."""
    _, prog, state = pair
    for key in ("encoder.patch_embed.proj.weight",
                "encoder.patch_embed.norm.weight",
                "encoder.layers.0.blocks.1.attn.relative_position_bias_table",
                "encoder.layers.2.blocks.17.attn.qkv.bias",
                "encoder.layers.2.downsample.reduction.weight",
                "encoder.layers.3.blocks.1.mlp.fc2.weight",
                "encoder.norm3.weight",
                "decoder.psp_modules.3.0.weight",
                "decoder.lateral_convs.2.1.running_var",
                "decoder.fpn_bottleneck.0.weight",
                "segmentation_head.0.weight"):
        assert key in state, key
    assert "encoder.layers.3.downsample.reduction.weight" not in state
    assert "encoder.layers.2.downsample.reduction.bias" not in state
    assert not any("relative_position_index" in k for k in state)
    assert sum(p.numel() for p in prog.encoder.parameters()) == 86880376
    assert sum(p.numel() for p in prog.parameters()) == 120388225
    assert [len(s.blocks) for s in prog.encoder.layers] == [2, 2, 18, 2]
    assert state["encoder.layers.1.blocks.0.attn."
                 "relative_position_bias_table"].shape == (529, 8)
    assert state["decoder.fpn_bottleneck.0.weight"].shape == \
        (512, 2048, 3, 3)
    assert encoder_out_channels("swin_b") == (1024, 512, 256, 128, 0)
    assert default_config(model_name="UPerNet",
                          arch_encoder="swin_b").arch_encoder == "swin_b"


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_equals_reference(pair, mode):
    """``segment`` and the three-head ``forward``, eval and train mode
    (UPerNet's BatchNorm on the batch's statistics in train mode, on
    copies: train mode updates the running statistics, the program's as
    flax does)."""
    ref, prog = (copy.deepcopy(m) for m in pair[:2])
    getattr(ref, mode)()
    getattr(prog, mode)()
    x = torch.randn(2, 3, 96, 160, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(prog.segment(x), ref.segment(x), **TOL)
        a, b = prog(x), ref(x)
    for k in ("seg", "cls", "reg"):
        torch.testing.assert_close(a[k], b[k], **TOL)


def test_pyramid_shapes(pair):
    _, prog, _ = pair
    with torch.no_grad():
        feats = prog.encode(torch.zeros(1, 3, 96, 160))
    assert [tuple(f.shape[1:]) for f in feats] == [
        (1024, 3, 5), (512, 6, 10), (256, 12, 20), (128, 24, 40),
        (0, 48, 80)]


def test_fused_route_equals_reference(pair):
    """The fused whole-image route's Swin branch (u8 in, normalised on the
    device, UPerNet on folded BatchNorm) in float32 against the
    reference's forward of the normalised image; in bfloat16, within the
    logits' spread over 16 (one bf16 rounding of each of 24 blocks' and
    UPerNet's outputs stays well inside it: 0.019 of 2.05 read)."""
    ref, prog, _ = pair
    img = np.random.RandomState(2).randint(0, 256, (96, 160, 3)) \
        .astype(np.uint8)
    with torch.no_grad():
        want = ref.segment(normalise(img, REF_CFG["dataset_mean"],
                                     REF_CFG["dataset_std"], "cpu"))
    u8 = torch.from_numpy(img)[None]
    fw = prepare_fast(prog, REF_CFG["dataset_mean"], REF_CFG["dataset_std"],
                      torch.float32)
    assert (fw.encoder, fw.w_align, fw.chunk_exact, fw.native) == \
        ("swin", 32, False, True)
    torch.testing.assert_close(segment_from_image(fw, u8, planar_head=False),
                               want, **TOL)
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


@pytest.mark.parametrize("hw", [(128, 256), (96, 288)])
def test_pipelined_fused_route_equals_reference(pair, tmp_path, hw):
    """Two slides through ``_pipelined_results(fcn=True)`` as one group of
    the fused route, f32, against the reference's labels and heat: heat
    within one u8 step (a value at a rounding boundary), no label the
    reference puts more than 1/255 below its best. 96×288 is a multiple
    of 32 but not of 256: the engine pads a Swin slide only to multiples
    of 32, so no white column enters the windows and every pixel is the
    model's own whole-image output."""
    from PIL import Image

    _, prog, state = pair
    imgs, folder = _folder(h=hw[0], w=hw[1])
    for (name, _), img in zip(folder, imgs):
        Image.fromarray(slide_gen.tissue_mask(img)).save(
            tmp_path / f"{name}.png")
    cfg = _cfg()
    eng = DenseInferenceEngine(prog, cfg, device="cpu", dtype=torch.float32)
    assert eng._fcn_fast_dims(*hw) == hw
    eng.slides_in_flight = 2
    coll = SlideCollection(folder, cfg, mask_cache_dir=str(tmp_path))
    out = {name: res for name, _, res in _pipelined_results(eng, coll,
                                                            fcn=True)}
    ref = reference.build(REF_CFG)
    ref.load_state_dict(state)
    for (name, _), img in zip(folder, imgs):
        probs = slide_probs(ref.eval(), REF_CFG, img, "cpu")
        res = out[name]
        r = postprocess.judge(probs, torch.from_numpy(
            slide_gen.tissue_mask(img)), res.labels,
            np.rint(res.heatmap * 255).astype(np.uint8))
        assert r["heat_err"] <= 1 and r["label_miss"] == 0, (name, r)


def _explicit(q, k, v, bias, masks):
    """softmax(q kᵀ/√d + bias + mask) v in float64 over (B, nW, h, N, d)
    windows, every window's (N, N) mask given."""
    s = q.double() @ k.double().transpose(-2, -1) * q.shape[-1] ** -0.5
    s = s + bias.double()[None, None] + masks.double()[None, :, None]
    return torch.softmax(s, -1) @ v.double()


@pytest.mark.parametrize("shift", [0, 6])
def test_window_attention_equals_explicit(shift):
    """``window_attention`` (SDPA's math backend here) against the
    explicit masked, biased softmax in float64 on a 30×40 map (padded to
    36×48: 3×4 windows of 144 tokens, 4 heads of 32), with the reference's
    mask over every window of a shifted map; float32 sums over 144 keys:
    1e-5. Counters: one launch unshifted, two shifted (every window with
    the bias, the 6 boundary windows again with bias and mask)."""
    g = torch.Generator().manual_seed(shift)
    q, k, v = (torch.randn(2, 12, 4, 144, 32, generator=g)
               for _ in range(3))
    bias = 3 * torch.randn(4, 144, 144, generator=g)
    full = (reference.shift_mask(36, 48, 12, 6, "cpu") if shift
            else torch.zeros(12, 144, 144))
    masked = swin.shift_masks(36, 48, 12, 6, "cpu") if shift else None
    launches, flops = attention.WINDOW_LAUNCHES, attention.WINDOW_FLOPS
    got = attention.window_attention(q, k, v, bias, masked)
    n = 2 if shift else 1
    assert attention.WINDOW_LAUNCHES == launches + n
    windows = 24 + (12 if shift else 0)
    assert attention.WINDOW_FLOPS == flops + 4 * windows * 4 * 144 ** 2 * 32
    torch.testing.assert_close(got.double(), _explicit(q, k, v, bias, full),
                               rtol=1e-5, atol=1e-5)


def test_shift_masks_are_the_boundary_windows():
    """The windows :func:`swin.shift_masks` leaves out are the ones whose
    mask (the reference's, over every window of the rolled map) is all
    zero; the ones it keeps carry the reference's masks: the last window
    row and column, nh + nw − 1 of them."""
    for hp, wp in ((36, 48), (12, 12), (768, 1032)):
        idx, masks = swin.shift_masks(hp, wp, 12, 6, "cpu")
        full = reference.shift_mask(hp, wp, 12, 6, "cpu")
        assert len(idx) == hp // 12 + wp // 12 - 1
        torch.testing.assert_close(masks, full[idx])
        rest = torch.ones(len(full), dtype=torch.bool)
        rest[idx] = False
        assert not full[rest].any()


@pytest.mark.parametrize("hw", [(12, 20), (3, 5)])
def test_pyramid_pooling_is_adaptive(hw):
    """UPerNet's PPM pools with ``AdaptiveAvgPool2d`` where 3 and 6 bins do
    not divide c5's sides (and where c5 is smaller than 6 bins): the
    decoder equals the reference's ``UPerHead`` from one state, in eval
    mode, and the port's ``psp_pool`` (JAX's antialiased resize there)
    gives other bins, so it must not be what UPerNet reads."""
    h, w = hw
    g = torch.Generator().manual_seed(h)
    dec = UPerNetDecoder((1024, 512, 256, 128, 0))
    head = reference.UPerHead([128, 256, 512, 1024])
    state = make_state(head, g)
    head.load_state_dict(state)
    dec.load_state_dict(state)
    feats = [torch.randn(2, c, h * f, w * f, generator=g)
             for c, f in ((1024, 1), (512, 2), (256, 4), (128, 8))]
    with torch.no_grad():
        torch.testing.assert_close(dec.eval()(feats),
                                   head.eval()(feats[::-1]), **TOL)
    c5 = feats[0]
    for bins in (3, 6):
        assert not torch.allclose(psp_pool(c5, bins),
                                  F.adaptive_avg_pool2d(c5, bins))


def test_ranges_and_counts(pair):
    """One forward opens ``swin.stage`` 4 times and ``swin.attention``
    once a launch: 12 unshifted blocks one each, 12 shifted blocks two
    each (36)."""
    _, prog, _ = pair
    spans = Spans()
    launches = attention.WINDOW_LAUNCHES
    with spans.annotations(), torch.no_grad():
        prog.segment(torch.zeros(1, 3, 96, 160))
    assert spans.count("program:swin.stage") == 4
    assert spans.count("program:swin.attention") == 36
    assert attention.WINDOW_LAUNCHES == launches + 36


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
    """One hybrid step of the cached path in float32 (no auxiliary head:
    the step trains the Y-Net's three heads, as inference runs it):
    finite loss, every stage's blocks and the bias tables moved."""
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
    model = YNet("swin_b", 4, 1, "UPerNet")
    model.load_state_dict(state)
    st = TrainState(model, build_optimizer(cfg, model.parameters()))
    blk = model.encoder.layers[2].blocks[17]
    before = [blk.mlp.fc1.weight.detach().clone(),
              blk.attn.relative_position_bias_table.detach().clone()]
    step = make_cached_hybrid_train_step(
        model, cfg, cls_weights=np.ones(4), seg_weights=np.ones(4))
    m = step(st, arrays, torch.arange(n), torch.Generator().manual_seed(5))
    assert all(np.isfinite(float(v)) for v in m.values())
    assert not torch.equal(before[0], blk.mlp.fc1.weight)
    assert not torch.equal(before[1], blk.attn.relative_position_bias_table)


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
                                   "fold_engine", "oversize", "spatial"])
def test_chunked_routes_refuse(pair, route):
    """Every route that cuts a slide (or a tile) into halo-padded pieces
    raises ``ValueError`` naming the encoder: window borders and the edge
    padding follow the whole padded image, so no halo makes a piece
    exact."""
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
    elif route == "spatial":
        def call():
            with comm.spatial(comm.Space(None, 0, 2)):
                prog(torch.zeros(2, 3, 64, 64))
    else:
        call = calls[route]
    with pytest.raises(ValueError, match="swin_b"):
        call()


@pytest.mark.parametrize("arch,decoder", [("swin_b", "FPN"),
                                          ("swin_b", "Unet"),
                                          ("resnet50", "UPerNet"),
                                          ("mit_b5", "UPerNet")])
def test_other_pairings_refused(arch, decoder):
    with pytest.raises(ValueError, match="UPerNet"):
        YNet(arch, 4, 1, decoder)


def test_unknown_swin_refused():
    with pytest.raises(ValueError):
        swin.SwinEncoder("swin_l")
