"""Tests of the port that need an NVIDIA GPU (marker ``cuda``): each CUDA
kernel (both stem modes in each A-operand assembly form; the stem probes
5 and 6; the TMA/wgmma single conv as conv9,
conv3x3_small and a one-layer conv_chain; the fused TMA/wgmma chain as
conv_chain)
against its plain PyTorch version, and the engine's kernel path (GPU)
against its plain path (CPU) on the default and the fold route, and for
each decoder family on the resnet50 encoder; on both routes the fused
outputs' depth-to-space on the card against the host interleave of the
same planes; the grid route (seg and cls)
GPU against CPU, and the streamed grid against the resident one on the
card; the binary morphology, the tumor bed and the color mask on the card
exactly equal to the CPU; a float64 training step on the card against
the CPU (no kernel of the port launched) and the ``train`` CLI on the
card; the proposal/HR ops on the card against the CPU: k-means seeds
equal, Lloyd, SLIC, label propagation (exact), the HR ensemble in bf16
and a float64 HR step; ``utils.profiling``'s CUDA forms (trace, allocator
stats, ``timed``); the MiT attention (cuDNN's kernel) against SDPA's
math backend, and mit_b5 FPN's fused route on the card against the CPU;
a fused group's launch under ``torch.cuda.set_sync_debug_mode("error")``
(no call that blocks the host) for resnet18 Unet, resnet50 FPN and mit_b5
FPN, its results equal to the synchronous ``_serve``'s.
They skip where ``torch.cuda.is_available()`` is False. This file imports
no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from wsiseg_tpu_torch.config import default_config
from wsiseg_tpu_torch.data.bench_slide import level2_image
from wsiseg_tpu_torch.data.wsi_tiles import plan_slide
from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine, \
    extract_tumor_bed
from wsiseg_tpu_torch.models.ynet import init_ynet
from wsiseg_tpu_torch.ops import conv9, morphology, stem
from wsiseg_tpu_torch.ops.threshold import pred_to_mask
from wsiseg_tpu_torch.slides import SyntheticSlide

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
TOL = 2.0 ** -7                 # one bf16 ulp: only summation order differs

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _folded(device):
    r = np.random.RandomState(0)
    k = torch.from_numpy(r.randn(64, 3, 7, 7).astype(np.float32) * 0.05)
    vecs = [torch.from_numpy(v.astype(np.float32)) for v in (
        r.rand(64) + 0.5, r.randn(64) * 0.1, r.randn(64) * 0.1,
        r.rand(64) + 0.5)]
    w, b = stem.fold_stem_weights(k, *vecs, MEAN, STD)
    return w.to(device), b.to(device)


@pytest.mark.parametrize("shape", [(1, 96, 256), (2, 100, 260),
                                   (1, 3072, 4096), (4, 3072, 4096)])
def test_stem_kernel_matches_plain(cuda_device, shape):
    n, h, w = shape
    img = torch.from_numpy(np.random.RandomState(h).randint(
        0, 256, (n, h, w, 3)).astype(np.uint8)).to(cuda_device)
    wf, bias = _folded(cuda_device)
    before = stem.LAUNCHES
    got = stem.stem_pool_conv(img, wf, bias, stem.pad_value(MEAN))
    torch.cuda.synchronize()
    assert stem.LAUNCHES == before + 1
    ref = stem.stem_pool_conv_ref(img, wf, bias, stem.pad_value(MEAN))
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.bfloat16
        r = r.float()
        torch.testing.assert_close(g.float(), r, rtol=TOL,
                                   atol=TOL * r.abs().max().item())


def _close(got, ref):
    ref = ref.float()
    torch.testing.assert_close(got.float(), ref, rtol=TOL,
                               atol=TOL * ref.abs().max().item())


@pytest.mark.parametrize("shape", [(1, 96, 256), (2, 100, 262),
                                   (1, 3072, 4096), (4, 3072, 4096)])
def test_native_stem_kernel_matches_plain(cuda_device, shape):
    n, h, w = shape
    img = torch.from_numpy(np.random.RandomState(w).randint(
        0, 256, (n, h, w, 3)).astype(np.uint8)).to(cuda_device)
    wf, bias = _folded(cuda_device)
    before = stem.STEM_CONV_LAUNCHES
    got = stem.stem_conv(img, wf, bias, stem.pad_value(MEAN))
    torch.cuda.synchronize()
    assert stem.STEM_CONV_LAUNCHES == before + 1
    assert got.shape == (n, h // 2, w // 2, 64)
    _close(got, stem.stem_conv_ref(img, wf, bias, stem.pad_value(MEAN)))


@pytest.mark.parametrize("form", stem.FORMS)
@pytest.mark.parametrize("shape,pool", [
    ((1, 96, 256), True), ((2, 100, 260), True), ((1, 8, 1000), True),
    ((1, 96, 256), False), ((2, 100, 262), False), ((1, 10, 26), False)])
def test_stem_forms_match_plain(cuda_device, form, shape, pool):
    """Every assembly form of csrc/stem_sm90.cu, both modes, ragged widths
    (W/4 not a multiple of 63 or 64, W % 4 == 2 in native mode)."""
    n, h, w = shape
    img = torch.from_numpy(np.random.RandomState(w).randint(
        0, 256, (n, h, w, 3)).astype(np.uint8)).to(cuda_device)
    wf, bias = _folded(cuda_device)
    cells = stem.prepare_stem_cells(wf)
    pad = stem.pad_value(MEAN)
    got = stem.launch_cells(img, cells, bias, pad, pool, form)
    torch.cuda.synchronize()
    if pool:
        for g, r in zip(got, stem.stem_pool_conv_ref(img, wf, bias, pad)):
            _close(g, r)
    else:
        _close(got, stem.stem_conv_ref(img, wf, bias, pad))


def test_probe_stem_assembly_bit_identical(cuda_device):
    """Probe 5 (P1): the three forms' outputs are bit-identical."""
    from wsiseg_tpu_torch import probes
    img = torch.from_numpy(np.random.RandomState(0).randint(
        0, 255, (1, 200, 520, 3), np.uint8)).to(cuda_device)
    wf, bias = _folded(cuda_device)
    cells = stem.prepare_stem_cells(wf)
    pad = stem.pad_value(MEAN)
    outs = [probes.probe_stem_assembly(img, cells, bias, pad, f)
            for f in stem.FORMS]
    torch.cuda.synchronize()
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))
    for g, r in zip(outs[0], stem.stem_pool_conv_ref(img, wf, bias, pad)):
        _close(g, r)


@pytest.mark.parametrize("shape,shift", [((1, 128, 128), 0),
                                         ((1, 128, 128), 1),
                                         ((3, 320, 128), 1)])
@pytest.mark.parametrize("staged", [False, True])
def test_probe_pool_epilogue_matches_plain(cuda_device, shape, shift,
                                           staged):
    """Probe 6 (P2c) at probe_retile's (128, 128) and over several tiles."""
    from wsiseg_tpu_torch import probes
    r = np.random.RandomState(shape[1])
    x = torch.from_numpy(r.rand(*shape).astype(np.float32)).to(
        cuda_device).to(torch.bfloat16)
    m = torch.ones(shape[1], dtype=torch.bfloat16, device=cuda_device)
    m[0] = 0
    got = probes.probe_pool_epilogue(x, m, shift, staged)
    for g, w in zip(got, probes.probe_pool_epilogue_ref(x, m, shift)):
        assert torch.equal(g, w)


def _layers(device, chans, last_relu=True, seed=0):
    r = np.random.RandomState(seed)
    out = []
    for i, (ci, co) in enumerate(zip(chans[:-1], chans[1:])):
        k = torch.from_numpy(r.randn(3, 3, ci, co).astype(np.float32)
                             / np.sqrt(9 * ci))
        s = torch.from_numpy(r.rand(co).astype(np.float32) + 0.5)
        b = torch.from_numpy(r.randn(co).astype(np.float32) * 0.1)
        w, bb = conv9.prep_layer(k.to(device), s.to(device), b.to(device))
        out.append((w, bb, last_relu or i + 2 < len(chans)))
    return out


def _act(device, n, h, w, c, seed=1):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        n, h, w, c).astype(np.float32)).to(device).to(torch.bfloat16)


@pytest.mark.parametrize("n,h,w,chans,out_dtype", [
    (1, 37, 45, [8, 16], torch.bfloat16),
    (2, 19, 45, [40, 70], torch.float32),
    (1, 10, 17, [3, 5], torch.bfloat16),
    (1, 384, 512, [384, 256], torch.bfloat16),
    (1, 64, 200, [64, 16], torch.float32),      # Cout = 16, f32 (the head)
    (1, 96, 300, [32, 64], torch.bfloat16),     # Cin = 32 (block4.0)
    (1, 33, 333, [64, 64], torch.bfloat16),     # W not a multiple of 128
    (1, 1, 77, [16, 32], torch.bfloat16),       # H = 1
    (2, 192, 256, [768, 256], torch.bfloat16),  # N = 2 at block0.0
    (1, 10, 140, [16, 300], torch.float32),     # two N tiles
])
def test_conv9_kernel_matches_plain(cuda_device, n, h, w, chans, out_dtype):
    x = _act(cuda_device, n, h, w, chans[0])
    (wl, bl, _), = _layers(cuda_device, chans)
    before = conv9.LAUNCHES["conv9"]
    got = conv9.conv9(x, wl, bl, True, out_dtype)
    torch.cuda.synchronize()
    assert conv9.LAUNCHES["conv9"] == before + 1
    assert got.dtype == out_dtype and got.shape == (n, h, w, chans[-1])
    _close(got, conv9.conv9_ref(x, wl, bl, True, out_dtype))


@pytest.mark.parametrize("n,h,w,chans,out_dtype", [
    (1, 13, 35, [32, 64], torch.bfloat16),       # one layer: the single conv
    (1, 13, 35, [32, 64, 64], torch.bfloat16),
    (1, 192, 256, [768, 256, 256], torch.bfloat16),       # block0
    (2, 192, 256, [768, 256, 256], torch.bfloat16),
    (1, 384, 512, [384, 128, 128], torch.bfloat16),       # block1
    (2, 70, 200, [384, 256, 256], torch.bfloat16),        # block2's form
    (1, 100, 190, [320, 128, 128], torch.bfloat16),       # block3's form
    (2, 83, 131, [320, 128, 128], torch.float32),
    (1, 83, 131, [32, 64, 64, 16], torch.float32),        # the ragged head
    (2, 96, 300, [32, 64, 64, 16], torch.float32),
    (1, 61, 117, [32, 64, 64, 16], torch.bfloat16),
    (1, 45, 70, [384, 128, 16], torch.float32),           # NL up to NM
    (2, 33, 59, [32, 64, 64], torch.float32),             # f32, NL = NM
    (1, 40, 77, [768, 128, 64, 64], torch.bfloat16),      # L = 3, NM 128
    (1, 7, 19, [12, 20, 6, 10], torch.bfloat16),          # Cin % 8 ≠ 0
    (1, 1, 77, [16, 32, 16], torch.bfloat16),             # H = 1
])
def test_conv_chain_kernel_matches_plain(cuda_device, n, h, w, chans,
                                         out_dtype):
    x = _act(cuda_device, n, h, w, chans[0])
    layers = _layers(cuda_device, chans, last_relu=False)
    before = conv9.LAUNCHES["conv_chain"]
    got = conv9.conv_chain(x, layers, out_dtype)
    torch.cuda.synchronize()
    assert conv9.LAUNCHES["conv_chain"] == before + 1
    assert got.dtype == out_dtype and got.shape == (n, h, w, chans[-1])
    _close(got, conv9.conv_chain_ref(x, layers, out_dtype))


def test_conv_chain_kernel_rejects_f32_input(cuda_device):
    layers = _layers(cuda_device, [8, 16, 8])
    with pytest.raises(ValueError, match="conv_chain_ref"):
        conv9.conv_chain(torch.zeros(1, 8, 8, 8, device=cuda_device), layers)


def test_conv3x3_small_kernel_matches_plain(cuda_device):
    x = _act(cuda_device, 1, 208, 272, 64)
    r = np.random.RandomState(2)
    k = torch.from_numpy(r.randn(3, 3, 64, 16).astype(np.float32) / 24).to(
        cuda_device)
    b = torch.from_numpy(r.randn(16).astype(np.float32)).to(cuda_device)
    before = conv9.LAUNCHES["conv3x3_small"]
    got = conv9.conv3x3_small(x, k, b)
    torch.cuda.synchronize()
    assert conv9.LAUNCHES["conv3x3_small"] == before + 1
    assert got.dtype == torch.float32
    _close(got, conv9.conv3x3_small_ref(x, k, b))


def test_conv_kernel_rejects_f32_input(cuda_device):
    (wl, bl, _), = _layers(cuda_device, [8, 8])
    with pytest.raises(ValueError, match="conv9_ref"):
        conv9.conv9(torch.zeros(1, 8, 8, 8, device=cuda_device), wl, bl)


def test_stem_kernel_rejects_f32_weights(cuda_device):
    wf, bias = _folded(cuda_device)
    img = torch.zeros((1, 32, 32, 3), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        stem.stem_pool_conv(img, wf.float(), bias, (0, 0, 0))


@pytest.mark.parametrize("fold", [False, True])
def test_engine_gpu_matches_cpu(cuda_device, fold):
    cfg = default_config(tile_w=64, tile_h=64, tile_stride_w=32,
                         tile_stride_h=32)
    plan = plan_slide("syn", SyntheticSlide(width=4096, height=3072,
                                            num_levels=3, seed=11), cfg)
    engines = [DenseInferenceEngine(init_ynet(cfg, torch.Generator(
        ).manual_seed(0)), cfg, device=d) for d in (cuda_device, "cpu")]
    for e in engines:
        e.fcn_fold = fold
    gpu, cpu = (e.predict_slide_fcn(plan) for e in engines)
    assert (gpu.labels == cpu.labels).mean() >= 0.99
    assert (np.abs(gpu.heatmap - cpu.heatmap) <= 2 / 255 + 1e-6).mean() \
        >= 0.99


@pytest.mark.parametrize("fold", [False, True])
def test_fused_outputs_equal_host_interleave_on_gpu(cuda_device, fold):
    """The fused route's full-resolution labels and heat, made on the card
    by the depth-to-space, against the JAX engine's host interleave
    (``out[a::f, b::f] = planes[a·f + b]``, written out here: this file
    imports no JAX) of the same device planes (``_postprocess_s2d`` of
    the forward's head planes) copied to the host, on a group of two
    slides: equal."""
    cfg = default_config(tile_w=64, tile_h=64, tile_stride_w=32,
                         tile_stride_h=32)
    eng = DenseInferenceEngine(init_ynet(cfg, torch.Generator(
        ).manual_seed(0)), cfg, device=cuda_device)
    eng.fcn_fold = fold
    plans = [plan_slide(f"s{k}", SyntheticSlide(
        width=4096, height=3072, num_levels=3, seed=11 + k), cfg)
        for k in range(2)]
    with torch.no_grad():
        batch, masks = eng._inputs(plans)
        y = eng._forward(batch)
        planes = eng._postprocess_s2d(y, masks)
        full = eng._postprocess_full(y, masks)
    for p_dev, f_dev in zip(planes, full):
        assert p_dev.shape[1] == (4 if fold else 16)
        assert f_dev.device.type == "cuda" and f_dev.shape == (2, 192, 256)
        host = f_dev.cpu().numpy()
        f = 2 if fold else 4
        for k, p in enumerate(plans):
            hs, ws = p.stitch_hw
            pl = p_dev[k].cpu().numpy()
            want = np.empty((f * pl.shape[1], f * pl.shape[2]), pl.dtype)
            for a in range(f):
                for b in range(f):
                    want[a::f, b::f] = pl[a * f + b]
            np.testing.assert_array_equal(host[k, :hs, :ws],
                                          want[:hs, :ws])


@pytest.mark.parametrize("family", ["Unet", "Linknet", "FPN", "PSPNet"])
def test_family_engine_gpu_matches_cpu(cuda_device, family):
    """Each decoder family on the resnet50 encoder: the engine's kernel
    path (GPU, one stem kernel launch a slide) against its plain path
    (CPU) on a 192×256 slide."""
    cfg = default_config(tile_w=64, tile_h=64, tile_stride_w=32,
                         tile_stride_h=32, model_name=family,
                         arch_encoder="resnet50")
    plan = plan_slide("syn", SyntheticSlide(width=4096, height=3072,
                                            num_levels=3, seed=11), cfg)
    gpu_eng, cpu_eng = (DenseInferenceEngine(init_ynet(cfg, torch.Generator(
        ).manual_seed(0)), cfg, device=d) for d in (cuda_device, "cpu"))
    before = stem.LAUNCHES
    gpu = gpu_eng.predict_slide_fcn(plan)
    assert stem.LAUNCHES == before + 1
    cpu = cpu_eng.predict_slide_fcn(plan)
    assert gpu.labels.shape == (192, 256)
    assert (gpu.labels == cpu.labels).mean() >= 0.99
    assert (np.abs(gpu.heatmap - cpu.heatmap) <= 2 / 255 + 1e-6).mean() \
        >= 0.99


@pytest.mark.parametrize("mode", ["seg", "cls"])
def test_grid_gpu_matches_cpu(cuda_device, mode):
    """The grid route (tile forward in bf16, sequential overlap-add) on
    the card against the same route on the CPU, 64-px tiles at stride 32
    over a 192×256 slide: the logit canvas within 2^-5·max|canvas| (8
    bf16 ulps), labels equal wherever the CPU's top two probabilities are
    1e-2 apart (random-init logits are near-uniform, and in cls mode one
    flipped tile decision repaints a 32×32 block, 2 % of the image), heat
    within 2/255 on ≥ 99 %."""
    cfg = default_config(tile_w=64, tile_h=64, tile_stride_w=32,
                         tile_stride_h=32)
    plan = plan_slide("syn", SyntheticSlide(width=4096, height=3072,
                                            num_levels=3, seed=11), cfg)
    gpu, cpu = (DenseInferenceEngine(init_ynet(cfg, torch.Generator(
        ).manual_seed(0)), cfg, mode=mode, device=d).predict_slide(
        plan, keep_canvas=True, keep_probs=True)
        for d in (cuda_device, "cpu"))
    assert gpu.labels.shape == (192, 256)
    np.testing.assert_allclose(gpu.canvas, cpu.canvas, rtol=0,
                               atol=2 ** -5 * np.abs(cpu.canvas).max())
    top2 = np.sort(cpu.probs, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 1e-2
    assert decided.mean() > 0.5
    np.testing.assert_array_equal(gpu.labels[decided], cpu.labels[decided])
    assert (np.abs(gpu.heatmap - cpu.heatmap) <= 2 / 255 + 1e-6).mean() \
        >= 0.99


def test_streamed_equals_resident_on_gpu(cuda_device):
    """Tile batches through pinned memory and the prefetch stream give
    the resident route's result on the card: labels equal, heat within
    1e-5."""
    cfg = default_config(tile_w=64, tile_h=64, tile_stride_w=32,
                         tile_stride_h=32, infer_batch_size=8)
    plan = plan_slide("syn", SyntheticSlide(width=4096, height=3072,
                                            num_levels=3, seed=11), cfg)
    eng = DenseInferenceEngine(init_ynet(cfg, torch.Generator(
        ).manual_seed(0)), cfg, device=cuda_device)
    res = eng.predict_slide(plan, keep_canvas=True)
    st = eng.predict_slide_streamed(plan, nthreads=2, keep_canvas=True)
    np.testing.assert_array_equal(st.labels, res.labels)
    np.testing.assert_allclose(st.heatmap, res.heatmap, atol=1e-5)
    np.testing.assert_array_equal(st.canvas, res.canvas)


@pytest.mark.parametrize("op", ["dilate", "erode", "opening", "closing"])
@pytest.mark.parametrize("size", [2, 3, 10, 20])
def test_morphology_gpu_matches_cpu(cuda_device, op, size):
    m = torch.from_numpy((np.random.RandomState(size).rand(2, 300, 517)
                          < 0.4).astype(np.uint8))
    got = getattr(morphology, op)(m.to(cuda_device), size)
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    assert torch.equal(got.cpu(), getattr(morphology, op)(m, size))


def test_fill_holes_and_bwperim_gpu_match_cpu(cuda_device):
    m = torch.from_numpy((np.random.RandomState(1).rand(257, 391) < 0.55)
                         .astype(np.uint8))
    for max_iters in (None, 5):
        assert torch.equal(
            morphology.fill_holes(m.to(cuda_device), max_iters).cpu(),
            morphology.fill_holes(m, max_iters))
    assert torch.equal(morphology.bwperim(m.to(cuda_device)).cpu(),
                       morphology.bwperim(m))


def test_tumor_bed_and_color_mask_gpu_match_cpu(cuda_device):
    """extract_tumor_bed and pred_to_mask (plain and perim) on class labels
    drawn from a bench-style image: the card equals the CPU exactly."""
    img = level2_image(768, 1024, seed=3)
    labels = ((img[..., 1] < 150) * (1 + (img[..., 2] > 160)
                                     + (img[..., 0] > 130))).astype(np.uint8)
    got = extract_tumor_bed(labels, device=cuda_device)
    ref = extract_tumor_bed(labels, device="cpu")
    assert ref[0].any() and ref[1].any()
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    lab = torch.from_numpy(labels)
    for perim in (False, True):
        assert torch.equal(pred_to_mask(lab.to(cuda_device), 4,
                                        perim=perim).cpu(),
                           pred_to_mask(lab, 4, perim=perim))


def _train_step(device, cfg, host, seed=3):
    """One hybrid step of a seeded float64 Y-Net on ``device``: (metrics,
    state_dict on the CPU)."""
    from wsiseg_tpu_torch.cli.common import make_preprocess
    from wsiseg_tpu_torch.optim import build_optimizer
    from wsiseg_tpu_torch.train.state import TrainState
    from wsiseg_tpu_torch.train.steps import make_hybrid_train_step
    net = init_ynet(cfg, torch.Generator().manual_seed(seed)).double()
    net = net.to(device)
    if device.type == "cuda":
        net = net.to(memory_format=torch.channels_last)
    state = TrainState(net, build_optimizer(cfg, net.parameters()))
    batch = make_preprocess(cfg, train=False)(
        {k: torch.from_numpy(v).to(device) for k, v in host.items()})
    m = make_hybrid_train_step(net, cfg)(state, batch)
    return ({k: float(v) for k, v in m.items()},
            {k: v.detach().cpu() for k, v in net.state_dict().items()})


def test_train_step_gpu_matches_cpu_f64(cuda_device):
    """A float64 hybrid sgd step (resnet18 Unet, 32², batch 4, cls/seg/reg
    rows) on the card equals the CPU's within 1e-9·max(1, |CPU|), the
    running statistics included; no kernel of the port launches. (Not
    adam: its first update is about lr·g/|g|, which turns rounding in a
    near-zero gradient into an O(lr) difference.)"""
    cfg = default_config(tile_w=32, tile_h=32, compute_dtype="float64",
                         param_dtype="float64", optim="sgd", lr=1e-2)
    r = np.random.RandomState(7)
    host = {"image": r.randint(0, 256, (4, 32, 32, 3)).astype(np.uint8),
            "seg_label": r.randint(0, 4, (4, 32, 32)).astype(np.int32),
            "cls_label": np.array([1, -1, -1, -1], np.int32),
            "reg_label": np.array([0, 0, 0.4, 0], np.float32),
            "is_cls": np.array([1, 0, 0, 0], np.float32),
            "is_reg": np.array([0, 0, 1, 0], np.float32),
            "is_seg": np.array([0, 1, 0, 1], np.float32)}
    before = stem.LAUNCHES + sum(conv9.LAUNCHES.values())
    mg, sg = _train_step(cuda_device, cfg, host)
    assert stem.LAUNCHES + sum(conv9.LAUNCHES.values()) == before
    mc, sc = _train_step(torch.device("cpu"), cfg, host)
    for k in mc:
        assert abs(mg[k] - mc[k]) <= 1e-9 * max(1.0, abs(mc[k])), k
    for k, ref in sc.items():
        if ref.is_floating_point():
            d = ((sg[k] - ref).abs() / ref.abs().clamp(min=1.0)).max()
            assert d.item() <= 1e-9, (k, d.item())


@pytest.mark.parametrize("optim", ["adam", "sgd", "adabound"])
def test_optimizer_gpu_matches_cpu(cuda_device, optim):
    """The optimizers on the card (adam: torch's fused kernel) against the
    CPU over 5 float64 steps with weight decay, on random parameters and
    grads, rtol 1e-12."""
    from wsiseg_tpu_torch.optim import build_optimizer
    cfg = default_config(optim=optim, lr=3e-3, weight_decay=1e-2)
    r = np.random.RandomState(0)
    init = [r.randn(64, 32), r.randn(17)]
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        ps = [torch.tensor(v, device=dev, requires_grad=True) for v in init]
        opt = build_optimizer(cfg, ps)
        g = np.random.RandomState(1)
        for _ in range(5):
            for p in ps:
                p.grad = torch.from_numpy(g.randn(*p.shape)).to(dev)
            opt.step()
        out.append([p.detach().cpu() for p in ps])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-15)


def test_train_cli_on_gpu(tmp_path):
    """``train`` on the card (its default device) for 2 epochs on a 32²
    store, host-fed and with ``--device_cache``: finite losses and a
    checkpoint each epoch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    from PIL import Image

    from wsiseg_tpu_torch.__main__ import main
    from wsiseg_tpu_torch.data import metadata as md
    r = np.random.RandomState(0)
    store = {}
    for i in range(16):
        pth = str(tmp_path / f"p{i}.png")
        Image.fromarray(r.randint(0, 256, (32, 32, 3)).astype(
            np.uint8)).save(pth)
        md.add_patch(store, "s", i, pth, [1, 0.5][i % 2])
    md.save_store(store, str(tmp_path))
    for extra in ([], ["--device_cache", "true"]):
        ck = tmp_path / f"ck{len(extra)}"
        trainer = main(["train", "--train_image_pth", str(tmp_path),
                        "--tile_w", "32", "--tile_h", "32", "--batch_size",
                        "8", "--num_epoch", "2", "--model_save_pth",
                        str(ck), "--raw_val_pth", ""] + extra)
        assert all(np.isfinite(h["loss"]) for h in trainer.history)
        assert (ck / "model_resnet18_2.pt").exists()


def test_kmeans_gpu_matches_cpu(cuda_device):
    """k-means at ``get_key_points``' cap (16384 points, k = 8): the host
    seeds are the same for points on the card; Lloyd's centers within
    1e-4·max|c| and labels ≥ 99.9 % equal."""
    from wsiseg_tpu_torch.ops import kmeans
    r = np.random.RandomState(3)
    pts = (r.rand(16384, 2) * [1024, 768]).astype(np.float32)
    cpu = torch.from_numpy(pts)
    np.testing.assert_array_equal(
        kmeans.plusplus_init(cpu.to(cuda_device), 8, seed=4),
        kmeans.plusplus_init(cpu, 8, seed=4))
    cg, lg = kmeans.kmeans(cpu.to(cuda_device), 8, seed=4)
    cc, lc = kmeans.kmeans(cpu, 8, seed=4)
    torch.testing.assert_close(cg.cpu(), cc, rtol=0,
                               atol=1e-4 * cc.abs().max().item())
    assert (lg.cpu() == lc).float().mean().item() >= 0.999


def test_slic_gpu_matches_cpu(cuda_device):
    """SLIC on a 192×256 thumbnail (60 segments): labels ≥ 99 % equal."""
    from wsiseg_tpu_torch.ops.slic import slic
    img = torch.from_numpy(level2_image(192, 256, seed=6))
    got = slic(img.to(cuda_device), n_segments=60).cpu()
    ref = slic(img, n_segments=60)
    assert (got == ref).float().mean().item() >= 0.99


@pytest.mark.parametrize("connectivity", [4, 8])
def test_label_propagation_gpu_equals_cpu(cuda_device, connectivity):
    from wsiseg_tpu_torch.ops.cc import label_propagation_steps
    r = np.random.RandomState(connectivity)
    m = torch.from_numpy((r.rand(96, 128) < 0.55).astype(np.uint8))
    lg, ng = label_propagation_steps(m.to(cuda_device),
                                     connectivity=connectivity)
    lc, nc = label_propagation_steps(m, connectivity=connectivity)
    assert ng == nc and torch.equal(lg.cpu(), lc)


def test_ensemble_bf16_gpu_matches_cpu(cuda_device):
    """The HR ensemble's bf16 compute copy (resnet18, 2 regions × 16
    patches of 64²) on the card against the CPU: both outputs within
    2^-5·max(1, |CPU|)."""
    from wsiseg_tpu_torch.models.ensemble import compute_copy, init_ensemble
    model = init_ensemble(default_config(), torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(2).randn(
        2, 16, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        ref = compute_copy(model, torch.bfloat16)(x)
        got = compute_copy(model, torch.bfloat16).to(cuda_device)(
            x.to(cuda_device))
    for g, r in zip(got, ref):
        d = ((g.cpu() - r).abs() / r.abs().clamp(min=1.0)).max().item()
        assert d <= 2.0 ** -5, d


def test_hr_step_gpu_matches_cpu_f64(cuda_device):
    """A float64 sgd HR step with class weights (resnet18 ensemble, 2
    regions × 16 patches of 32²) on the card equals the CPU's within
    1e-9·max(1, |CPU|)."""
    from wsiseg_tpu_torch.cli.common import make_preprocess
    from wsiseg_tpu_torch.models.ensemble import init_ensemble
    from wsiseg_tpu_torch.optim import build_optimizer
    from wsiseg_tpu_torch.train.state import TrainState
    from wsiseg_tpu_torch.train.steps import make_hr_train_step
    cfg = default_config(compute_dtype="float64", param_dtype="float64",
                         optim="sgd", lr=1e-2)
    r = np.random.RandomState(9)
    host = {"image": r.randint(0, 256, (2, 16, 32, 32, 3)).astype(np.uint8),
            "cls_label": np.array([3, 1], np.int32)}
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        net = init_ensemble(cfg, torch.Generator().manual_seed(1))
        net = net.double().to(dev)
        state = TrainState(net, build_optimizer(cfg, net.parameters()))
        batch = make_preprocess(cfg, train=False)(
            {k: torch.from_numpy(v).to(dev) for k, v in host.items()})
        m = make_hr_train_step(net, cfg, class_weights=[0.2, 1, 0.5, 0.7])(
            state, batch)
        out.append(({k: float(v) for k, v in m.items()},
                    {k: v.detach().cpu() for k, v in
                     net.state_dict().items()}))
    (mg, sg), (mc, sc) = out
    for k in mc:
        assert abs(mg[k] - mc[k]) <= 1e-9 * max(1.0, abs(mc[k])), k
    for k, ref in sc.items():
        if ref.is_floating_point():
            d = ((sg[k] - ref).abs() / ref.abs().clamp(min=1.0)).max()
            assert d.item() <= 1e-9, (k, d.item())


def test_profiling_on_the_card(cuda_device, tmp_path):
    """utils.profiling's CUDA forms: the trace holds the block's kernel,
    the allocator's peak covers the block's tensors and stays within the
    card, ``timed`` syncs and logs, and the card is in the peak table."""
    import glob
    import json
    import os
    from wsiseg_tpu_torch.utils import profiling
    x = torch.from_numpy(np.random.RandomState(0).rand(1024, 1024).astype(
        np.float32)).to(cuda_device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profiling.trace(str(tmp_path)) as prof:
        y = x @ x
        torch.cuda.synchronize()
    (path,) = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
    assert any(ev.device_type == torch.autograd.DeviceType.CUDA
               for ev in prof.key_averages())
    mem = profiling.device_memory_stats()
    assert mem["peak_bytes_in_use"] >= 2 * x.numel() * 4
    assert mem["bytes_in_use"] <= mem["peak_bytes_in_use"] \
        <= mem["bytes_limit"]
    assert profiling.device_memory_stats(cuda_device)["bytes_limit"] == \
        mem["bytes_limit"]
    lines = []
    with profiling.timed("matmul", log=lines.append):
        y = y @ x
    assert len(lines) == 1 and lines[0].startswith("matmul: ")
    assert torch.isfinite(y).all()
    assert profiling.detect_peak_tflops() in profiling.PEAK_TFLOPS.values()


@pytest.mark.parametrize("heads,n,m", [(1, 12288, 192), (2, 3072, 192),
                                       (5, 768, 192), (8, 192, 192),
                                       (3, 1000, 37)])
def test_sr_attention_matches_math(cuda_device, heads, n, m):
    """``sr_attention`` on the card (bf16, cuDNN's fused kernel) against
    SDPA's math backend in float32 on the same bf16 operands, at MiT-B5's
    four stage forms of a 384×512 image and one ragged shape: the output
    is a convex combination of v's rows, and the kernel rounds the
    probabilities and the output to bf16 (2^-9 relative each), so within
    2^-7·max|v|."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from wsiseg_tpu_torch.ops import attention
    g = torch.Generator(device=cuda_device).manual_seed(heads)
    q, k, v = (torch.randn(2, heads, s, 64, device=cuda_device,
                           generator=g).to(torch.bfloat16)
               for s in (n, m, m))
    before = attention.LAUNCHES
    got = attention.sr_attention(q, k, v)
    assert attention.LAUNCHES == before + 1 and got.dtype == torch.bfloat16
    with sdpa_kernel([SDPBackend.MATH]):
        want = torch.nn.functional.scaled_dot_product_attention(
            q.float(), k.float(), v.float())
    torch.testing.assert_close(got.float(), want, rtol=0,
                               atol=TOL * float(v.float().abs().max()))


def test_mit_engine_gpu_matches_cpu(cuda_device):
    """mit_b5 FPN through the fused route on the card (bf16: cuDNN's
    attention, no stem kernel) against the same route in float32 on the
    CPU, on a 192×256 slide: logits within 1/16 of their spread (the CPU
    test's bf16 bound), and one attention call a block (52)."""
    from wsiseg_tpu_torch.models.infer_fast import prepare_fast, \
        segment_from_image
    from wsiseg_tpu_torch.ops import attention
    cfg = default_config(tile_w=64, tile_h=64, tile_stride_w=32,
                         tile_stride_h=32, model_name="FPN",
                         arch_encoder="mit_b5")
    slide = SyntheticSlide(width=4096, height=3072, num_levels=3, seed=11)
    plan = plan_slide("syn", slide, cfg)
    model = init_ynet(cfg, torch.Generator().manual_seed(0))
    img = torch.from_numpy(np.ascontiguousarray(slide.read_level(2)))[None]
    want = segment_from_image(prepare_fast(model, MEAN, STD, torch.float32),
                              img, planar_head=False)
    eng = DenseInferenceEngine(model, cfg, device=cuda_device)
    launches, stems = attention.LAUNCHES, stem.LAUNCHES
    got = segment_from_image(eng.fast, img.to(cuda_device),
                             planar_head=False).cpu()
    assert attention.LAUNCHES == launches + 52 and stem.LAUNCHES == stems
    spread = float(want.max() - want.min())
    assert float((got - want).abs().max()) < spread / 16
    res = eng.predict_slide_fcn(plan)
    assert res.labels.shape == (192, 256)


@pytest.mark.parametrize("windows,heads,shift", [(86, 4, 6), (88, 32, 0),
                                                 (352, 16, 6)])
def test_window_attention_matches_math(cuda_device, windows, heads, shift):
    """``window_attention`` on the card (bf16, ``WINDOW_BACKEND``) against
    SDPA's math backend in float32 on the same bf16 operands, bias and
    masks, at Swin-B's window shapes (144 tokens, d = 32; a stage-1 window
    row, stage 4 and stage 3 of a 3072×4096 slide): within 2^-7·max|v|,
    as ``sr_attention``; one launch a call, two on a shifted block."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from wsiseg_tpu_torch.models import swin
    from wsiseg_tpu_torch.ops import attention
    g = torch.Generator(device=cuda_device).manual_seed(windows)
    q, k, v = (torch.randn(2, windows, heads, 144, 32, device=cuda_device,
                           generator=g).to(torch.bfloat16)
               for _ in range(3))
    bias = (3 * torch.randn(heads, 144, 144, device=cuda_device,
                            generator=g)).to(torch.bfloat16)
    nh = 8 if windows == 352 else 1
    hp, wp = 12 * nh, 12 * (windows // nh)
    masked = (swin.shift_masks(hp, wp, 12, 6, str(cuda_device)) if shift
              else None)
    before = attention.WINDOW_LAUNCHES
    got = attention.window_attention(q, k, v, bias, masked)
    assert attention.WINDOW_LAUNCHES == before + (2 if shift else 1)
    full = torch.zeros(windows, 144, 144, device=cuda_device)
    if shift:
        full[masked[0]] = masked[1]
    mask = (bias.float()[None, None] + full[None, :, None]).to(
        torch.bfloat16).float()
    with sdpa_kernel([SDPBackend.MATH]):
        want = torch.nn.functional.scaled_dot_product_attention(
            *(t.float().flatten(0, 1) for t in (q, k, v)),
            attn_mask=mask.expand(2, -1, -1, -1, -1).flatten(0, 1))
    torch.testing.assert_close(got.float().flatten(0, 1), want, rtol=0,
                               atol=TOL * float(v.float().abs().max()))


def test_swin_engine_gpu_matches_cpu(cuda_device):
    """swin_b UPerNet through the fused route on the card (bf16 windows,
    folded UPerNet, no stem kernel) against the same route in float32 on
    the CPU, on a 192×256 slide: logits within 1/16 of their spread (the
    CPU test's bf16 bound), and 36 window-attention launches a forward."""
    from wsiseg_tpu_torch.models.infer_fast import prepare_fast, \
        segment_from_image
    from wsiseg_tpu_torch.ops import attention
    cfg = default_config(tile_w=64, tile_h=64, tile_stride_w=32,
                         tile_stride_h=32, model_name="UPerNet",
                         arch_encoder="swin_b")
    slide = SyntheticSlide(width=4096, height=3072, num_levels=3, seed=11)
    plan = plan_slide("syn", slide, cfg)
    model = init_ynet(cfg, torch.Generator().manual_seed(0))
    img = torch.from_numpy(np.ascontiguousarray(slide.read_level(2)))[None]
    want = segment_from_image(prepare_fast(model, MEAN, STD, torch.float32),
                              img, planar_head=False)
    eng = DenseInferenceEngine(model, cfg, device=cuda_device)
    launches, stems = attention.WINDOW_LAUNCHES, stem.LAUNCHES
    got = segment_from_image(eng.fast, img.to(cuda_device),
                             planar_head=False).cpu()
    assert attention.WINDOW_LAUNCHES == launches + 36
    assert stem.LAUNCHES == stems
    spread = float(want.max() - want.min())
    assert float((got - want).abs().max()) < spread / 16
    res = eng.predict_slide_fcn(plan)
    assert res.labels.shape == (192, 256)


@pytest.mark.parametrize("model_name,arch", [("Unet", "resnet18"),
                                             ("FPN", "resnet50"),
                                             ("FPN", "mit_b5"),
                                             ("UPerNet", "swin_b")])
def test_fused_launch_never_blocks_the_host(cuda_device, model_name, arch):
    """A group of two 192×256 slides launched through the fused route
    (``_launch``: masks up from pinned memory, forward, postprocess,
    depth-to-space, each slide's copies into pinned host tensors, the
    event after them) with CUDA's sync debug mode at "error", once the
    route is warm: nothing raises, and the group's labels and heat equal
    the synchronous ``_serve``'s."""
    cfg = default_config(tile_w=64, tile_h=64, tile_stride_w=32,
                         tile_stride_h=32, model_name=model_name,
                         arch_encoder=arch)
    eng = DenseInferenceEngine(init_ynet(cfg, torch.Generator(
        ).manual_seed(0)), cfg, device=cuda_device)
    plans = [plan_slide(f"s{k}", SyntheticSlide(
        width=4096, height=3072, num_levels=3, seed=11 + k), cfg)
        for k in range(2)]
    with torch.no_grad():
        want = eng._serve(plans)
        imgs = [eng.stage_slide_fcn(p) for p in plans]
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            group = eng._launch(plans, imgs)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        got = eng._collect(group)
    for g, w in zip(got, want):
        assert g.name == w.name
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_array_equal(g.heatmap, w.heatmap)
