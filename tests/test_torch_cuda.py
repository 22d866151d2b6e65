"""Tests of the port that need an NVIDIA GPU (marker ``cuda``): each CUDA
kernel (both stem modes in each A-operand assembly form; the stem probes
5 and 6; the TMA/wgmma single conv as conv9,
conv3x3_small and a one-layer conv_chain; the fused TMA/wgmma chain as
conv_chain)
against its plain PyTorch version, and the engine's kernel path (GPU)
against its plain path (CPU) on the default and the fold route, and for
each decoder family on the resnet50 encoder; the grid route (seg and cls)
GPU against CPU, and the streamed grid against the resident one on the
card.
They skip where ``torch.cuda.is_available()`` is False. This file imports
no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from wsiseg_tpu_torch.config import default_config
from wsiseg_tpu_torch.data.wsi_tiles import plan_slide
from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
from wsiseg_tpu_torch.models.ynet import init_ynet
from wsiseg_tpu_torch.ops import conv9, stem
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
