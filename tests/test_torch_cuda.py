"""Tests of the port that need an NVIDIA GPU (marker ``cuda``): the CUDA
stem kernel against its plain PyTorch version, and the engine's kernel
path (GPU) against its plain path (CPU). They skip where
``torch.cuda.is_available()`` is False. This file imports no JAX, so it
also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from wsiseg_tpu.config import default_config
from wsiseg_tpu.slides import SyntheticSlide
from wsiseg_tpu_torch.data.wsi_tiles import plan_slide
from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
from wsiseg_tpu_torch.models.ynet import init_ynet
from wsiseg_tpu_torch.ops import stem

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


def test_stem_kernel_rejects_f32_weights(cuda_device):
    wf, bias = _folded(cuda_device)
    img = torch.zeros((1, 32, 32, 3), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        stem.stem_pool_conv(img, wf.float(), bias, (0, 0, 0))


def test_engine_gpu_matches_cpu(cuda_device):
    cfg = default_config(tile_w=64, tile_h=64, tile_stride_w=32,
                         tile_stride_h=32)
    plan = plan_slide("syn", SyntheticSlide(width=4096, height=3072,
                                            num_levels=3, seed=11), cfg)
    gpu = DenseInferenceEngine(init_ynet(cfg, torch.Generator().manual_seed(
        0)), cfg, device=cuda_device).predict_slide_fcn(plan)
    cpu = DenseInferenceEngine(init_ynet(cfg, torch.Generator().manual_seed(
        0)), cfg, device="cpu").predict_slide_fcn(plan)
    assert (gpu.labels == cpu.labels).mean() >= 0.99
    assert (np.abs(gpu.heatmap - cpu.heatmap) <= 2 / 255 + 1e-6).mean() \
        >= 0.99
