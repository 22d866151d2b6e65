"""Stem kernels' plain versions (wsiseg_tpu_torch.ops.stem) against the
Pallas stems ``wsiseg_tpu.ops.pallas_stem.stem_pool_conv`` and
``stem_conv`` in interpret mode.

JAX gets ``pack_for_stem2(img, MEAN)`` / ``pack_for_stem(img, MEAN)`` (pad
ring round(255·mean)), padded to 16 / 8 rows as ``_segment_from_packed``
does; the port gets the raw image. Both round the same f32 sums of exact u8·bf16 products to bf16, so
they agree within one bf16 ulp (rtol 2^-7, atol 2^-7·max|ref|): only the
summation order differs. The CUDA kernel itself is checked against the
plain version in tests/test_torch_cuda.py, on a machine with a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wsiseg_tpu.models.infer_fast import pack_for_stem, pack_for_stem2
from wsiseg_tpu.ops.pallas_stem import (fold_stem_weights,
                                        fold_stem_weights2, stem_conv,
                                        stem_pool_conv)
from wsiseg_tpu_torch.ops import stem

torch.set_num_threads(2)

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
TOL = 2.0 ** -7


@pytest.fixture(scope="module")
def stem_vars():
    """Random stem weights and BN, as tests/test_pallas_stem.py makes them."""
    r = np.random.RandomState(0)
    return dict(
        kernel=r.randn(7, 7, 3, 64).astype(np.float32) * 0.05,
        scale=r.rand(64).astype(np.float32) + 0.5,
        bias=r.randn(64).astype(np.float32) * 0.1,
        mean=r.randn(64).astype(np.float32) * 0.1,
        var=r.rand(64).astype(np.float32) + 0.5,
    )


def _port_fold(v):
    return stem.fold_stem_weights(
        torch.from_numpy(v["kernel"]).permute(3, 2, 0, 1),
        *(torch.from_numpy(v[k]) for k in ("scale", "bias", "mean", "var")),
        MEAN, STD)


def _close(got: torch.Tensor, ref: np.ndarray):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=TOL,
                               atol=TOL * np.abs(ref).max())


def test_pad_value_is_normalized_zero():
    assert stem.pad_value(MEAN) == (124, 116, 104)


def test_fold_matches_jax(stem_vars):
    """Folded weights: the f32 fold rounded to bf16, row (ky·7+kx)·3+c."""
    w147, b = fold_stem_weights(*(jnp.asarray(stem_vars[k]) for k in (
        "kernel", "scale", "bias", "mean", "var")), MEAN, STD)
    w, bias = _port_fold(stem_vars)
    assert w.dtype == torch.bfloat16 and bias.dtype == torch.float32
    ref = np.asarray(jnp.asarray(w147).astype(jnp.bfloat16), np.float32)
    got = w.float().reshape(147, 64).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=0)
    np.testing.assert_allclose(bias.numpy(), np.asarray(b)[0], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("hw", [(64, 256), (96, 512)])
def test_plain_stem_matches_pallas(stem_vars, hw):
    h, w = hw
    img = np.random.RandomState(h).randint(0, 256, (h, w, 3)).astype(np.uint8)
    packed = np.pad(pack_for_stem2(img, MEAN), ((0, 0), (0, 4), (0, 0)))
    w336, b2 = fold_stem_weights2(*(jnp.asarray(stem_vars[k]) for k in (
        "kernel", "scale", "bias", "mean", "var")), MEAN, STD)
    ref_s2d, ref_pool = stem_pool_conv(jnp.asarray(packed), w336, b2,
                                       h // 2, w // 2, interpret=True)
    wf, bias = _port_fold(stem_vars)
    before = stem.LAUNCHES
    s2d, pool = stem.stem_pool_conv(torch.from_numpy(img)[None], wf, bias,
                                    stem.pad_value(MEAN))
    assert stem.LAUNCHES == before          # CPU tensors take the plain path
    assert s2d.shape == (1, h // 4, w // 4, 256)
    assert pool.shape == (1, h // 4, w // 4, 64)
    assert s2d.dtype == pool.dtype == torch.bfloat16
    _close(s2d[0], ref_s2d[: h // 4])
    _close(pool[0], ref_pool[: h // 4])


@pytest.mark.parametrize("h2,w2", [(16, 128)])
def test_plain_native_stem_matches_pallas(stem_vars, h2, w2):
    """stem_conv (native c1) against the JAX stem_conv at h2×w2 = 16×128,
    as tests/test_pallas_stem.py runs it."""
    h, w = 2 * h2, 2 * w2
    img = np.random.RandomState(5).randint(0, 256, (h, w, 3)).astype(np.uint8)
    packed = np.pad(pack_for_stem(img, MEAN), ((0, 0), (0, 2), (0, 0)))
    w147, b = fold_stem_weights(*(jnp.asarray(stem_vars[k]) for k in (
        "kernel", "scale", "bias", "mean", "var")), MEAN, STD)
    ref = stem_conv(jnp.asarray(packed), w147, b, h2, w2,
                    interpret=True)[:h2]
    wf, bias = _port_fold(stem_vars)
    before = stem.STEM_CONV_LAUNCHES
    c1 = stem.stem_conv(torch.from_numpy(img)[None], wf, bias,
                        stem.pad_value(MEAN))
    assert stem.STEM_CONV_LAUNCHES == before   # CPU: the plain path
    assert c1.shape == (1, h2, w2, 64) and c1.dtype == torch.bfloat16
    _close(c1[0], ref)


def test_native_stem_is_pool_stem_before_pool(stem_vars):
    """The two modes share one c1: space_to_depth(c1) and its 3×3/2
    max-pool are the pool mode's outputs."""
    from wsiseg_tpu_torch.models.fast_decoder import space_to_depth
    img = torch.from_numpy(np.random.RandomState(6).randint(
        0, 256, (2, 32, 64, 3)).astype(np.uint8))
    wf, bias = _port_fold(stem_vars)
    c1 = stem.stem_conv(img, wf, bias, (1, 2, 3)).permute(0, 3, 1, 2)
    s2d, pool = stem.stem_pool_conv(img, wf, bias, (1, 2, 3))
    assert torch.equal(space_to_depth(c1).permute(0, 2, 3, 1), s2d)
    assert torch.equal(torch.nn.functional.max_pool2d(c1, 3, 2, 1)
                       .permute(0, 2, 3, 1), pool)


def test_plain_stem_batch_equals_single(stem_vars):
    r = np.random.RandomState(3)
    imgs = torch.from_numpy(r.randint(0, 256, (2, 32, 64, 3)).astype(
        np.uint8))
    wf, bias = _port_fold(stem_vars)
    both = stem.stem_pool_conv_ref(imgs, wf, bias, (1, 2, 3))
    for k in range(2):
        one = stem.stem_pool_conv_ref(imgs[k:k + 1], wf, bias, (1, 2, 3))
        for a, b in zip(both, one):
            assert torch.equal(a[k:k + 1], b)


@pytest.mark.parametrize("shape", [(1, 30, 64, 3), (1, 32, 64, 4),
                                   (32, 64, 3)])
def test_wrapper_rejects_bad_shapes(stem_vars, shape):
    wf, bias = _port_fold(stem_vars)
    with pytest.raises(ValueError):
        stem.stem_pool_conv(torch.zeros(shape, dtype=torch.uint8), wf, bias,
                            (0, 0, 0))


@pytest.mark.parametrize("shape", [(1, 31, 64, 3), (1, 32, 64, 4),
                                   (32, 64, 3)])
def test_native_wrapper_rejects_bad_shapes(stem_vars, shape):
    wf, bias = _port_fold(stem_vars)
    with pytest.raises(ValueError):
        stem.stem_conv(torch.zeros(shape, dtype=torch.uint8), wf, bias,
                       (0, 0, 0))
