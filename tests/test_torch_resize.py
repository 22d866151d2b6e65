"""The port's resize helpers (wsiseg_tpu_torch.models.decoders) against
jax.image.resize and the JAX decoders' own helpers, on seeded numpy maps:
nearest (exact 2× and the half-pixel branch), linear with JAX's default
antialias (PSPNet's pooled bins over indivisible dims, the ×4 / ×32
logit upsamples, mixed up/down), and PSPNet's bin pooling."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wsiseg_tpu.models.decoders import _resize_bilinear, _resize_nearest
from wsiseg_tpu_torch.models.decoders import (linear_weights, psp_pool,
                                              resize_linear, resize_nearest)

torch.set_num_threads(2)
TOL = 1e-6                      # f32, values of order 1


def _map(h, w, c=3, seed=0):
    return np.random.RandomState(seed).randn(2, h, w, c).astype(np.float32)


def _port(fn, x, *size):
    """Run a port helper on an NHWC numpy map, back to NHWC."""
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    return fn(t, *size).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("src,dst", [
    ((6, 8), (12, 16)),          # exact 2×: pixel repetition
    ((3, 5), (6, 10)),
    ((3, 5), (5, 7)),            # half-pixel index, up
    ((12, 16), (5, 7)),          # down
    ((7, 9), (7, 20)),           # one axis only
])
def test_resize_nearest_matches_jax(src, dst):
    x = _map(*src, seed=src[0])
    ref = np.asarray(_resize_nearest(jnp.asarray(x), *dst))
    got = _port(resize_nearest, x, *dst)
    assert got.shape == ref.shape == (2, *dst, 3)
    np.testing.assert_array_equal(got, ref)
    if dst != (2 * src[0], 2 * src[1]):
        # the half-pixel branch is torch's nearest-exact, not nearest
        t = torch.from_numpy(x).permute(0, 3, 1, 2)
        exact = torch.nn.functional.interpolate(t, size=dst,
                                                mode="nearest-exact")
        np.testing.assert_array_equal(
            exact.permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize("src,dst", [
    ((96, 128), (3, 3)),         # PSPNet bin 3 at bench geometry
    ((96, 128), (6, 6)),         # bin 6
    ((12, 16), (3, 3)),          # bin 3 on the 384×512 smoke slide
    ((6, 8), (3, 3)),
    ((3, 3), (96, 128)),         # a bin back to c5's size
    ((12, 16), (48, 64)),        # FPN's ×4
    ((3, 4), (96, 128)),         # PSPNet's ×32
    ((2, 2), (3, 3)),            # a bin larger than c5, and back
    ((3, 3), (2, 2)),
    ((5, 40), (11, 13)),         # one axis up, one down
])
def test_resize_linear_matches_jax(src, dst):
    x = _map(*src, seed=src[1])
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3),
                                      method="linear"))
    np.testing.assert_array_equal(
        ref, np.asarray(_resize_bilinear(jnp.asarray(x), *dst)))
    got = _port(resize_linear, x, *dst)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_linear_weights_are_the_antialiased_triangle():
    """Downsampling widens the triangle by in/out and normalises over the
    taps in range: rows sum to 1, and 96 → 3 averages 32-row windows
    with a 64-tap triangle, not adaptive_avg_pool's box."""
    w = linear_weights(96, 3).numpy()
    assert w.shape == (3, 96)
    np.testing.assert_allclose(w.sum(axis=1), 1.0, rtol=0, atol=1e-6)
    assert (w > 0).sum(axis=1).tolist() == [48, 64, 48]
    box = torch.nn.functional.adaptive_avg_pool1d(
        torch.eye(96)[None], 3)[0].t().numpy()
    assert np.abs(w - box).max() > 0.01


@pytest.mark.parametrize("hw", [(96, 128), (6, 6), (12, 16), (2, 2)])
@pytest.mark.parametrize("nbins", [1, 2, 3, 6])
def test_psp_pool_matches_jax(hw, nbins):
    """The exact reshape-mean where both dims divide, JAX's antialiased
    resize otherwise (``decoders.py:122-132``)."""
    h, w = hw
    x = _map(h, w, c=4, seed=nbins)
    if h % nbins == 0 and w % nbins == 0:
        ref = x.reshape(2, nbins, h // nbins, nbins, w // nbins, 4).mean(
            axis=(2, 4))
    else:
        ref = np.asarray(jax.image.resize(
            jnp.asarray(x), (2, nbins, nbins, 4), method="linear",
            antialias=True))
    got = _port(psp_pool, x, nbins)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
