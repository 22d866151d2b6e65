"""Port's whole-image fast path (wsiseg_tpu_torch.models.fast_decoder /
fast_encoder / infer_fast) against the JAX package: the exact s2d weight
transforms element by element, encode_stages + decode_cells in f32, and
the whole-image forward against flax YNet.segment."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wsiseg_tpu.config import default_config
from wsiseg_tpu.models import fast_decoder as jfd
from wsiseg_tpu.models.fast_encoder import encode_stages as jax_encode
from wsiseg_tpu.models.ynet import YNet as FlaxYNet
from wsiseg_tpu.models.ynet import init_ynet as flax_init_ynet
from wsiseg_tpu.ops.color import normalize
from wsiseg_tpu_torch.models import fast_decoder as tfd
from wsiseg_tpu_torch.models.fast_encoder import (encode_stages,
                                                  prepare_encoder)
from wsiseg_tpu_torch.models.flax_import import from_flax
from wsiseg_tpu_torch.models.infer_fast import segment_whole_image
from wsiseg_tpu_torch.models.ynet import build_ynet

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cfg():
    return default_config(compute_dtype="float32")


@pytest.fixture(scope="module")
def models(cfg):
    model, variables = flax_init_ynet(cfg, jax.random.PRNGKey(1),
                                      tile_hw=(64, 64))
    m = build_ynet(cfg).eval()
    m.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray,
                                                       dict(variables))))
    return model, variables, m


def _w(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("name,args", [
    ("s2d_kernel_f", (2,)), ("s2d_kernel_f", (4,)),
    ("upfold_kernel", ()), ("upfold2_kernel", ())])
def test_kernel_transforms_equal_jax(name, args):
    w = _w((3, 3, 5, 6))
    ref = np.asarray(getattr(jfd, name)(jnp.asarray(w), *args))
    got = getattr(tfd, name)(torch.from_numpy(w), *args).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("f", [2, 4])
def test_space_to_depth_jax_order(f):
    x = _w((2, 8, 16, 3), seed=f)
    ref = np.asarray(jfd.space_to_depth(jnp.asarray(x), f))
    t = torch.from_numpy(x).permute(0, 3, 1, 2)     # logical NCHW
    got = tfd.space_to_depth(t, f)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    back = tfd.depth_to_space(got, f).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(back, x)
    # the trap this layout avoids: pixel_unshuffle orders c·f² + α·f + β
    assert not torch.equal(got, torch.nn.functional.pixel_unshuffle(t, f))


def test_encode_decode_cells_match_jax_f32(models):
    model, variables, m = models
    r = np.random.RandomState(2)
    h = w = 64
    pool = np.abs(r.randn(1, h // 4, w // 4, 64)).astype(np.float32)
    c1s2d = np.abs(r.randn(1, h // 4, w // 4, 256)).astype(np.float32)
    ep, eb = variables["params"]["encoder"], variables["batch_stats"][
        "encoder"]
    jf = jax_encode(ep, eb, None, (2, 2, 2, 2), jnp.float32,
                    pooled=jnp.asarray(pool))
    ref = np.asarray(jfd.decode_cells(variables, jf, jnp.float32,
                                      s2d_head=True,
                                      skip3_s2d=jnp.asarray(c1s2d)))
    with torch.no_grad():
        tf = encode_stages(prepare_encoder(m.encoder, torch.float32),
                           torch.from_numpy(pool).permute(0, 3, 1, 2),
                           torch.float32)
        got = tfd.decode_cells(
            tfd.prepare_decoder(m, torch.float32), tf, torch.float32,
            s2d_head=True, skip3_s2d=torch.from_numpy(c1s2d).permute(
                0, 3, 1, 2))
    for a, b in zip(jf[:4], tf[:4]):
        a = np.asarray(a)
        np.testing.assert_allclose(b.permute(0, 2, 3, 1).numpy(), a,
                                   rtol=0, atol=1e-4 * np.abs(a).max())
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (1, h // 4, w // 4, 64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_decode_cells_native_head_is_depth_to_space(models):
    _, _, m = models
    r = np.random.RandomState(3)
    feats = [torch.from_numpy(np.abs(r.randn(1, c, s, s)).astype(np.float32))
             for c, s in ((512, 1), (256, 2), (128, 4), (64, 8))]
    c1s2d = torch.from_numpy(np.abs(r.randn(1, 256, 8, 8)).astype(
        np.float32))
    prep = tfd.prepare_decoder(m, torch.float32)
    with torch.no_grad():
        planar = tfd.decode_cells(prep, feats + [None], torch.float32,
                                  s2d_head=True, skip3_s2d=c1s2d)
        native = tfd.decode_cells(prep, feats + [None], torch.float32,
                                  skip3_s2d=c1s2d)
    assert native.shape == (1, 4, 32, 32)
    torch.testing.assert_close(tfd.depth_to_space(planar, 4), native)


def test_whole_image_forward_matches_flax_segment(cfg, models):
    """Fused-stem forward in f32 (stem outputs and folded weights are bf16
    by contract) against flax YNet.segment on the normalized image.
    Interior only: the stem pads with round(255·mean), within
    0.5/255/std of normalized zero, and 16 px of border are cropped."""
    model, variables, m = models
    h, w = 64, 128
    img = np.random.RandomState(4).randint(0, 256, (h, w, 3)).astype(
        np.uint8)
    x = normalize(jnp.asarray(img, jnp.float32)[None] / 255.0,
                  cfg.dataset_mean, cfg.dataset_std)
    ref = np.asarray(model.apply(variables, x, method=FlaxYNet.segment))[0]
    got = segment_whole_image(m, img, cfg.dataset_mean, cfg.dataset_std,
                              dtype=torch.float32).numpy()
    assert got.shape == ref.shape == (h, w, 4)
    c = 16
    np.testing.assert_allclose(got[c:-c, c:-c], ref[c:-c, c:-c], rtol=0,
                               atol=1e-3 * np.abs(ref).max())
    planar = segment_whole_image(m, img, cfg.dataset_mean, cfg.dataset_std,
                                 dtype=torch.float32, planar_head=True)
    assert planar.shape == (h // 4, w // 4, 64)
