"""Port's whole-image fast path (wsiseg_tpu_torch.models.fast_decoder /
fast_encoder / infer_fast) against the JAX package: the exact s2d weight
transforms element by element, encode_stages + decode_cells in f32,
decode_fold against the JAX decode_fold (Pallas kernels in interpret
mode), and the whole-image forward against flax YNet.segment."""

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


@pytest.fixture(scope="module")
def fold_case(models):
    """The 96×64 f32 Y-Net pyramid of tests/test_fast_decoder.py's
    decode_fold parity test, from one seeded input."""
    model, variables, m = models
    x = jnp.asarray(np.random.RandomState(0).randn(1, 96, 64, 3).astype(
        np.float32))
    feats = model.apply(variables, x, method=FlaxYNet.encode)
    tf = [torch.from_numpy(np.array(f)).permute(0, 3, 1, 2) for f in feats]
    return variables, feats, tf, tfd.prepare_fold(m, torch.float32)


@pytest.mark.parametrize("use_chain", [True, False])
def test_decode_fold_matches_jax(fold_case, use_chain):
    """The port's decode_fold (plain kernel versions on the CPU) against
    the JAX decode_fold in interpret mode, planar s2d(2) head, f32.
    With use_chain both round to bf16 at the five group outputs and the
    port is within atol = rtol = 2e-3 everywhere. Without it, every one of
    the 11 convs rounds its output to bf16, and a one-ulp flip where the
    two f32 sums straddle a rounding boundary carries on to the logits:
    measured 34-50 of 24,576 values past 2e-3, max 3.4e-3. There, 99.5 %
    must be within 2e-3 and all within 2^-6·max|ref| (four bf16 ulps at
    the logits' range)."""
    variables, feats, tf, prep = fold_case
    ref = np.asarray(jfd.decode_fold(variables, feats, jnp.float32, br=8,
                                     wc=16, use_chain=use_chain,
                                     planar_head=True, interpret=True))
    with torch.no_grad():
        got = tfd.decode_fold(prep, tf, torch.float32, use_chain=use_chain,
                              planar_head=True)
    assert got.shape == (1, 16, 48, 32) and got.dtype == torch.float32
    got = got[0].permute(1, 2, 0).numpy()
    if use_chain:
        np.testing.assert_allclose(got, ref, atol=2e-3, rtol=2e-3)
    else:
        d = np.abs(got - ref)
        assert (d <= 2e-3 + 2e-3 * np.abs(ref)).mean() >= 0.995
        assert d.max() <= 2.0 ** -6 * np.abs(ref).max()
    with torch.no_grad():
        native = tfd.decode_fold(prep, tf, torch.float32,
                                 use_chain=use_chain)
    torch.testing.assert_close(
        native, tfd.depth_to_space(torch.from_numpy(got).permute(
            2, 0, 1)[None], 2), rtol=0, atol=0)


def test_prepare_fold_layers(models):
    """Group shapes of prepare_fold: blocks 0-1 native, blocks 2-3 and
    block4 + head in s2d(2), the head without ReLU."""
    _, _, m = models
    prep = tfd.prepare_fold(m, torch.bfloat16)
    shapes = {k: [(tuple(w.shape), b.dtype, r) for w, b, r in v]
              for k, v in prep.items()}
    f32 = torch.float32
    assert shapes == {
        "b0": [((256, 9, 768), f32, True), ((256, 9, 256), f32, True)],
        "b1": [((128, 9, 384), f32, True), ((128, 9, 128), f32, True)],
        "b2": [((256, 9, 384), f32, True), ((256, 9, 256), f32, True)],
        "b3": [((128, 9, 320), f32, True), ((128, 9, 128), f32, True)],
        "b4": [((64, 9, 32), f32, True), ((64, 9, 64), f32, True),
               ((16, 9, 64), f32, False)]}
    assert all(w.dtype == torch.bfloat16 for v in prep.values()
               for w, _, _ in v)


def test_whole_image_fold_forward(cfg, models):
    """The fold route's whole-image forward agrees with the default route
    (f32 oracle run: the stems' folded weights are bf16 by contract, the
    rest f32) and has the s2d(2) planar head layout."""
    _, _, m = models
    img = np.random.RandomState(8).randint(0, 256, (64, 96, 3)).astype(
        np.uint8)
    ref = segment_whole_image(m, img, cfg.dataset_mean, cfg.dataset_std,
                              dtype=torch.float32).numpy()
    got = segment_whole_image(m, img, cfg.dataset_mean, cfg.dataset_std,
                              dtype=torch.float32, fold=True).numpy()
    assert got.shape == ref.shape == (64, 96, 4)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-2 * np.abs(ref).max())
    planar = segment_whole_image(m, img, cfg.dataset_mean, cfg.dataset_std,
                                 dtype=torch.float32, planar_head=True,
                                 fold=True)
    assert planar.shape == (32, 48, 16)
