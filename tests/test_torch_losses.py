"""The port's losses (wsiseg_tpu_torch.losses) and color jitter
(wsiseg_tpu_torch.ops.color) against the JAX package's on the same
seeded numpy inputs.

Losses: every loss of ``_REGISTRY``, through ``loss_fn``, on dense
(B, C, H, W) logits (JAX: NHWC) and on (B, C) logits, with class weights,
``ignore_index`` and ``sample_weight`` where the loss takes them, in
float64 (x64 on for the JAX side), rtol 1e-10. JAX computes the dense
ones class-major and the (B, C) ones flat; the port computes both
plainly.

Color: ``hsv_to_rgb``, and the jitter's apply step fed JAX's own factors,
which the test draws by replaying ``batch_color_jitter``'s
``jax.random.split`` / ``uniform`` calls; float32, atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wsiseg_tpu import losses as jl
from wsiseg_tpu.ops import color as jcolor
from wsiseg_tpu_torch import losses as tl
from wsiseg_tpu_torch.ops import color as tcolor

RTOL = 1e-10
C = 4
CW = np.array([0.5, 1.0, 0.25, 0.8])
SW = np.array([1.0, 0.0, 0.6, 1.0])

# name → kwargs each loss takes (class_weights, ignore_index, ...)
CLASS_LOSSES = {
    "xent": {"class_weights": CW, "ignore_index": -1},
    "focal": {"class_weights": CW, "gamma": 1.5},
    "ohem": {"ratio": 0.3},
    "cent": {"class_weights": CW},
    "dice": {"class_weights": CW, "ignore_index": -1},
    "jaccard": {},
    "tversky": {"alpha": 0.7, "beta": 0.4},
}
REG_LOSSES = ("mse", "l1", "rmse", "logcosh", "xtanh", "xsigmoid")


@pytest.fixture(autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _inputs(dense: bool, ignore: bool, seed=0):
    r = np.random.RandomState(seed)
    shape = (4, 32, 32) if dense else (4,)
    logits = 2.0 * r.randn(*shape, C)                      # classes last
    targets = r.randint(0, C, shape)
    if ignore:
        targets[r.rand(*shape) < 0.2] = -1
    return logits, targets


def _both(name, logits, targets, kw, sample_weight):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = dict(kw)
    if sample_weight is not None:
        jkw["sample_weight"] = jnp.asarray(sample_weight)
        tkw["sample_weight"] = torch.from_numpy(sample_weight)
    ref = float(jl.loss_fn(name, **jkw)(jnp.asarray(logits),
                                         jnp.asarray(targets)))
    nchw = np.moveaxis(logits, -1, 1)
    got = float(tl.loss_fn(name, **tkw)(torch.from_numpy(nchw),
                                         torch.from_numpy(targets)))
    return got, ref


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("name", sorted(CLASS_LOSSES))
def test_class_losses_match_jax(name, dense, weighted):
    kw = CLASS_LOSSES[name] if weighted else {}
    logits, targets = _inputs(dense, ignore="ignore_index" in kw)
    got, ref = _both(name, logits, targets, kw, SW if weighted else None)
    assert np.isfinite(ref)
    np.testing.assert_allclose(got, ref, rtol=RTOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_bce_matches_jax(weighted):
    r = np.random.RandomState(1)
    probs, targets = r.rand(4, 8), (r.rand(4, 8) > 0.5).astype(np.float64)
    probs[0, 0], probs[1, 1] = 0.0, 1.0           # the clip
    sw = SW if weighted else None
    ref = float(jl.bce(jnp.asarray(probs), jnp.asarray(targets),
                       None if sw is None else jnp.asarray(sw)))
    got = float(tl.bce(torch.from_numpy(probs), torch.from_numpy(targets),
                       None if sw is None else torch.from_numpy(sw)))
    np.testing.assert_allclose(got, ref, rtol=RTOL)


@pytest.mark.parametrize("shape", [(4,), (4, 3)])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", REG_LOSSES)
def test_regression_losses_match_jax(name, weighted, shape):
    r = np.random.RandomState(2)
    pred, target = r.randn(*shape), r.randn(*shape)
    sw = SW if weighted else None
    ref = float(jl.loss_fn(name)(jnp.asarray(pred), jnp.asarray(target),
                                 None if sw is None else jnp.asarray(sw)))
    got = float(tl.loss_fn(name)(torch.from_numpy(pred),
                                 torch.from_numpy(target),
                                 None if sw is None
                                 else torch.from_numpy(sw)))
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_zeroloss_and_registry():
    assert sorted(tl._REGISTRY) == sorted(jl._REGISTRY)
    assert float(tl.loss_fn("zeroloss")(torch.ones(2), torch.ones(2))) == 0
    with pytest.raises(KeyError):
        tl.loss_fn("nope")


def test_loss_gradients_match_jax():
    """The masked, weighted dense xent's gradient w.r.t. the logits (what
    every train step backpropagates) agrees too."""
    logits, targets = _inputs(True, ignore=True, seed=3)
    cw, sw = jnp.asarray(CW), jnp.asarray(SW)
    ref = np.asarray(jax.grad(lambda x: jl.cross_entropy(
        x, jnp.asarray(targets), cw, -1, sw))(jnp.asarray(logits)))
    x = torch.from_numpy(np.moveaxis(logits, -1, 1).copy()).requires_grad_()
    tl.cross_entropy(x, torch.from_numpy(targets), CW, -1,
                     torch.from_numpy(SW)).backward()
    np.testing.assert_allclose(np.moveaxis(x.grad.numpy(), 1, -1), ref,
                               rtol=RTOL, atol=1e-15)


# ---- color ----

@pytest.fixture
def f32():
    jax.config.update("jax_enable_x64", False)


def test_hsv_to_rgb_matches_jax(f32):
    r = np.random.RandomState(4)
    hsv = r.rand(16, 16, 3).astype(np.float32)
    hsv[0, :6, 0] = np.arange(6) / 6.0                 # sector borders
    ref = np.asarray(jcolor.hsv_to_rgb(jnp.asarray(hsv)))
    got = tcolor.hsv_to_rgb(torch.from_numpy(hsv)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    rgb = r.rand(16, 16, 3).astype(np.float32)
    back = tcolor.hsv_to_rgb(tcolor.rgb_to_hsv(torch.from_numpy(rgb)))
    np.testing.assert_allclose(back.numpy(), rgb, atol=1e-6)


def _jax_factors(key, n, brightness=0.25, contrast=0.75, saturation=0.25,
                 hue=0.04):
    """``batch_color_jitter``'s draws, replayed: split(key, n), then each
    image's split(k, 4) and four uniforms."""
    out = []
    for k in jax.random.split(key, n):
        kb, kc, ks, kh = jax.random.split(k, 4)
        out.append([
            float(jax.random.uniform(kb, (), minval=1 - brightness,
                                     maxval=1 + brightness)),
            float(jax.random.uniform(kc, (), minval=1 - contrast,
                                     maxval=1 + contrast)),
            float(jax.random.uniform(ks, (), minval=1 - saturation,
                                     maxval=1 + saturation)),
            float(jax.random.uniform(kh, (), minval=-hue, maxval=hue))])
    return np.asarray(out, np.float32)


def test_color_jitter_apply_matches_jax(f32):
    r = np.random.RandomState(5)
    rgb = r.rand(3, 24, 20, 3).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jcolor.batch_color_jitter(jnp.asarray(rgb), key))
    got = tcolor.apply_color_jitter(torch.from_numpy(rgb),
                                    torch.from_numpy(_jax_factors(key, 3)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def test_jitter_factors_in_range_and_seeded():
    g = torch.Generator().manual_seed(3)
    f = tcolor.draw_jitter_factors(1000, g)
    lo, hi = f.min(0).values, f.max(0).values
    assert (lo >= torch.tensor([0.75, 0.25, 0.75, -0.04])).all()
    assert (hi <= torch.tensor([1.25, 1.75, 1.25, 0.04])).all()
    again = tcolor.draw_jitter_factors(1000, torch.Generator().manual_seed(3))
    assert torch.equal(f, again)


def test_gradient_reversal_matches_jax():
    """Identity forward, -scale·grad backward, as JAX's custom VJP."""
    from wsiseg_tpu.models.heads import gradient_reversal as jax_gr
    from wsiseg_tpu_torch.models.heads import gradient_reversal
    r = np.random.RandomState(6)
    x, w = r.randn(3, 4), r.randn(3, 4)
    ref = np.asarray(jax.grad(lambda a: jnp.sum(
        jax_gr(a, 0.3) * jnp.asarray(w)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    y = gradient_reversal(xt, 0.3)
    assert torch.equal(y.detach(), xt.detach())
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), ref, rtol=RTOL)
