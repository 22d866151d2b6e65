"""One training step of the port (wsiseg_tpu_torch.train.steps) against
the JAX package's (wsiseg_tpu.train.steps) on the same weights and batch:
a hybrid step of a tiny full-depth resnet18 Unet Y-Net (32² tiles, batch
4: the deepest BatchNorm sees 4 values per channel, where torch's own
running-variance update would differ from flax's by 4/3), with sgd and
weight decay, with the JAX train s2d tail on and off and with
``grad_accum`` 1 and 2. ``grad_accum`` 2 runs at 64², so that each
2-row microbatch's deepest BatchNorm sees 8 values per channel (at 2
values, each normalizes to ±1 and its backward amplifies float64
rounding to ~1e-9). The loss, every new parameter and every new
BatchNorm running statistic agree within 1e-9·max(1, |ref|).
tests/test_torch_train_families.py holds Linknet, FPN, the seg and the
cls steps the same way.

Both sides run in float64. The JAX Y-Net casts its logits (and the s2d
tail its BatchNorm and loss, and the head's tap conv its products) to
``jnp.float32`` whatever the model's dtype; :func:`jax_f64` reads
``jnp.float32`` as float64 in those modules for the test, so the JAX
step is a float64 oracle end to end (the package's files are unchanged).
The flax variables are shaped by ``jax.eval_shape`` of the init and
filled from a seeded numpy generator, BatchNorm statistics included."""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wsiseg_tpu import losses as jax_losses
from wsiseg_tpu.config import default_config as jax_config
from wsiseg_tpu.data.patches import add_s2d_seg_labels
from wsiseg_tpu.models import decoders as jax_decoders
from wsiseg_tpu.models import fastconv as jax_fastconv
from wsiseg_tpu.models import heads as jax_heads
from wsiseg_tpu.models import unet as jax_unet
from wsiseg_tpu.models.ynet import build_ynet as jax_build_ynet
from wsiseg_tpu.optim import build_optimizer as jax_build_optimizer
from wsiseg_tpu.train import steps as jax_steps
from wsiseg_tpu.train.state import TrainState as JaxTrainState
from wsiseg_tpu_torch.config import default_config
from wsiseg_tpu_torch.models.flax_import import from_flax
from wsiseg_tpu_torch.models.ynet import build_ynet
from wsiseg_tpu_torch.optim import build_optimizer
from wsiseg_tpu_torch.train import steps
from wsiseg_tpu_torch.train.state import TrainState

torch.set_num_threads(2)

TILE = 32
REL = 1e-9                      # × max(1, |ref|), float64 both sides
CW = np.array([0.3, 1.0, 0.6, 0.8])      # cls weights
SW = np.array([1.0, 0.5, 0.9, 0.7])      # seg weights
_F32_MODULES = (jax_heads, jax_unet, jax_decoders, jax_fastconv, jax_losses)


@contextlib.contextmanager
def jax_f64():
    """x64 on, and ``jnp.float32`` read as float64 in the JAX modules that
    cast to it."""
    wide = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                    if not k.startswith("__")})
    wide.float32 = jnp.float64
    jax.config.update("jax_enable_x64", True)
    try:
        for m in _F32_MODULES:
            m.jnp = wide
        yield
    finally:
        for m in _F32_MODULES:
            m.jnp = jnp
        jax.config.update("jax_enable_x64", False)


def configs(tile=TILE, **kw):
    """(JAX config, port config), float64, sgd with weight decay."""
    common = dict(tile_w=tile, tile_h=tile, compute_dtype="float64",
                  norm_dtype="float64", param_dtype="float64", optim="sgd",
                  lr=1e-2, weight_decay=1e-4, batch_size=4)
    common.update(kw)
    tail = common.pop("train_s2d_tail", False)
    return (jax_config(train_s2d_tail=tail, train_s2d_loss=tail, **common),
            default_config(**common))


def random_variables(model, seed=0):
    """The flax init's tree (``jax.eval_shape``, nothing compiled) filled
    from ``np.random.RandomState(seed)`` in float64."""
    shapes = jax.eval_shape(lambda k: model.init(
        k, jnp.zeros((1, 64, 64, 3)), train=False),
        jax.random.PRNGKey(0))
    r = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = r.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * r.randn(*leaf.shape)
        elif name == "var":
            v = r.uniform(0.5, 1.5, leaf.shape)
        else:                                   # bias, mean
            v = 0.1 * r.randn(*leaf.shape)
        return np.asarray(v, np.float64)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def hybrid_batch(seed=3, b=4, nc=4, tile=TILE):
    """Rows cls, seg, reg, seg (one task each), normalized f64 images."""
    r = np.random.RandomState(seed)
    return {
        "image": r.randn(b, tile, tile, 3),
        "seg_label": r.randint(0, nc, (b, tile, tile)).astype(np.int32),
        "cls_label": np.array([2, -1, -1, -1], np.int32),
        "reg_label": np.array([0.0, 0.0, 0.7, 0.0]),
        "is_cls": np.array([1.0, 0.0, 0.0, 0.0]),
        "is_reg": np.array([0.0, 0.0, 1.0, 0.0]),
        "is_seg": np.array([0.0, 1.0, 0.0, 1.0]),
    }


def jax_step(kind, jcfg, batch, grad_accum=1, seed=0, variables=None,
             **step_kw):
    """One float64 JAX step of ``kind`` ('hybrid', 'seg' or 'cls') from
    :func:`random_variables` (``seed``), or from ``variables`` as given.
    Returns (the variables, JAX metrics, JAX new state as a port
    state_dict)."""
    with jax_f64():
        model = jax_build_ynet(jcfg)
        if variables is None:
            variables = random_variables(model, seed)
        tx = jax_build_optimizer(jcfg)
        jstate = JaxTrainState.create(variables, tx)
        if kind == "hybrid":
            make = jax_steps.make_hybrid_train_step(
                model, tx, jcfg, grad_accum=grad_accum,
                **{k: jnp.asarray(v) for k, v in step_kw.items()})
        elif kind == "seg":
            make = jax_steps.make_seg_train_step(
                model, tx, jcfg, grad_accum=grad_accum, **step_kw)
        else:
            from wsiseg_tpu.models.ynet import YNet
            make = jax_steps.make_cls_train_step(
                model, tx, jcfg, method=YNet.classify,
                grad_accum=grad_accum, **step_kw)
        jb = add_s2d_seg_labels(dict(batch), jcfg)
        new, jm = jax.jit(make)(jstate, jb, jax.random.PRNGKey(5))
        ref_sd = from_flax(jax.device_get(new.variables()))
        jm = {k: float(v) for k, v in jm.items()}
    return variables, jm, ref_sd


def run_pair(kind, jcfg, tcfg, batch, grad_accum=1, seed=0, **step_kw):
    """One JAX step and one port step of ``kind`` ('hybrid', 'seg' or
    'cls') from the same variables. Returns (JAX metrics, JAX new state
    as a port state_dict, port metrics, port state_dict)."""
    variables, jm, ref_sd = jax_step(kind, jcfg, batch, grad_accum, seed,
                                     **step_kw)
    net = build_ynet(tcfg).double()
    net.load_state_dict(from_flax(variables))
    state = TrainState(net, build_optimizer(tcfg, net.parameters()))
    make = {"hybrid": steps.make_hybrid_train_step,
            "seg": steps.make_seg_train_step,
            "cls": steps.make_cls_train_step}[kind]
    tstep = make(net, tcfg, grad_accum=grad_accum, **step_kw)
    tm = tstep(state, {k: torch.from_numpy(np.asarray(v))
                       for k, v in batch.items()})
    assert state.step == 1
    return jm, ref_sd, {k: float(v) for k, v in tm.items()}, \
        net.state_dict()


def assert_step_close(jm, ref_sd, tm, got_sd, rel=REL):
    """Metrics, parameters and running statistics within rel·max(1,|ref|);
    returns the largest relative difference."""
    assert set(jm) == set(tm), (jm, tm)
    worst = 0.0
    for k in jm:
        d = abs(tm[k] - jm[k]) / max(1.0, abs(jm[k]))
        assert d <= rel, (k, tm[k], jm[k])
        worst = max(worst, d)
    keys = [k for k in ref_sd if not k.endswith("num_batches_tracked")]
    assert set(keys) == {k for k in got_sd
                         if not k.endswith("num_batches_tracked")}
    for k in keys:
        ref = ref_sd[k].double()
        scale = ref.abs().clamp(min=1.0)
        d = ((got_sd[k].double() - ref).abs() / scale).max().item()
        assert d <= rel, (k, d)
        worst = max(worst, d)
    return worst


_RUNS = {}


def hybrid_run(tail, grad_accum, tile):
    """run_pair of the hybrid step, once per case."""
    key = (tail, grad_accum, tile)
    if key not in _RUNS:
        jcfg, tcfg = configs(tile, train_s2d_tail=tail)
        _RUNS[key] = run_pair("hybrid", jcfg, tcfg, hybrid_batch(tile=tile),
                              grad_accum=grad_accum, cls_weights=CW,
                              seg_weights=SW)
    return _RUNS[key]


@pytest.mark.parametrize("tail,grad_accum,tile", [
    (False, 1, 32), (False, 2, 64), (True, 1, 32)])
def test_hybrid_step_matches_jax(tail, grad_accum, tile):
    assert assert_step_close(*hybrid_run(tail, grad_accum, tile)) <= REL


def test_running_variance_is_flax_not_torch():
    """The port's train-mode BatchNorm updates the running variance with
    the biased batch variance, as flax: torch's unbiased update, n/(n−1)
    of it, would miss the JAX step's statistics by far more than the
    tolerance at this batch (4 values per channel at c5)."""
    _, ref, _, got = hybrid_run(False, 1, 32)
    key = "encoder.layer4.1.bn2.running_var"
    with jax_f64():
        start = from_flax(random_variables(jax_build_ynet(configs()[0])))
    kept = 0.9 * start[key]
    torch_like = kept + (ref[key] - kept) * 4 / 3
    assert (torch_like - ref[key]).abs().max().item() > 1e3 * REL
    torch.testing.assert_close(got[key], ref[key], rtol=REL, atol=REL)


@pytest.mark.parametrize("shape", [(4, 5, 6, 3), (1, 1, 1, 3)])
def test_batchnorm_trains_as_flax(shape):
    """``models.resnet.BatchNorm2d`` in train mode against flax's
    ``nn.BatchNorm`` (momentum 0.9): output, input gradient and running
    statistics, float64; one value per channel too (a PSPNet bin of a
    1-row batch), where torch's own BatchNorm refuses to train."""
    import flax.linen as fnn
    from wsiseg_tpu_torch.models.resnet import BatchNorm2d
    r = np.random.RandomState(0)
    x, g = r.randn(*shape) * 2 + 1, r.randn(*shape)
    scale, bias = 1 + 0.1 * r.randn(3), 0.1 * r.randn(3)
    mean0, var0 = 0.1 * r.randn(3), r.uniform(0.5, 1.5, 3)
    with jax_f64():
        bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5, dtype=jnp.float64,
                           param_dtype=jnp.float64)
        v = {"params": {"scale": scale, "bias": bias},
             "batch_stats": {"mean": mean0, "var": var0}}

        def f(xx, pp):
            y, m = bn.apply({"params": pp,
                             "batch_stats": v["batch_stats"]}, xx,
                            mutable=["batch_stats"])
            return jnp.sum(y * g), (y, m)

        (_, (y, m)), (gx, gp) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), v["params"])
        y, gx = np.asarray(y), np.asarray(gx)
        stats = {k: np.asarray(a) for k, a in m["batch_stats"].items()}
        gscale = np.asarray(gp["scale"])
    t = BatchNorm2d(3).double().train()
    with torch.no_grad():
        t.weight.copy_(torch.from_numpy(scale))
        t.bias.copy_(torch.from_numpy(bias))
        t.running_mean.copy_(torch.from_numpy(mean0))
        t.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    yt = t(xt)
    (yt * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    close = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(yt.detach().permute(0, 2, 3, 1).numpy(), y,
                               **close)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), gx,
                               **close)
    np.testing.assert_allclose(t.weight.grad.numpy(), gscale, **close)
    np.testing.assert_allclose(t.running_mean.numpy(), stats["mean"],
                               **close)
    np.testing.assert_allclose(t.running_var.numpy(), stats["var"],
                               **close)
