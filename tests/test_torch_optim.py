"""The port's optimizers (wsiseg_tpu_torch.optim) against the JAX
package's ``build_optimizer`` (optax) in float64, weight decay on:

* adam, sgd and adabound over 5 steps on random parameters and grads,
  rtol 1e-12;
* the optimizer state carried across by
  ``models.flax_import.optimizer_state_from_flax``: after JAX's step 1 on
  a Y-Net's parameters, the port's step from the converted state equals
  JAX's step 2 (so a state trained in JAX continues in the port)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wsiseg_tpu.config import default_config as jax_config
from wsiseg_tpu.models.ynet import build_ynet as jax_build_ynet
from wsiseg_tpu.optim import build_optimizer as jax_build_optimizer
from wsiseg_tpu_torch.config import default_config
from wsiseg_tpu_torch.models.flax_import import (from_flax,
                                                 optimizer_state_from_flax)
from wsiseg_tpu_torch.models.ynet import build_ynet
from wsiseg_tpu_torch.optim import AdaBound, build_optimizer

OPTIMS = ("adam", "sgd", "adabound")
HP = dict(lr=3e-3, weight_decay=1e-2, beta1=0.85, beta2=0.99)


@pytest.fixture(autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("optim", OPTIMS)
def test_optimizer_matches_optax(optim):
    r = np.random.RandomState(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: r.randn(*s) for k, s in shapes.items()}
    tx = jax_build_optimizer(jax_config(optim=optim, **HP))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = build_optimizer(default_config(optim=optim, **HP), tp.values())
    for _ in range(5):
        grads = {k: r.randn(*s) for k, s in shapes.items()}
        upd, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(),
                                   np.asarray(jp[k]), rtol=1e-12,
                                   atol=1e-15, err_msg=f"{optim} {k}")


def test_adabound_scalars_are_jax_f32():
    """AdaBound's bias corrections and band, rounded as JAX's f32
    ``count`` arithmetic rounds them."""
    for t in (1, 2, 7, 1000):
        tf = jnp.asarray(t, jnp.float32)
        ref = (1.0 / (1 - 0.9 ** tf), 1.0 / (1 - 0.999 ** tf),
               0.1 * (1.0 - 1.0 / (1e-3 * tf + 1.0)),
               0.1 * (1.0 + 1.0 / (1e-3 * tf)))
        got = AdaBound.scalars(t, 0.9, 0.999, 0.1, 1e-3)
        assert got == tuple(float(x) for x in ref)


def _ynet_tree(cfg, seed):
    model = jax_build_ynet(cfg)
    shapes = jax.eval_shape(lambda k: model.init(
        k, jnp.zeros((1, 64, 64, 3)), train=False), jax.random.PRNGKey(0))
    r = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: 0.1 * r.randn(*s.shape) + (1.0 if len(s.shape) == 1
                                             else 0.0), dict(shapes))


@pytest.mark.parametrize("optim", OPTIMS)
def test_optimizer_state_carries_from_jax(optim):
    jcfg = jax_config(optim=optim, compute_dtype="float64",
                      param_dtype="float64", **HP)
    variables = _ynet_tree(jcfg, 1)
    g1 = _ynet_tree(jcfg, 2)["params"]
    g2 = _ynet_tree(jcfg, 3)["params"]
    tx = jax_build_optimizer(jcfg)

    @jax.jit
    def update(g, st, p):
        upd, st = tx.update(g, st, p)
        return optax.apply_updates(p, upd), st

    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    params1, st = update(g1, tx.init(params), params)
    params2, _ = update(g2, st, params1)

    after1 = {"params": jax.device_get(params1),
              "batch_stats": variables["batch_stats"]}
    net = build_ynet(default_config(optim=optim, **HP)).double()
    net.load_state_dict(from_flax(after1))
    opt = build_optimizer(default_config(optim=optim, **HP),
                          net.parameters())
    opt.load_state_dict(optimizer_state_from_flax(
        jax.device_get(st), after1, net, opt))
    grads = from_flax({"params": g2,
                       "batch_stats": variables["batch_stats"]})
    for name, p in net.named_parameters():
        p.grad = grads[name]
    opt.step()
    ref = from_flax({"params": jax.device_get(params2),
                     "batch_stats": variables["batch_stats"]})
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=1e-12, atol=1e-15, err_msg=name)
