"""Port's Y-Net and weight bridge (wsiseg_tpu_torch.models) against the
flax Y-Net: from_flax loads strictly, is the exact inverse of
models.torch_import.convert_ynet_state_dict, gives the same f32 segment
forward, and .pt checkpoints round-trip."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wsiseg_tpu.config import default_config
from wsiseg_tpu.models.torch_import import convert_ynet_state_dict
from wsiseg_tpu.models.ynet import YNet as FlaxYNet
from wsiseg_tpu.models.ynet import init_ynet as flax_init_ynet
from wsiseg_tpu_torch.models.flax_import import from_flax
from wsiseg_tpu_torch.models.ynet import build_ynet, init_ynet
from wsiseg_tpu_torch.train.state import (checkpoint_path,
                                          latest_checkpoint,
                                          restore_checkpoint,
                                          save_checkpoint)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cfg():
    return default_config(compute_dtype="float32")


@pytest.fixture(scope="module")
def flax_pair(cfg):
    model, variables = flax_init_ynet(cfg, jax.random.PRNGKey(0),
                                      tile_hw=(64, 64))
    return model, variables, jax.tree_util.tree_map(np.asarray,
                                                    dict(variables))


@pytest.fixture(scope="module")
def port_model(cfg, flax_pair):
    m = build_ynet(cfg).eval()
    m.load_state_dict(from_flax(flax_pair[2]), strict=True)
    return m


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def test_from_flax_loads_strict(cfg, flax_pair):
    sd = from_flax(flax_pair[2])
    m = build_ynet(cfg)
    missing, unexpected = m.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    assert sd["encoder.conv1.weight"].shape == (64, 3, 7, 7)
    assert sd["segmentation_head.0.weight"].shape == (4, 16, 3, 3)


def test_convert_back_is_exact(flax_pair, port_model):
    """convert_ynet_state_dict(port state_dict) gives back every JAX leaf
    bit for bit — the existing converter is from_flax's exact inverse."""
    sd = {k: v.numpy() for k, v in port_model.state_dict().items()}
    back = convert_ynet_state_dict(sd)
    orig = flax_pair[2]
    for col in ("params", "batch_stats"):
        got = dict(_leaves(back[col]))
        want = dict(_leaves(orig[col]))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_segment_matches_flax_f32(flax_pair, port_model):
    model, variables, _ = flax_pair
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    ref = np.asarray(model.apply(variables, jnp.asarray(x),
                                 method=FlaxYNet.segment))
    with torch.no_grad():
        got = port_model.segment(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 64, 64, 4)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_full_forward_heads(flax_pair, port_model):
    """The classifier and regressor heads convert too (whole tree)."""
    model, variables, _ = flax_pair
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    ref = model.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port_model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for key in ("cls", "reg"):
        r = np.asarray(ref[key])
        np.testing.assert_allclose(got[key].numpy(), r, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(r).max()))


def test_init_ynet_uses_generator_only(cfg):
    a = init_ynet(cfg, torch.Generator().manual_seed(5))
    b = init_ynet(cfg, torch.Generator().manual_seed(5))
    c = init_ynet(cfg, torch.Generator().manual_seed(6))
    wa, wb, wc = (m.encoder.layer2[0].conv1.weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    # LeCun-normal scale, as flax's default kernel init
    fan_in = 64 * 9
    assert abs(wa.std().item() - fan_in ** -0.5) < 0.1 * fan_in ** -0.5
    assert not a.training


def test_pt_checkpoint_roundtrip(cfg, port_model, tmp_path):
    pth = save_checkpoint(port_model, str(tmp_path), "resnet18", 7)
    assert pth == checkpoint_path(str(tmp_path), "resnet18", 7)
    assert pth.endswith("model_resnet18_7.pt")
    save_checkpoint(port_model, str(tmp_path), "resnet18", 3)
    assert latest_checkpoint(str(tmp_path)) == pth
    assert latest_checkpoint(str(tmp_path / "model_resnet18_7")) == pth
    fresh = init_ynet(cfg, torch.Generator().manual_seed(9))
    restored, start = restore_checkpoint(pth, fresh)
    assert start == 8
    for (k, v), (k2, v2) in zip(port_model.state_dict().items(),
                                restored.state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k


def test_convert_flax_checkpoint_script(tmp_path):
    """scripts/convert_flax_checkpoint.py: flax .msgpack → port .pt that
    the port restores with the same weights and epoch."""
    import importlib.util

    from wsiseg_tpu.cli.common import setup_ynet
    from wsiseg_tpu.train.state import save_checkpoint as flax_save

    cfg = default_config(model_save_pth=str(tmp_path / "jax"))
    _, _, state, _ = setup_ynet(cfg, tile_hw=(64, 64))
    src = flax_save(state, cfg, 12)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "convert_flax_checkpoint",
        os.path.join(repo, "scripts", "convert_flax_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main([src, str(tmp_path / "pt")])
    assert out.endswith("model_resnet18_12.pt")
    model, start = restore_checkpoint(
        latest_checkpoint(str(tmp_path / "pt")),
        init_ynet(cfg, torch.Generator().manual_seed(1)))
    assert start == 13
    k = np.asarray(state.params["decoder"]["block3"]["conv2"]["kernel"])
    np.testing.assert_array_equal(
        model.decoder.blocks[3].conv2[0].weight.detach().numpy(),
        k.transpose(3, 2, 0, 1))
