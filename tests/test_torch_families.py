"""The port's other model families (wsiseg_tpu_torch.models: Bottleneck
encoders, Linknet / FPN / PSPNet decoders) against the flax Y-Net on the
same weights: from_flax loads strictly and is the exact inverse of
models.torch_import.convert_ynet_state_dict, the f32 forwards agree (both
PSPNet pooling branches), the fast path's modules (Bottleneck stages,
Linknet's cell-domain tail, FPN / PSPNet on prepared weights, the native
logits' plane layout) agree with their JAX functions, and the fold route
refuses what it cannot serve. tests/test_torch_families_engine.py holds
the whole-image forward and the engine against JAX on these weights.

The flax variables are shaped by ``jax.eval_shape`` of the flax init and
filled from a seeded numpy generator: random kernels, biases and
BatchNorm statistics (not the identity BN of a fresh init)."""

import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wsiseg_tpu.config import default_config
from wsiseg_tpu.infer.engine import DenseInferenceEngine as JaxEngine
from wsiseg_tpu.models import fast_decoder as jfd
from wsiseg_tpu.models.decoders import FPNDecoder as FlaxFPN
from wsiseg_tpu.models.decoders import PSPDecoder as FlaxPSP
from wsiseg_tpu.models.fast_encoder import encode_stages as jax_encode
from wsiseg_tpu.models.resnet import ENCODER_SPECS
from wsiseg_tpu.models.torch_import import convert_ynet_state_dict
from wsiseg_tpu.models.ynet import YNet as FlaxYNet
from wsiseg_tpu.models.ynet import build_ynet as flax_build_ynet
from wsiseg_tpu.slides import SyntheticSlide
from wsiseg_tpu_torch.data.wsi_tiles import plan_slide
from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
from wsiseg_tpu_torch.models import fast_decoder as tfd
from wsiseg_tpu_torch.models.fast_encoder import (encode_stages,
                                                  prepare_encoder)
from wsiseg_tpu_torch.models.flax_import import from_flax
from wsiseg_tpu_torch.models.infer_fast import (prepare_fast,
                                                segment_whole_image)
from wsiseg_tpu_torch.models.ynet import build_ynet, init_ynet

torch.set_num_threads(2)

FAMILIES = ("Unet", "Linknet", "FPN", "PSPNet")
CASES = [(f, a) for f in FAMILIES for a in ("resnet18", "resnet50")] + [
    ("Linknet", "resnet101")]
F32_TOL = 1e-4                  # × max|ref|, f32 forwards


def _random_variables(model, seed):
    """The flax init's tree (by ``jax.eval_shape``, nothing compiled),
    filled from ``np.random.RandomState(seed)``: LeCun-scaled kernels,
    small biases, BN scale near 1, random running means and variances."""
    shapes = jax.eval_shape(lambda k: model.init(
        k, jnp.zeros((1, 64, 64, 3)), train=False), jax.random.PRNGKey(0))
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
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


_PAIRS = {}


def _pair(family, arch):
    """(flax model, numpy variables, port YNet loaded by from_flax), f32."""
    key = (family, arch)
    if key not in _PAIRS:
        cfg = default_config(compute_dtype="float32", model_name=family,
                             arch_encoder=arch)
        model = flax_build_ynet(cfg)
        variables = _random_variables(
            model, seed=zlib.crc32(f"{family}/{arch}".encode()))
        port = build_ynet(cfg).eval()
        port.load_state_dict(from_flax(variables), strict=True)
        _PAIRS[key] = (model, variables, port)
    return _PAIRS[key]


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("family,arch", CASES)
def test_from_flax_strict_and_exact_inverse(family, arch):
    """from_flax fills every key of the port's Y-Net (strict), and
    convert_ynet_state_dict of the port's state_dict gives back every flax
    leaf bit for bit."""
    _, variables, port = _pair(family, arch)
    sd = from_flax(variables)
    missing, unexpected = build_ynet(default_config(
        model_name=family, arch_encoder=arch)).load_state_dict(sd)
    assert not missing and not unexpected
    back = convert_ynet_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()})
    for col in ("params", "batch_stats"):
        got, want = dict(_leaves(back[col])), dict(_leaves(variables[col]))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n_blocks = sum(ENCODER_SPECS[arch][1])
    assert sum(k.endswith("conv1.weight") and k.startswith("encoder.layer")
               for k in sd) == n_blocks


@pytest.mark.parametrize("family,arch,hw", [
    (f, a, (96, 128)) for f, a in CASES] + [
    ("PSPNet", "resnet18", (192, 192)), ("PSPNet", "resnet50", (192, 192))])
def test_forward_matches_flax_f32(family, arch, hw):
    """Full three-head forward (seg, cls, reg) in f32 against the flax
    Y-Net on the same normalized input. PSPNet takes both pooling
    branches: at 96×128 c5 is 3×4 and bins 2, 3 and 6 go through the
    antialiased resize; at 192² c5 is 6×6 and every bin is exact."""
    model, variables, port = _pair(family, arch)
    x = np.random.RandomState(hw[0]).randn(2, *hw, 3).astype(np.float32)
    ref = model.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(_nchw(x))
    for key in ("seg", "cls", "reg"):
        r = np.asarray(ref[key])
        g = _nhwc(got[key]) if key == "seg" else got[key].numpy()
        assert g.shape == r.shape, key
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=F32_TOL * np.abs(r).max(),
                                   err_msg=key)


@pytest.mark.parametrize("arch", ["resnet50", "resnet101"])
def test_bottleneck_stages_match_jax_f32(arch):
    """encode_stages on Bottleneck weights (no layer-1 fold) against the
    JAX encode_stages(bottleneck=True), from the stem's pooled output."""
    _, variables, port = _pair("Linknet", arch)
    prep = prepare_encoder(port.encoder, torch.float32)
    assert {p["kind"] for blocks in prep for p in blocks} == {"bottleneck"}
    pool = np.abs(np.random.RandomState(2).randn(1, 16, 24, 64)).astype(
        np.float32)
    ep = variables["params"]["encoder"]
    eb = variables["batch_stats"]["encoder"]
    ref = jax_encode(ep, eb, None, ENCODER_SPECS[arch][1], jnp.float32,
                     pooled=jnp.asarray(pool), bottleneck=True)
    with torch.no_grad():
        got = encode_stages(prep, _nchw(pool), torch.float32)
    for r, g in zip(ref[:4], got[:4]):
        r = np.asarray(r)
        np.testing.assert_allclose(_nhwc(g), r, rtol=0,
                                   atol=F32_TOL * np.abs(r).max())
    assert got[0].shape == (1, 2048, 2, 3)


def test_block_diag_matches_jax():
    w = np.random.RandomState(0).randn(1, 1, 5, 3).astype(np.float32)
    for f2 in (4, 16):
        np.testing.assert_array_equal(
            tfd._block_diag_1x1(torch.from_numpy(w), f2).numpy(),
            np.asarray(jfd._block_diag_1x1(jnp.asarray(w), f2)))


def _encoder_feats(family, arch, hw, seed):
    model, variables, _ = _pair(family, arch)
    x = np.random.RandomState(seed).randn(1, *hw, 3).astype(np.float32)
    feats = model.apply(variables, jnp.asarray(x), method=FlaxYNet.encode)
    return feats, [_nchw(f) for f in feats]


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_decode_linknet_cells_matches_jax_f32(arch):
    """The cell-domain Linknet tail against the JAX decode_linknet_cells,
    s2d(4) head planes from the s2d(c1) skip, and the native head is
    their depth_to_space."""
    _, variables, port = _pair("Linknet", arch)
    feats, tf = _encoder_feats("Linknet", arch, (64, 96), 3)
    c1s2d = jfd.space_to_depth(feats[4])
    ref = np.asarray(jfd.decode_linknet_cells(
        variables, feats, jnp.float32, s2d_head=True, skip3_s2d=c1s2d))
    prep = tfd.prepare_linknet(port, torch.float32)
    with torch.no_grad():
        planar = tfd.decode_linknet_cells(prep, tf[:4] + [None],
                                          torch.float32, s2d_head=True,
                                          skip3_s2d=_nchw(c1s2d))
        native = tfd.decode_linknet_cells(prep, tf, torch.float32)
    assert planar.shape == (1, 64, 16, 24)
    np.testing.assert_allclose(_nhwc(planar), ref, rtol=0,
                               atol=F32_TOL * np.abs(ref).max())
    torch.testing.assert_close(tfd.depth_to_space(planar, 4), native,
                               rtol=0, atol=0)


@pytest.mark.parametrize("family,arch", [
    (f, a) for f in ("FPN", "PSPNet") for a in ("resnet18", "resnet50")])
def test_decode_native_matches_flax_f32(family, arch):
    """decode_native (prepared weights) against the flax decoder applied
    in f32 on the same pyramid: (N, nc, H, W) logits at full resolution
    (PSPNet: c5 3×4, bins 2, 3 and 6 by the antialiased resize)."""
    _, variables, port = _pair(family, arch)
    feats, tf = _encoder_feats(family, arch, (96, 128), 4)
    cls = FlaxFPN if family == "FPN" else FlaxPSP
    ref = np.asarray(cls(num_classes=4, dtype=jnp.float32).apply(
        {"params": variables["params"]["decoder"],
         "batch_stats": variables["batch_stats"]["decoder"]}, feats))
    with torch.no_grad():
        got = tfd.decode_native(tfd.prepare_native(port, torch.float32), tf,
                                torch.float32)
    assert got.shape == (1, 4, 96, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), ref, rtol=0,
                               atol=F32_TOL * np.abs(ref).max())


def test_postprocess_native_planes_matches_jax():
    """FPN/PSPNet logits at full resolution, laid out as the planes the
    fused forward gives (``space_to_depth(seg, 4)``), through
    ``_postprocess_s2d`` → the (16, H/4, W/4) planes of the JAX engine's
    _postprocess_native_planes: equal labels, heat within 1/255."""
    cfg = default_config(class_probs=(0.1, 0.3, 0.2, 0.25))
    r = np.random.RandomState(6)
    seg = (r.randn(2, 32, 48, 4) * 2).astype(np.float32)
    mask = (r.rand(2, 8, 12) > 0.3).astype(np.uint8)
    stub = types.SimpleNamespace(cfg=cfg, mode="seg")
    engine = DenseInferenceEngine(init_ynet(cfg, torch.Generator()), cfg,
                                  device="cpu")
    labels, heat = engine._postprocess_s2d(
        tfd.space_to_depth(_nchw(seg), 4), torch.from_numpy(mask))
    assert labels.shape == heat.shape == (2, 16, 8, 12)
    for k in range(2):
        jl, jh = JaxEngine._postprocess_native_planes(
            stub, jnp.asarray(seg[k]), jnp.asarray(mask[k]))
        np.testing.assert_array_equal(labels[k].numpy(), np.asarray(jl))
        dh = np.abs(heat[k].numpy().astype(int) - np.asarray(jh).astype(int))
        assert dh.max() <= 1


@pytest.mark.parametrize("family,arch", [
    ("Linknet", "resnet18"), ("FPN", "resnet18"), ("PSPNet", "resnet34"),
    ("Unet", "resnet50")])
def test_fold_route_refuses_other_pairs(family, arch):
    """The fold route serves Unet on BasicBlock encoders only: the engine,
    prepare_fast and segment_whole_image raise ValueError for any other
    pair (the JAX engine runs BasicBlock code on Bottleneck weights there
    and fails inside it)."""
    cfg = default_config(tile_w=64, tile_h=64, model_name=family,
                         arch_encoder=arch, wsi_mask_pth="")
    model = init_ynet(cfg, torch.Generator().manual_seed(0))
    engine = DenseInferenceEngine(model, cfg, device="cpu")
    engine.fcn_fold = True
    plan = plan_slide("s", SyntheticSlide(width=2048, height=1536,
                                          num_levels=3, seed=1), cfg)
    msg = "Unet on BasicBlock encoders"
    with pytest.raises(ValueError, match=msg):
        engine.predict_slide_fcn(plan)
    with pytest.raises(ValueError, match=msg):
        prepare_fast(model, cfg.dataset_mean, cfg.dataset_std,
                     torch.float32, fold=True)
    with pytest.raises(ValueError, match=msg):
        segment_whole_image(model, np.zeros((64, 64, 3), np.uint8),
                            cfg.dataset_mean, cfg.dataset_std, fold=True)
    engine.fcn_fold = False
    assert engine.predict_slide_fcn(plan).labels.shape == (96, 128)
