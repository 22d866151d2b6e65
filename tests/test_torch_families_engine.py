"""The other model families' whole-image forward and engine against the
JAX package on the same weights (tests/test_torch_families.py's seeded
random flax variables): segment_whole_image against the JAX one (Pallas
stem in interpret mode), DenseInferenceEngine (plain stem on the CPU)
against the JAX engine (``fcn_fast_interpret``) on a 192×256 slide, and
each family's checkpoint served through the eval-tumorbed CLI."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_families import CASES, _pair
from wsiseg_tpu.config import default_config
from wsiseg_tpu.data.wsi_tiles import plan_slide as jax_plan_slide
from wsiseg_tpu.infer.engine import DenseInferenceEngine as JaxEngine
from wsiseg_tpu.models.infer_fast import segment_whole_image as jax_swi
from wsiseg_tpu.models.ynet import YNet as FlaxYNet
from wsiseg_tpu.ops.color import normalize
from wsiseg_tpu.slides import SyntheticSlide
from wsiseg_tpu_torch.data.wsi_tiles import plan_slide
from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
from wsiseg_tpu_torch.models.infer_fast import segment_whole_image
from wsiseg_tpu_torch.models.ynet import init_ynet
from wsiseg_tpu_torch.train.state import save_checkpoint

torch.set_num_threads(2)


@pytest.mark.parametrize("family,arch", CASES[:-1])
def test_segment_whole_image_matches_jax(family, arch):
    """The port's whole-image forward (plain stem on the CPU) against the
    JAX one (Pallas stem in interpret mode), 64×256 u8 image (PSPNet: c5
    2×8, bins 3 and 6 by the antialiased resize). In bf16, the port is
    within twice the JAX forward's own bf16 error (against the flax f32
    Y-Net on the normalized image), in max and in mean; measured ≤ 1.47×.
    In f32 it agrees with the flax f32 Y-Net within 2e-3·max|ref|
    (measured ≤ 1.02e-3). Interior only: the stem pads with round(255·mean),
    within 0.5/255/std of normalized zero; 16 px of border are cropped."""
    model, variables, port = _pair(family, arch)
    cfg = default_config()
    img = np.random.RandomState(4).randint(0, 256, (64, 256, 3)).astype(
        np.uint8)
    ref = np.asarray(jax_swi(model, variables, img, cfg.dataset_mean,
                             cfg.dataset_std, interpret=True))
    x = normalize(jnp.asarray(img, jnp.float32)[None] / 255.0,
                  cfg.dataset_mean, cfg.dataset_std)
    truth = np.asarray(model.apply(variables, x, method=FlaxYNet.segment))[0]
    got = segment_whole_image(port, img, cfg.dataset_mean,
                              cfg.dataset_std).numpy()
    got32 = segment_whole_image(port, img, cfg.dataset_mean, cfg.dataset_std,
                                dtype=torch.float32).numpy()
    assert got.shape == got32.shape == ref.shape == (64, 256, 4)
    c = np.s_[16:-16, 16:-16]
    d, d_ref = np.abs(got - ref)[c], np.abs(ref - truth)[c]
    assert d.max() <= 2 * d_ref.max() and d.mean() <= 2 * d_ref.mean(), \
        (d.max(), d_ref.max(), d.mean(), d_ref.mean())
    np.testing.assert_allclose(got32[c], truth[c], rtol=0,
                               atol=2e-3 * np.abs(truth).max())
    if family in ("Unet", "Linknet"):
        planar = segment_whole_image(port, img, cfg.dataset_mean,
                                     cfg.dataset_std, planar_head=True)
        assert planar.shape == (16, 64, 64)


@pytest.mark.parametrize("family,arch", [
    ("Unet", "resnet50"), ("Linknet", "resnet18"), ("FPN", "resnet18"),
    ("PSPNet", "resnet18")])
def test_cli_serves_family_checkpoint(tmp_path, family, arch):
    """A model_<arch>_<epoch>.pt checkpoint of the family restores
    strictly and serves through eval-tumorbed (--model_name,
    --arch_encoder); restoring it into another family fails."""
    from wsiseg_tpu_torch.__main__ import main

    slides = tmp_path / "slides"
    slides.mkdir()
    np.save(slides / "a.npy", SyntheticSlide(
        width=2048, height=1536, num_levels=1, seed=3).read_level(0))
    cfg = default_config(model_name=family, arch_encoder=arch)
    ckpt = tmp_path / "ckpt"
    save_checkpoint(init_ynet(cfg, torch.Generator().manual_seed(2)),
                    str(ckpt), arch, 5)
    args = ["eval-tumorbed", "--raw_val_pth", str(slides),
            "--eval_model_pth", str(ckpt), "--val_save_pth",
            str(tmp_path / "out"), "--wsi_mask_pth", "", "--tile_w", "64",
            "--tile_h", "64", "--device", "cpu", "--arch_encoder", arch]
    res = main(args + ["--model_name", family])
    hm = np.asarray(Image.open(res["a.npy"]["heatmap"]))
    assert hm.shape == (96, 128)
    other = "Unet" if family != "Unet" else "FPN"
    with pytest.raises(RuntimeError, match="state_dict"):
        main(args + ["--model_name", other])


@pytest.fixture(scope="module")
def slide():
    return SyntheticSlide(width=4096, height=3072, num_levels=3, seed=11)


@pytest.mark.parametrize("family,arch", [
    ("Linknet", "resnet18"), ("FPN", "resnet18"), ("PSPNet", "resnet18"),
    ("Unet", "resnet50"), ("Linknet", "resnet50"), ("FPN", "resnet50"),
    ("PSPNet", "resnet50")])
def test_engine_matches_jax_engine(slide, family, arch):
    """The port's engine (bf16, plain stem on the CPU) against the JAX
    engine (bf16, Pallas stem in interpret mode) on the same slide and
    weights: labels ≥ 99 % equal and heat within 2/255 on ≥ 99 % of
    pixels (PSPNet at 192×256: c5 6×8, bins 3 and 6 by the antialiased
    resize). FPN's heat is held to 97 % within 2/255 and 99 % within
    4/255: its logits reach |10| (four summed branches), where one bf16
    ulp of a logit is 1/16, and the JAX engine's own bf16 FPN is as far
    from its f32 model as the port is from it
    (test_segment_whole_image_matches_jax). Measured: FPN 98.9 % (r18),
    97.6 % (r50) within 2/255, 99.9 % / 99.4 % within 4/255; every
    other case ≥ 99.0 %."""
    model, variables, port = _pair(family, arch)
    cfg = default_config(tile_w=64, tile_h=64, tile_stride_w=32,
                         tile_stride_h=32, compute_dtype="float32",
                         wsi_mask_pth="", model_name=family,
                         arch_encoder=arch)
    jax_eng = JaxEngine(model, variables, cfg)
    jax_eng.fcn_fast_interpret = True
    assert jax_eng.fast_native == (family in ("FPN", "PSPNet"))
    jres = jax_eng.predict_slide_fcn(jax_plan_slide("syn", slide, cfg))
    res = DenseInferenceEngine(port, cfg, device="cpu").predict_slide_fcn(
        plan_slide("syn", slide, cfg))
    assert res.labels.shape == res.heatmap.shape == (192, 256)
    assert (res.labels == jres.labels).mean() >= 0.99
    d = np.abs(res.heatmap - jres.heatmap)
    if family == "FPN":
        assert (d <= 2 / 255 + 1e-6).mean() >= 0.97
        assert (d <= 4 / 255 + 1e-6).mean() >= 0.99
    else:
        assert (d <= 2 / 255 + 1e-6).mean() >= 0.99


def test_native_group_equals_per_slide():
    """A group of two slides (the batch dimension through the native
    decoder, its resizes and the plane layout) gives each slide's own
    result."""
    cfg = default_config(tile_w=64, tile_h=64, model_name="PSPNet",
                         wsi_mask_pth="")
    engine = DenseInferenceEngine(
        init_ynet(cfg, torch.Generator().manual_seed(3)), cfg, device="cpu")
    plans = [plan_slide(f"s{k}", SyntheticSlide(
        width=2048, height=1536, num_levels=3, seed=40 + k), cfg)
        for k in range(2)]
    for p, g in zip(plans, engine.predict_slides_fcn(plans)):
        one = engine.predict_slide_fcn(p)
        np.testing.assert_array_equal(g.labels, one.labels)
        np.testing.assert_array_equal(g.heatmap, one.heatmap)
