"""The port's five sharded inference routes over two gloo CPU ranks
against the port's single-device routes (which the port's other tests
hold to JAX), and the psum route against JAX's two-device
``predict_slide_sharded`` on the same weights:

- ``predict_slide_sharded`` (psum) against ``predict_slide``: canvas
  within 1e-5 (the partial canvases are summed in another order), labels
  equal, heat within one u8 step (the port's heat is the u8 quantization
  of P(2)+P(3): a 1e-7 move of a probability at a rounding boundary moves
  it by 1/255), in seg and cls mode;
- ``predict_slide_sharded_rows`` against psum: canvas within 1e-5,
  labels equal (a 24-row stripe under a 32-row tile: two halo hops);
- ``predict_slide_streamed_sharded`` against ``predict_slide_streamed``:
  canvas within 1e-5, labels equal;
- ``predict_slides_fcn_sharded`` against ``predict_slide_fcn`` per slide:
  exact;
- ``predict_slide_fcn_sharded_rows`` against the chunked oracle at the
  pinned uneven ``(ch, cw) == (32, 512)`` geometry, Unet, Linknet, FPN;
- ``predict_tumorbed`` with a mesh: rank 0 writes each PNG once;
- the port's psum route against JAX's on ``make_mesh(devices=
  jax.devices()[:2])``, f32: canvas within 1e-3·max|canvas|, labels
  ≥ 99.9 % (PERF.md §2's f32 limits).

One group of ranks runs every port case
(``torch_rank_cases.sharded_inference_cases``) in a module-scope fixture.
``eval-tumorbed --device cpu --sharded --mesh 2`` runs end to end in the
group."""

import os

import jax
import numpy as np
import pytest
import torch

from wsiseg_tpu.config import default_config as jax_config
from wsiseg_tpu.data.wsi_tiles import plan_slide as jax_plan_slide
from wsiseg_tpu.infer.engine import DenseInferenceEngine as JaxEngine
from wsiseg_tpu.models.ynet import build_ynet as jax_build_ynet
from wsiseg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wsiseg_tpu.slides import SyntheticSlide
import torch_rank_cases as rc
from test_torch_train_step import random_variables
from wsiseg_tpu_torch.models.flax_import import from_flax
from wsiseg_tpu_torch.parallel import launch

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def flax_pair():
    """The flax Y-Net and f32 variables filled from a seeded numpy
    generator (``jax.eval_shape`` of the init: nothing compiled)."""
    model = jax_build_ynet(jax_config(**_fields(rc.infer_cfg())))
    variables = jax.tree_util.tree_map(
        lambda v: np.asarray(v, np.float32), random_variables(model, seed=1))
    return model, variables


def _fields(cfg):
    return dict(tile_w=cfg.tile_w, tile_h=cfg.tile_h,
                tile_stride_w=cfg.tile_stride_w,
                tile_stride_h=cfg.tile_stride_h,
                compute_dtype=cfg.compute_dtype,
                infer_batch_size=cfg.infer_batch_size,
                wsi_mask_pth=cfg.wsi_mask_pth)


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tumorbed"))


@pytest.fixture(scope="module")
def cases(flax_pair, out_dir, tmp_path_factory):
    from test_torch_eval import _npy_slide_dir
    slides = _npy_slide_dir(tmp_path_factory.mktemp("cli"))
    sd = from_flax(jax.tree_util.tree_map(np.asarray, dict(flax_pair[1])))
    return launch.run_ranks(rc.sharded_inference_cases, 2, "cpu",
                            args=(sd, out_dir, str(slides)), threads=1)


@pytest.mark.parametrize("mode", ["seg", "cls"])
def test_psum_matches_single_device(cases, mode):
    got, ref = cases[f"psum_{mode}"], cases[f"single_{mode}"]
    assert cases["n_tiles"] > 8
    np.testing.assert_allclose(got["canvas"], ref["canvas"], atol=1e-5)
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_allclose(got["heat"], ref["heat"], atol=1 / 255 + 1e-6)


@pytest.mark.parametrize("mode", ["seg", "cls"])
def test_rows_matches_psum(cases, mode):
    got, ref = cases[f"rows_{mode}"], cases[f"psum_{mode}"]
    np.testing.assert_allclose(got["canvas"], ref["canvas"], atol=1e-5)
    np.testing.assert_array_equal(got["labels"], ref["labels"])


def test_streamed_sharded_matches_streamed(cases):
    got, ref = cases["streamed_sharded"], cases["streamed"]
    np.testing.assert_allclose(got["canvas"], ref["canvas"], atol=1e-5)
    np.testing.assert_array_equal(got["labels"], ref["labels"])


def test_slide_parallel_matches_per_slide(cases):
    assert len(cases["slides_sharded"]) == cases["world"] == 2
    for got, ref in zip(cases["slides_sharded"], cases["slides_single"]):
        np.testing.assert_array_equal(got["labels"], ref["labels"])
        np.testing.assert_array_equal(got["heat"], ref["heat"])


@pytest.mark.parametrize("family", ["Unet", "Linknet", "FPN"])
def test_fcn_rows_matches_chunked_oracle(cases, family):
    assert cases["stripe_geometry"] == (32, 512)     # the uneven stripes
    got, ref = cases[f"fcn_rows_{family}"], cases[f"fcn_chunked_{family}"]
    np.testing.assert_allclose(got["canvas"], ref["canvas"], atol=1e-5)
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_allclose(got["heat"], ref["heat"], atol=1e-5)


def test_predict_tumorbed_mesh_writes_once(cases):
    """FCN (row-striped) and the grid (psum) through the evaluator's mesh
    branches: rank 0 returns the slide and the two PNGs exist once."""
    stride = rc.infer_cfg().tile_stride_w
    assert cases["tumorbed_results"] == {"True": ["t"], "False": ["t"]}
    assert cases["tumorbed_files"] == [f"0/t_{stride}_heatmap.png",
                                       f"0/t_{stride}_overlay.png"]


def test_psum_matches_jax_two_devices(cases, flax_pair):
    cfg = jax_config(**_fields(rc.infer_cfg()))
    slide = SyntheticSlide(width=rc.SLIDE_WH[0],
                           height=rc.SLIDE_WH[1], num_levels=3, seed=5)
    plan = jax_plan_slide("s", slide, cfg, mask_cache_dir=None)
    ref = JaxEngine(flax_pair[0], flax_pair[1], cfg).predict_slide_sharded(
        plan, jax_make_mesh(devices=jax.devices()[:2], shape=(2,),
                            axes=("data",)), keep_canvas=True)
    got = cases["psum_given"]
    ref_c = np.asarray(ref.canvas)
    assert got["canvas"].shape == ref_c.shape
    np.testing.assert_allclose(got["canvas"], ref_c, rtol=0,
                               atol=1e-3 * np.abs(ref_c).max())
    assert (got["labels"] == np.asarray(ref.labels)).mean() >= 0.999


def test_cli_eval_tumorbed_sharded_over_gloo(cases, out_dir):
    """``eval-tumorbed --sharded`` in the group (as under ``torchrun``):
    rank 0 returns the slide and wrote its heatmap and overlay."""
    assert set(cases["cli"]) == {"s0.npy"}
    rec = cases["cli"]["s0.npy"]
    for key in ("heatmap", "overlay"):
        assert rec[key].startswith(os.path.join(out_dir, "cli"))
        assert os.path.exists(rec[key]), rec[key]
