"""The port's eval slice (wsiseg_tpu_torch: ops/morphology, ops/hull,
pred_to_mask, find_nuclei(fill_mask=True), extract_tumor_bed,
infer/metrics, predict_wsis, the TTA patch evaluators, and the eval,
eval-spie and convert_slide CLIs) against the JAX package on inputs made
from a numpy seed. Morphology, hulls, masks and the tumor bed are held
exactly equal; the model-driven evaluators in f32 within the limits
stated at each test."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from wsiseg_tpu.config import default_config
from wsiseg_tpu.data.patches import \
    normalize_batch_images as jax_normalize_batch
from wsiseg_tpu.data.wsi_tiles import SlideCollection as JaxCollection
from wsiseg_tpu.infer import evaluators as jax_evaluators
from wsiseg_tpu.infer import metrics as jax_metrics
from wsiseg_tpu.infer.engine import DenseInferenceEngine as JaxEngine
from wsiseg_tpu.infer.engine import extract_tumor_bed as jax_extract_tb
from wsiseg_tpu.models.ynet import init_ynet as flax_init_ynet
from wsiseg_tpu.ops import hull as jax_hull
from wsiseg_tpu.ops import morphology as jax_morph
from wsiseg_tpu.ops.threshold import pred_to_mask as jax_pred_to_mask
from wsiseg_tpu.ops.tissue import find_nuclei as jax_find_nuclei
from wsiseg_tpu.slides import SyntheticSlide
from wsiseg_tpu_torch.data.patches import normalize_batch_images
from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection
from wsiseg_tpu_torch.infer import evaluators, metrics
from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine, \
    extract_tumor_bed
from wsiseg_tpu_torch.models.flax_import import from_flax
from wsiseg_tpu_torch.models.ynet import build_ynet
from wsiseg_tpu_torch.ops import hull, morphology
from wsiseg_tpu_torch.ops.threshold import pred_to_mask
from wsiseg_tpu_torch.ops.tissue import find_nuclei

torch.set_num_threads(2)

TILE, STRIDE, PATCH = 64, 32, 32
MORPH_SHAPES = [(37, 53), (64, 48), (2, 3, 29, 41)]
MORPH_SIZES = [1, 2, 3, 10, 20]


def _mask(r, shape, dtype):
    """A random mask: f32 with non-binary values (the ``> 0`` rule), u8
    with values other than 1, or bool."""
    on = r.rand(*shape) < 0.35
    if dtype == "f32":
        return np.where(on, r.choice([0.3, 1.0, 2.5], shape),
                        r.choice([0.0, -1.0], shape)).astype(np.float32)
    if dtype == "u8":
        return (on * r.choice([1, 7], shape)).astype(np.uint8)
    return on


# ---- morphology ----

@pytest.mark.parametrize("op", ["dilate", "erode", "opening", "closing"])
@pytest.mark.parametrize("size", MORPH_SIZES)
@pytest.mark.parametrize("shape", MORPH_SHAPES)
def test_window_morphology_matches_jax(op, size, shape):
    """Exactly equal, dtype included, for f32, u8 and bool masks: odd
    and non-square shapes, a leading batch axis, odd and even windows."""
    r = np.random.RandomState(size * 100 + len(shape))
    for dtype in ("f32", "u8", "bool"):
        m = _mask(r, shape, dtype)
        ref = np.asarray(getattr(jax_morph, op)(jnp.asarray(m), size))
        got = getattr(morphology, op)(torch.from_numpy(m), size).numpy()
        assert got.dtype == ref.dtype, (dtype, got.dtype, ref.dtype)
        np.testing.assert_array_equal(got, ref)


def test_even_window_is_jax_same_padding():
    """An impulse dilated by 20 covers o-9 … o+10 on each axis."""
    m = torch.zeros(41, 41, dtype=torch.uint8)
    m[20, 20] = 1
    rows = torch.nonzero(morphology.dilate(m, 20).any(dim=1)).flatten()
    assert (rows.min().item(), rows.max().item()) == (10, 29)


def _serpentine(h, w):
    """Background corridors whose geodesic length from the border far
    exceeds H + W, around one enclosed hole."""
    m = np.zeros((h, w), np.uint8)
    for i, y in enumerate(range(1, h - 1, 2)):
        m[y, :] = 1
        m[y, (w - 1) if i % 2 else 0] = 0
    m[h // 2 - 3:h // 2 + 3, w // 2 - 3:w // 2 + 3] = 1
    m[h // 2, w // 2] = 0
    return m


@pytest.mark.parametrize("max_iters", [None, 0, 1, 3, 40, 1000])
@pytest.mark.parametrize("case", ["random", "serpentine"])
def test_fill_holes_matches_jax(case, max_iters):
    """Exactly equal with the default cap (H·W) and small caps, where the
    fill stops at the same partial reach as the JAX loop."""
    r = np.random.RandomState(7)
    m = ((r.rand(37, 53) < 0.5).astype(np.uint8) if case == "random"
         else _serpentine(31, 40))
    for arr in (m, m.astype(np.float32)):
        ref = np.asarray(jax_morph.fill_holes(jnp.asarray(arr), max_iters))
        got = morphology.fill_holes(torch.from_numpy(arr), max_iters).numpy()
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", ["f32", "u8", "bool"])
def test_bwperim_and_dilate4_match_jax(dtype):
    r = np.random.RandomState(3)
    for shape in [(37, 53), (1, 9), (64, 48)]:
        m = _mask(r, shape, dtype)
        ref = np.asarray(jax_morph.bwperim(jnp.asarray(m)))
        got = morphology.bwperim(torch.from_numpy(m)).numpy()
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
        b = m > 0
        np.testing.assert_array_equal(
            morphology._dilate4(torch.from_numpy(b)).numpy(),
            np.asarray(jax_morph._dilate4(jnp.asarray(b))))
    # a leading batch axis: each slice as the JAX 2-D function has it
    mb = _mask(r, (3, 20, 27), dtype)
    got = morphology.bwperim(torch.from_numpy(mb)).numpy()
    for k in range(3):
        np.testing.assert_array_equal(
            got[k], np.asarray(jax_morph.bwperim(jnp.asarray(mb[k]))))


# ---- hull ----

def _hull_cases():
    r = np.random.RandomState(11)
    z = np.zeros((20, 30), np.uint8)
    one, row, col, diag, two = (z.copy() for _ in range(5))
    one[5, 7] = 1
    row[4, 3:20] = 1
    col[2:15, 9] = 1
    for i in range(12):
        diag[i, 2 * i] = 1
    two[3, 4] = two[10, 25] = 1
    cases = {"empty": z, "one-pixel": one, "one-row": row, "one-column": col,
             "collinear": diag, "two-points": two,
             "full": np.ones((17, 23), np.uint8)}
    for k in range(24):
        h, w = r.randint(5, 90, 2)
        cases[f"random{k}"] = (r.rand(h, w) < [0.002, 0.05, 0.5][k % 3]
                               ).astype(np.uint8)
    yy, xx = np.mgrid[:120, :160]
    cases["ellipse"] = (((yy - 60) / 50.0) ** 2 + ((xx - 70) / 65.0) ** 2
                        < 1).astype(np.uint8)
    return cases


@pytest.mark.parametrize("name", list(_hull_cases()))
def test_convex_hull_image_matches_jax(name):
    """The row-extremes hull fills exactly the JAX every-pixel hull."""
    m = _hull_cases()[name]
    ref = jax_hull.convex_hull_image(m)
    got = hull.convex_hull_image(m)
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_hull_helpers_match_jax():
    """The copied helpers: convex_hull_points, fill_polygon and the
    concave hull, on the same points."""
    r = np.random.RandomState(5)
    pts = r.randint(0, 60, (80, 2))
    np.testing.assert_array_equal(hull.convex_hull_points(pts),
                                  jax_hull.convex_hull_points(pts))
    v = jax_hull.convex_hull_points(pts)
    np.testing.assert_array_equal(hull.fill_polygon(v, (64, 64)),
                                  jax_hull.fill_polygon(v, (64, 64)))
    np.testing.assert_array_equal(hull.concave_hull_points(pts, k=6),
                                  jax_hull.concave_hull_points(pts, k=6))


# ---- pred_to_mask, find_nuclei, extract_tumor_bed ----

@pytest.fixture(scope="module")
def slide():
    return SyntheticSlide(width=2048, height=1536, num_levels=3, seed=5)


@pytest.mark.parametrize("num_classes", [2, 4, 6])
@pytest.mark.parametrize("with_wsi", [False, True])
@pytest.mark.parametrize("perim", [False, True])
def test_pred_to_mask_matches_jax(perim, with_wsi, num_classes):
    r = np.random.RandomState(num_classes)
    labels = np.zeros((40, 52), np.uint8)
    for c in range(1, num_classes):
        y, x = r.randint(0, 30, 2)
        labels[y:y + r.randint(4, 14), x:x + r.randint(4, 20)] = c
    labels[r.rand(40, 52) < 0.05] = r.randint(0, num_classes)
    wsi = r.randint(0, 256, (40, 52, 3)).astype(np.uint8) if with_wsi \
        else None
    ref = np.asarray(jax_pred_to_mask(
        jnp.asarray(labels), num_classes,
        None if wsi is None else jnp.asarray(wsi), perim=perim))
    got = pred_to_mask(torch.from_numpy(labels), num_classes,
                       None if wsi is None else torch.from_numpy(wsi),
                       perim=perim).numpy()
    assert got.dtype == np.uint8 and got.shape == (40, 52, 3)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", ["hsv", "lab"])
def test_find_nuclei_fill_mask_matches_jax(slide, mode):
    imgs = [slide.read_level(2), np.random.RandomState(0).randint(
        0, 256, (64, 96, 3)).astype(np.uint8)]
    for img in imgs:
        ref = np.asarray(jax_find_nuclei(jnp.asarray(img), mode=mode,
                                         fill_mask=True))
        got = find_nuclei(img, mode=mode, fill_mask=True).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)


def _tb_labels(slide):
    r = np.random.RandomState(9)
    gt = slide.ground_truth(2).astype(np.uint8)
    noisy = gt.copy()
    salt = r.rand(*gt.shape) < 0.03
    noisy[salt] = r.randint(2, 4, int(salt.sum()))
    blob = np.zeros((150, 170), np.uint8)
    blob[30:110, 40:150] = 3
    blob[60:70, 20:160] = 2
    return {"gt": gt, "noisy": noisy, "blob": blob,
            "none": np.ones((50, 60), np.uint8)}


@pytest.mark.parametrize("case", ["gt", "noisy", "blob", "none"])
def test_extract_tumor_bed_matches_jax(slide, case):
    labels = _tb_labels(slide)[case]
    ref = jax_extract_tb(labels)
    got = extract_tumor_bed(labels, device="cpu")
    for g, rf in zip(got, ref):
        assert g.dtype == rf.dtype == np.uint8
        np.testing.assert_array_equal(g, rf)
    if case != "none":
        assert got[0].any() and got[1].any(), "degenerate fixture"


# ---- metrics ----

METRICS = ["iou", "dice_coefficient", "masked_pixel_accuracy", "spie_score",
           "foreground_iou", "confusion_matrix", "classwise_accuracy",
           "accuracy", "f1_score", "precision_recall", "roc_auc",
           "regression_report"]


@pytest.mark.parametrize("name", METRICS)
def test_metrics_match_jax(name):
    r = np.random.RandomState(len(name))
    p = r.randint(0, 4, (30, 40))
    g = r.randint(0, 4, (30, 40))
    g[:5] = 0
    x = r.rand(50)
    y = r.rand(50) > 0.5
    args = {"iou": (p > 1, g > 1), "dice_coefficient": (p > 1, g > 1),
            "masked_pixel_accuracy": (p, g), "spie_score": (p, g),
            "foreground_iou": (p, g), "confusion_matrix": (g, p, 4),
            "classwise_accuracy": (np.array([[3, 1], [2, 5]]),),
            "accuracy": (g, p), "f1_score": (y, x > 0.4),
            "precision_recall": (y, x > 0.4), "roc_auc": (y, np.round(x, 1)),
            "regression_report": (x, r.rand(50))}[name]
    got = getattr(metrics, name)(*args)
    ref = getattr(jax_metrics, name)(*args)
    if isinstance(ref, dict):
        assert got == ref
    else:
        np.testing.assert_array_equal(got, ref)


# ---- predict_wsis against JAX on the same weights ----

@pytest.fixture(scope="module")
def cfg():
    return default_config(tile_w=TILE, tile_h=TILE, tile_stride_w=STRIDE,
                          tile_stride_h=STRIDE, compute_dtype="float32",
                          infer_batch_size=8, wsi_mask_pth="")


@pytest.fixture(scope="module")
def flax_pair(cfg):
    return flax_init_ynet(cfg, jax.random.PRNGKey(0), tile_hw=(TILE, TILE))


@pytest.fixture(scope="module")
def port_model(cfg, flax_pair):
    m = build_ynet(cfg)
    m.load_state_dict(from_flax(jax.tree_util.tree_map(
        np.asarray, dict(flax_pair[1]))))
    return m.eval()


def _write_gt(slide, spath):
    gt2 = slide.ground_truth(2).astype(np.uint8)
    Image.fromarray(gt2).save(spath + "_mask.png")
    Image.fromarray((gt2 >= 2).astype(np.uint8) * 255).save(
        spath + "_tumor_bed.png")


def test_predict_wsis_matches_jax(cfg, flax_pair, port_model, slide,
                                  tmp_path):
    """Both on the grid in f32 with GT rasters beside the slide: every
    metric within 1e-3, and the color-mask PNG equal on ≥ 99.9 % of its
    pixels (PERF.md §2's f32 label limit)."""
    spath = str(tmp_path / "cased.svs")
    _write_gt(slide, spath)
    out = {}
    for side in ("jax", "port"):
        c = cfg.replace(val_save_pth=str(tmp_path / side))
        if side == "jax":
            eng = JaxEngine(flax_pair[0], flax_pair[1], c)
            coll = JaxCollection([("cased.svs", slide, spath)], c,
                                 mask_cache_dir="")
            res = jax_evaluators.predict_wsis(eng, coll, ep=3,
                                              log=lambda s: None)
        else:
            eng = DenseInferenceEngine(port_model, c, device="cpu")
            coll = SlideCollection([("cased.svs", slide, spath)], c)
            res = evaluators.predict_wsis(eng, coll, ep=3,
                                          log=lambda s: None)
        png = np.asarray(Image.open(os.path.join(
            c.val_save_pth, "3", f"cased.svs_{STRIDE}.png")))
        out[side] = res, png
    (ref, ref_png), (got, got_png) = out["jax"], out["port"]
    assert set(got) == set(ref) == {"cased.svs", "_mean_tb_iou"}
    assert set(got["cased.svs"]) == set(ref["cased.svs"])
    for key in ("acc", "s", "acc_masked", "s_masked", "iou_fg", "iou_tb"):
        assert abs(got["cased.svs"][key] - ref["cased.svs"][key]) <= 1e-3, key
    assert got["cased.svs"]["num_tiles"] == ref["cased.svs"]["num_tiles"]
    assert abs(got["_mean_tb_iou"] - ref["_mean_tb_iou"]) <= 1e-3
    assert got_png.shape == ref_png.shape == (48, 64, 3)
    assert (got_png == ref_png).all(axis=-1).mean() >= 0.999


# ---- patch evaluators against JAX ----

@pytest.fixture(scope="module")
def patch_cfg(cfg):
    return cfg.replace(tile_w=PATCH, tile_h=PATCH)


def _batch(seed, n=6):
    r = np.random.RandomState(seed)
    return {"image": r.randint(0, 255, (n, PATCH, PATCH, 3)).astype(np.uint8),
            "cls_label": np.arange(n, dtype=np.int32) % 4,
            "reg_label": r.rand(n).astype(np.float32),
            "is_cls": np.array([1, 1, 0, 1, 1, 1], np.float32)[:n],
            "is_reg": np.array([1, 0, 1, 1, 1, 1], np.float32)[:n],
            "is_seg": np.zeros(n, np.float32)}


def _capture(monkeypatch, module, name, idx):
    """Record argument ``idx`` of every call to ``module.name``."""
    seen, fn = [], getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: seen.append(np.asarray(a[idx]))
                        or fn(*a, **k))
    return seen


def test_predict_reg_matches_jax(patch_cfg, flax_pair, port_model,
                                 monkeypatch):
    """Per-sample TTA predictions within rtol 1e-4 / atol 1e-5 (f32 both
    sides), and the same report within those limits."""
    batches = [_batch(1), _batch(2, n=4)]
    ref_p = _capture(monkeypatch, jax_metrics, "regression_report", 0)
    got_p = _capture(monkeypatch, metrics, "regression_report", 0)
    ref = jax_evaluators.predict_reg(flax_pair[0], flax_pair[1], patch_cfg,
                                     batches, log=lambda s: None)
    got = evaluators.predict_reg(port_model, patch_cfg, batches,
                                 device="cpu", log=lambda s: None)
    assert len(got_p[0]) == len(ref_p[0]) == 8
    np.testing.assert_allclose(got_p[0], ref_p[0], rtol=1e-4, atol=1e-5)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5)


def test_predict_cls_matches_jax(patch_cfg, flax_pair, port_model,
                                 monkeypatch):
    """The same predicted classes (f32 both sides), so the same report."""
    batches = [_batch(3), _batch(4)]
    ref_p = _capture(monkeypatch, jax_metrics, "accuracy", 1)
    got_p = _capture(monkeypatch, metrics, "accuracy", 1)
    ref = jax_evaluators.predict_cls(flax_pair[0], flax_pair[1], patch_cfg,
                                     batches, log=lambda s: None)
    got = evaluators.predict_cls(port_model, patch_cfg, batches,
                                 device="cpu", log=lambda s: None)
    np.testing.assert_array_equal(got_p[0], ref_p[0])
    np.testing.assert_equal(got, ref)      # NaN class-wise entries too


def _spie_folder(tmp_path, n=4):
    r = np.random.RandomState(8)
    patches = tmp_path / "patches"
    patches.mkdir()
    rows = ["slide,rid,y"]
    for k in range(n):
        iid, rid = 7 + k // 2, 1 + k % 2
        Image.fromarray(r.randint(0, 255, (40 + 3 * k, 36, 3)).astype(
            np.uint8)).save(str(patches / f"{iid}_{rid}.tif"))
        rows.append(f"{iid},{rid},0.5")
    csv_pth = tmp_path / "labels.csv"
    csv_pth.write_text("\n".join(rows))
    return str(patches), str(csv_pth)


def _read_csv(pth):
    with open(pth) as f:
        return [(int(r["slide"]), int(r["rid"]), float(r["p"]))
                for r in csv.DictReader(f)]


def test_predict_breastpathq_matches_jax(patch_cfg, flax_pair, port_model,
                                         tmp_path):
    """The same rows in the same file name; clamped predictions within
    1e-5 (f32 both sides)."""
    patches, csv_pth = _spie_folder(tmp_path)
    outs = []
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        if side == "jax":
            pth = jax_evaluators.predict_breastpathq(
                flax_pair[0], flax_pair[1], patch_cfg, 3, patches, csv_pth,
                out_dir=str(d))
        else:
            pth = evaluators.predict_breastpathq(
                port_model, patch_cfg, 3, patches, csv_pth, out_dir=str(d),
                device="cpu")
        assert os.path.basename(pth) == "Ozan_Results_3.csv"
        outs.append(_read_csv(pth))
    ref, got = outs
    assert [r[:2] for r in got] == [r[:2] for r in ref]
    assert len(got) == 4 and all(0.0 <= r[2] <= 1.0 for r in got)
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in ref],
                               atol=1e-5)


def test_tta_variants_match_jax():
    x = np.random.RandomState(2).rand(2, 5, 7, 3).astype(np.float32)
    ref = [np.asarray(v) for v in jax_evaluators._tta_variants(
        jnp.asarray(x))]
    got = evaluators._tta_variants(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == 4
    for g, rf in zip(got, ref):
        np.testing.assert_array_equal(g.permute(0, 2, 3, 1).numpy(), rf)


def test_normalize_batch_images_matches_jax(cfg):
    img = np.random.RandomState(1).randint(0, 256, (2, 8, 9, 3)).astype(
        np.uint8)
    ref = np.asarray(jax_normalize_batch(jnp.asarray(img), cfg))
    got = normalize_batch_images(torch.from_numpy(img), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    f64 = normalize_batch_images(torch.from_numpy(img),
                                 cfg.replace(compute_dtype="float64"))
    assert f64.dtype == torch.float64
    np.testing.assert_allclose(f64.numpy(), ref, rtol=1e-6, atol=1e-6)
    # the train path: the color jitter, its factors from the generator
    from wsiseg_tpu_torch.ops.color import apply_color_jitter, \
        draw_jitter_factors, normalize
    x = torch.from_numpy(img)
    jit = normalize_batch_images(x, cfg, torch.Generator().manual_seed(4),
                                 train=True)
    fac = draw_jitter_factors(2, torch.Generator().manual_seed(4))
    want = normalize(apply_color_jitter(x.float() / 255.0, fac),
                     cfg.dataset_mean, cfg.dataset_std)
    torch.testing.assert_close(jit, want, rtol=0, atol=0)
    assert (jit - got).abs().max() > 0.01
    # without a generator (JAX: without an rng) train adds no jitter
    torch.testing.assert_close(normalize_batch_images(x, cfg, train=True),
                               got, rtol=0, atol=0)


# ---- CLIs ----

def _npy_slide_dir(tmp_path, n=1):
    slides = tmp_path / "slides"
    slides.mkdir()
    for k in range(n):
        s = SyntheticSlide(width=2048, height=1536, num_levels=1,
                           seed=3 + k)
        pth = str(slides / f"s{k}.npy")
        np.save(pth, s.read_level(0))
        _write_gt(SyntheticSlide(width=2048, height=1536, num_levels=3,
                                 seed=3 + k), pth)
    return slides


def test_cli_eval_reports_metrics_and_color_mask(tmp_path):
    """eval --device cpu (FCN, the CLI's default): every metric key, the
    mean tumor-bed IoU, and a half-size color mask per slide."""
    from wsiseg_tpu_torch.__main__ import main
    slides = _npy_slide_dir(tmp_path)
    out = tmp_path / "out"
    res = main(["eval", "--raw_val_pth", str(slides), "--eval_model_pth",
                str(tmp_path / "none"), "--val_save_pth", str(out),
                "--wsi_mask_pth", "", "--tile_w", "64", "--tile_h", "64",
                "--tile_stride_w", "32", "--tile_stride_h", "32",
                "--device", "cpu"])
    assert set(res) == {"s0.npy", "_mean_tb_iou"}
    rec = res["s0.npy"]
    for key in ("acc", "s", "acc_masked", "s_masked", "iou_fg", "iou_tb",
                "num_tiles", "seconds", "patches_per_sec"):
        assert key in rec and np.isfinite(rec[key]), key
    assert res["_mean_tb_iou"] == rec["iou_tb"]
    png = np.asarray(Image.open(out / "0" / "s0.npy_32.png"))
    assert png.shape == (48, 64, 3)


def test_cli_eval_spie_writes_csv(tmp_path, monkeypatch):
    from wsiseg_tpu_torch.__main__ import main
    patches, csv_pth = _spie_folder(tmp_path)
    monkeypatch.chdir(tmp_path)
    pth = main(["eval-spie", "--patch_folder", patches, "--label_csv_path",
                csv_pth, "--eval_model_pth", str(tmp_path / "none"),
                "--tile_w", "32", "--tile_h", "32", "--device", "cpu"])
    assert pth == os.path.join(".", "Ozan_Results_0.csv")
    rows = _read_csv(tmp_path / "Ozan_Results_0.csv")
    assert [r[:2] for r in rows] == [(7, 1), (7, 2), (8, 1), (8, 2)]
    assert all(0.0 <= r[2] <= 1.0 for r in rows)


@pytest.mark.parametrize("mode", ["file", "dir"])
def test_cli_convert_slide_matches_jax(tmp_path, mode):
    """The port's convert_slide writes the same .wsiraw bytes as the JAX
    CLI, for one slide and for a directory."""
    from wsiseg_tpu.cli.convert_slide import main as jax_main
    from wsiseg_tpu_torch.cli.convert_slide import main
    from wsiseg_tpu_torch.slides import open_slide
    from wsiseg_tpu_torch.slides.j2k import APERIO_J2K_RGB, \
        write_j2k_tiled_tiff
    r = np.random.RandomState(0)
    l0 = r.randint(0, 256, (220, 300, 3)).astype(np.uint8)
    src_dir = tmp_path / "src"
    src_dir.mkdir()
    src = str(src_dir / "case.svs")
    write_j2k_tiled_tiff(src, [l0, l0[::4, ::4]], tile_size=128,
                         compression=APERIO_J2K_RGB)
    outs = []
    for side, fn in (("jax", jax_main), ("port", main)):
        d = tmp_path / side
        if mode == "file":
            d.mkdir()
            fn([src, str(d / "case.wsiraw")])
        else:
            fn(["--dir", str(src_dir), "--out_dir", str(d)])
        outs.append((d / "case.wsiraw").read_bytes())
    assert outs[0] == outs[1]
    s = open_slide(str(tmp_path / "port" / "case.wsiraw"))
    np.testing.assert_array_equal(s.read_level(0), l0)
    s.close()


@pytest.mark.parametrize("what", ["eval", "eval-spie", "extract_tumor_bed",
                                  "predict_reg"])
def test_cuda_default_raises_without_a_card(tmp_path, cfg, port_model,
                                            what):
    """Without --device / device the eval entries run on the card; with
    no card they raise before any work, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from wsiseg_tpu_torch.__main__ import main
    with pytest.raises(RuntimeError, match="device"):
        if what == "eval":
            main(["eval", "--raw_val_pth", str(tmp_path), "--eval_model_pth",
                  str(tmp_path / "none"), "--val_save_pth",
                  str(tmp_path / "out"), "--wsi_mask_pth", ""])
        elif what == "eval-spie":
            main(["eval-spie", "--patch_folder", str(tmp_path),
                  "--label_csv_path", str(tmp_path / "x.csv"),
                  "--device", "cuda"])
        elif what == "extract_tumor_bed":
            extract_tumor_bed(np.zeros((8, 8), np.uint8))
        else:
            evaluators.predict_reg(port_model, cfg, [_batch(1)])


def test_cli_eval_sharded_names_multi_gpu():
    from wsiseg_tpu_torch.__main__ import main
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        main(["eval", "--sharded", "--raw_val_pth", "/nonexistent"])
