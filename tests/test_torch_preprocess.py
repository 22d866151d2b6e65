"""The port's preprocess generators (``wsiseg_tpu_torch.preprocess``),
``ops.contour`` and ``data.annotations`` against the JAX package's on the
same seeded inputs, on the CPU (``device="cpu"``): BACH-like photo
folders, BreakHis and BreastPathQ trees, ``*_crop.tif``/``*_mask.tif``
pairs and a ``.npy`` synthetic slide with Aperio and Sedeen XML. Each
tool writes into its own directory; the test compares what the two wrote:
the same files, the PNGs pixel for pixel, the ``gt.npy`` stores' keys and
values (paths read relative to their directory).

Limits, all exact unless stated:
- the copies (contour, annotations, ``patch_to_gt``, ``ssr_patch_to_gt``,
  ``collage``, ``makedata_ssr``, the ``patch`` mode) and the device ops
  that equal JAX's since the eval and proposal slices (``find_nuclei``,
  the morphology, connected components);
- k-means keypoints and tile positions with JAX's seeds patched in
  (``jax_seeds``: the port seeds from ``np.random.RandomState``, JAX from
  threefry, by design): centered tiles and the breastpathq k-means
  colours on unpadded points (``"none"``), ``get_key_points`` padded to a
  power of two (``"pow2"``);
- SLIC labels ≥ 99 % equal (``test_slic_matches_jax``'s limit); with
  JAX's labels handed to both, the ``slic`` mode's proposals as
  ``test_slic_and_cc_proposals_match_jax`` holds them: the same keys,
  centers within ``us_kmeans`` px, perimeter points, labels and the rest
  exact."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_proposals import jax_seeds
from wsiseg_tpu.config import default_config as jax_config
from wsiseg_tpu.data import annotations as jann
from wsiseg_tpu.ops import contour as jcontour
from wsiseg_tpu.slides.reader import SyntheticSlide
from wsiseg_tpu_torch.config import default_config
from wsiseg_tpu_torch.data import annotations as tann
from wsiseg_tpu_torch.data import metadata as md
from wsiseg_tpu_torch.ops import contour as tcontour
from wsiseg_tpu_torch.ops import kmeans as tkm
from wsiseg_tpu_torch.slides.reader import open_slide

torch.set_num_threads(2)

# Level-0 polygons of the synthetic slide (2048×1536; level 1 512×384,
# the scan level of the slide generators here, level 2 128×96): two large
# regions that centered tiles split by k-means and that yield CC
# proposals, a benign one, and a small one of one tile.
APERIO_XML = """<?xml version="1.0"?>
<Annotations MicronsPerPixel="0.25">
 <Annotation>
  <Dummy/>
  <Regions>
{}
  </Regions>
 </Annotation>
</Annotations>
"""
REGION = """   <Region Text="{0}">
    <Attributes><Attribute Value="{0}"/></Attributes>
    <Vertices>{1}</Vertices>
   </Region>"""
POLYGONS = [
    ("invasive carcinoma", [(200, 200), (900, 260), (860, 800), (240, 700)]),
    ("carcinoma in situ", [(1200, 300), (1700, 300), (1700, 700)]),
    ("benign", [(1300, 1000), (1500, 1000), (1500, 1300), (1300, 1300)]),
    ("invasive carcinoma", [(400, 1100), (520, 1100), (520, 1200),
                            (400, 1200)]),
]
SEDEEN_XML = """<?xml version="1.0"?>
<session>
 <image>
  <a/><b/><c/>
  <overlays>
   <graphic type="polygon" description="DCIS region">
    <pen/><font/>
    <point-list>
     <point>200,200</point><point>900,200</point>
     <point>900,800</point><point>200,800</point>
    </point-list>
   </graphic>
   <graphic type="polygon" description="IDC">
    <pen/><font/>
    <point-list>
     <point>1200,300</point><point>1700,300</point>
     <point>1700,900</point>
    </point-list>
   </graphic>
   <graphic type="polygon" description="TB outline">
    <pen/><font/>
    <point-list>
     <point>100,100</point><point>1800,100</point>
     <point>1800,1000</point><point>100,1000</point>
    </point-list>
   </graphic>
   <graphic type="text" description="invasive">
    <pen/><font/>
    <point-list><point>1,1</point></point-list>
   </graphic>
  </overlays>
 </image>
</session>
"""


def _aperio_xml() -> str:
    regions = [REGION.format(text, "".join(
        f'<Vertex X="{x}" Y="{y}"/>' for x, y in pts))
        for text, pts in POLYGONS]
    return APERIO_XML.format("\n".join(regions))


@pytest.fixture(scope="module")
def slide_dir(tmp_path_factory):
    """``s1.npy`` (SyntheticSlide level 0, 2048×1536) with ``s1.xml``
    (Aperio) and ``s1.session.xml`` (Sedeen) beside it."""
    root = tmp_path_factory.mktemp("wsi")
    np.save(root / "s1.npy", SyntheticSlide(
        width=2048, height=1536, num_levels=1, seed=1).read_level(0))
    (root / "s1.xml").write_text(_aperio_xml())
    (root / "s1.session.xml").write_text(SEDEEN_XML)
    return str(root)


@pytest.fixture(scope="module")
def photos_dir(tmp_path_factory):
    """BACH-like class folders of photos, two each (JAX's fixture)."""
    root = tmp_path_factory.mktemp("photos")
    rng = np.random.RandomState(0)
    for cls in ("Normal", "Benign", "InSitu", "Invasive", "Other"):
        d = root / cls
        d.mkdir()
        for i in range(2):
            Image.fromarray(
                rng.randint(0, 255, (96, 128, 3), np.uint8)).save(
                    str(d / f"{cls.lower()}{i:02d}.png"))
    return str(root)


def _png(pth):
    return np.asarray(Image.open(pth))


def _same(got, ref, got_root: str, ref_root: str, where="store"):
    """Equal nested values; strings under ``ref_root`` read relative to
    it, arrays exactly equal."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), where
        for k in ref:
            _same(got[k], ref[k], got_root, ref_root, f"{where}[{k!r}]")
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == ref.dtype, (where, got.dtype, ref.dtype)
        np.testing.assert_array_equal(got, ref, err_msg=where)
    elif isinstance(ref, str) and ref.startswith(ref_root):
        assert got == got_root + ref[len(ref_root):], where
    else:
        assert type(got) is type(ref) and got == ref, (where, got, ref)


def assert_same_output(got_root: str, ref_root: str, roots=None) -> int:
    """The two directories hold the same files; PNGs pixel-equal, the
    ``gt.npy`` stores equal, their paths read relative to ``roots`` (got,
    ref; default: the two directories). Returns the number of files."""
    files = sorted(os.listdir(ref_root))
    assert sorted(os.listdir(got_root)) == files
    for f in files:
        if f.endswith(".png"):
            g, r = _png(os.path.join(got_root, f)), _png(
                os.path.join(ref_root, f))
            assert g.dtype == r.dtype and g.shape == r.shape, f
            np.testing.assert_array_equal(g, r, err_msg=f)
    if "gt.npy" in files:
        _same(md.load_store(got_root), md.load_store(ref_root),
              *(roots or (got_root, ref_root)))
    return len(files)


# ---------- ops.contour, data.annotations ----------

def test_contour_matches_jax():
    r = np.random.RandomState(3)
    pts = r.rand(40, 2) * 100
    flat = list(pts[:, 0]) + list(pts[:, 1])
    assert tcontour.sort_clockwise(flat) == jcontour.sort_clockwise(flat)
    for n in (2, 7, 64):
        np.testing.assert_array_equal(
            tcontour.evenly_spaced_points_on_a_contour(pts, n),
            jcontour.evenly_spaced_points_on_a_contour(pts, n))
    for t in (9, np.array([0.0, 0.3, 0.95, 1.0])):
        np.testing.assert_array_equal(tcontour.interparc(pts, t),
                                      jcontour.interparc(pts, t))
    flat_pts = np.ones((5, 2))          # zero arclength
    np.testing.assert_array_equal(tcontour.interparc(flat_pts, 4),
                                  jcontour.interparc(flat_pts, 4))


@pytest.mark.parametrize("level", [1, 2])
def test_annotations_match_jax(slide_dir, level):
    slide = open_slide(os.path.join(slide_dir, "s1.npy"))
    aperio = os.path.join(slide_dir, "s1.xml")
    sedeen = os.path.join(slide_dir, "s1.session.xml")
    got, ref = tann.read_aperio_xml(aperio), jann.read_aperio_xml(aperio)
    assert got[1:] == ref[1:] and got[1] == [3, 2, 1, 3]
    for g, r in zip(got[0], ref[0]):
        np.testing.assert_array_equal(g, r)
    gt = tann.get_gt_aperio(aperio, slide, level)
    gt_r = jann.get_gt_aperio(aperio, slide, level)
    np.testing.assert_array_equal(gt, gt_r)
    assert gt.dtype == gt_r.dtype and set(np.unique(gt)) == {0, 1, 2, 3}
    np.testing.assert_array_equal(tann.get_tb_aperio(gt, slide, level),
                                  jann.get_tb_aperio(gt_r, slide, level))
    np.testing.assert_array_equal(gt, gt_r)      # both zeroed benign
    for fn in ("get_gt_sedeen", "get_tb_sedeen"):
        g, r = (getattr(m, fn)(sedeen, slide, level) for m in (tann, jann))
        assert g.dtype == r.dtype and g.max() > 0
        np.testing.assert_array_equal(g, r)
    for tb_only in (False, True):
        g, r = (m.read_sedeen_xml(sedeen, tb_only) for m in (tann, jann))
        assert g[1] == r[1]
        for a, b in zip(g[0], r[0]):
            np.testing.assert_array_equal(a, b)
    assert tann.find_extension(slide_dir) == jann.find_extension(slide_dir)
    for label in ("DCIS", "no dcis", "IDC", "UDH", "tb", "cellularity 5"):
        assert tann.sedeen_class(label) == jann.sedeen_class(label)


# ---------- the dispatcher ----------

def test_commands_and_generators_match_jax(capsys):
    from wsiseg_tpu.__main__ import COMMANDS as JAX_COMMANDS
    from wsiseg_tpu.preprocess.__main__ import GENERATORS as JAX_GENERATORS
    from wsiseg_tpu_torch.__main__ import COMMANDS, main
    from wsiseg_tpu_torch.preprocess.__main__ import GENERATORS
    assert sorted(COMMANDS) == sorted(JAX_COMMANDS)
    for name in ("preprocess", "overlay-tb", "check-fp",
                 "closest-regionproposal"):
        assert COMMANDS[name][1] == JAX_COMMANDS[name][1]
    assert list(GENERATORS) == list(JAX_GENERATORS)
    main(["preprocess", "--help"])
    listed = capsys.readouterr().out.split()
    assert all(name in listed for name in GENERATORS)
    with pytest.raises(SystemExit, match="unknown generator"):
        main(["preprocess", "no-such-generator"])


# ---------- photo and patch generators (copies, and quantize) ----------

def test_patch_to_gt_matches_jax(photos_dir, tmp_path):
    from wsiseg_tpu.preprocess import patch_to_gt as jmod
    from wsiseg_tpu_torch.preprocess import patch_to_gt as tmod
    jmod.generate(photos_dir, str(tmp_path / "ref"),
                  jax_config(tile_w=64, tile_h=48))
    tmod.generate(photos_dir, str(tmp_path / "got"),
                  default_config(tile_w=64, tile_h=48))
    assert assert_same_output(str(tmp_path / "got"),
                              str(tmp_path / "ref")) == 17


@pytest.mark.parametrize("option", ["classification", "segmentation"])
def test_ssr_patch_to_gt_matches_jax(photos_dir, tmp_path, option):
    from wsiseg_tpu.preprocess import ssr_patch_to_gt as jmod
    from wsiseg_tpu_torch.preprocess import ssr_patch_to_gt as tmod
    jmod.generate(photos_dir, str(tmp_path / "ref"),
                  jax_config(tile_w=32, tile_h=32), option=option)
    tmod.generate(photos_dir, str(tmp_path / "got"),
                  default_config(tile_w=32, tile_h=32), option=option)
    assert assert_same_output(str(tmp_path / "got"),
                              str(tmp_path / "ref")) == 8 + (
        1 if option == "classification" else 8)


def test_collage_matches_jax(photos_dir, tmp_path):
    from wsiseg_tpu.preprocess import collage_of_patches as jmod
    from wsiseg_tpu_torch.preprocess import collage_of_patches as tmod
    arr = np.arange(5 * 2 * 3).reshape(5, 2, 3, 1)
    np.testing.assert_array_equal(tmod.gallery(arr, 2), jmod.gallery(arr, 2))
    kw = dict(tile_w=32, tile_h=32, tile_stride_w=16, tile_stride_h=32,
              scan_level=1, scan_resize=1)
    for mod, cfg, out in ((jmod, jax_config(**kw), "ref"),
                          (tmod, default_config(**kw), "got")):
        mod.generate(photos_dir, str(tmp_path / out), cfg, ncols=3, seed=2,
                     photo_hw=(96 * 4, 128 * 4))
    assert assert_same_output(str(tmp_path / "got"),
                              str(tmp_path / "ref")) > 10


def _breakhis(root):
    rng = np.random.RandomState(0)
    for sub, name in [
            ("ductal_carcinoma/SOB_M_DC_14-2523/40X", "dc0.png"),
            ("lobular_carcinoma/SOB_M_LC_14-13412/40X", "lc0.png"),
            ("ductal_carcinoma/SOB_M_DC_14-2523/100X", "dc2.png")]:
        d = root / "malignant" / "SOB" / sub
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.randint(0, 255, (48, 56, 3), np.uint8)).save(
            str(d / name))
    return str(root)


def _breastpathq(root):
    rng = np.random.RandomState(1)
    root.mkdir()
    rows = ["slide,rid,y"]
    for iid, rid, cell in [(1, 1, 0.0), (1, 2, 0.4), (2, 1, 0.9)]:
        img = level2_patch(rng, 40, 48)
        Image.fromarray(img).save(str(root / f"{iid}_{rid}.tif"))
        rows.append(f"{iid},{rid},{cell}")
    (root / "labels.csv").write_text("\n".join(rows))
    return str(root)


def level2_patch(rng, h, w):
    """An H&E-like patch: a few colour blobs with noise, so that k-means
    quantization has clusters to find."""
    from wsiseg_tpu_torch.data.bench_slide import level2_image
    return level2_image(h, w, seed=int(rng.randint(1000)))


@pytest.mark.parametrize("flavor", ["bach", "breakhis", "breastpathq",
                                    "breastpathq-quantized"])
def test_patch_to_cls_matches_jax(photos_dir, tmp_path, monkeypatch,
                                  flavor):
    from wsiseg_tpu.preprocess import patch_to_cls as jmod
    from wsiseg_tpu_torch.preprocess import patch_to_cls as tmod
    monkeypatch.setattr(tkm, "plusplus_init", jax_seeds("none"))
    kw = dict(tile_w=32, tile_h=24)
    jcfg, cfg = jax_config(**kw), default_config(**kw)
    ref, got = str(tmp_path / "ref"), str(tmp_path / "got")
    if flavor == "bach":
        jmod.generate_bach(photos_dir, ref, jcfg)
        tmod.generate_bach(photos_dir, got, cfg)
    elif flavor == "breakhis":
        src = _breakhis(tmp_path / "breakhis")
        jmod.generate_breakhis(src, ref, jcfg)
        tmod.generate_breakhis(src, got, cfg)
    else:
        src = _breastpathq(tmp_path / "bpq")
        csv = os.path.join(src, "labels.csv")
        q = 4 if flavor.endswith("quantized") else 0
        for regression in (True, False):
            jmod.generate_breastpathq(src, csv, ref, jcfg, regression,
                                      quantize_colors=q)
            tmod.generate_breastpathq(src, csv, got, cfg, regression,
                                      quantize_colors=q, device="cpu")
        if q:
            assert len(np.unique(_png(os.path.join(got, "w_1_2.png"))
                                 .reshape(-1, 3), axis=0)) <= 4
    assert assert_same_output(got, ref) >= 3


@pytest.mark.parametrize("quantize", [0, 4])
def test_breastpathq_cells_matches_jax(tmp_path, monkeypatch, quantize):
    from wsiseg_tpu.preprocess import breastpathq_cells as jmod
    from wsiseg_tpu_torch.preprocess import breastpathq_cells as tmod
    monkeypatch.setattr(tkm, "plusplus_init", jax_seeds("none"))
    rng = np.random.RandomState(0)
    cells = tmp_path / "cells"
    cells.mkdir()
    for name in ("1_Region 1", "2_Region 3"):
        Image.fromarray(level2_patch(rng, 64, 64)).save(
            str(cells / f"{name}_crop.tif"))
        dots = np.full((64, 64, 3), 255, np.uint8)
        for y, x in rng.randint(0, 64, (5, 2)):
            dots[y, x] = 0
        Image.fromarray(dots).save(str(cells / f"{name}_mask.tif"))
    kw = dict(tile_w=48, tile_h=48)
    jmod.generate(str(cells), str(tmp_path / "ref"), jax_config(**kw),
                  quantize_colors=quantize)
    tmod.generate(str(cells), str(tmp_path / "got"), default_config(**kw),
                  quantize_colors=quantize, device="cpu")
    assert assert_same_output(str(tmp_path / "got"),
                              str(tmp_path / "ref")) == 5
    g = _png(tmp_path / "got" / "g_1_Region_1_crop.tif_0.png")
    assert 0 < (g > 0).sum() < g.size // 2


# ---------- slide generators ----------

@pytest.mark.parametrize("option", ["classification", "segmentation"])
def test_makedata_ssr_matches_jax(slide_dir, tmp_path, option):
    from wsiseg_tpu.preprocess import makedata_ssr as jmod
    from wsiseg_tpu_torch.preprocess import makedata_ssr as tmod
    kw = dict(tile_w=32, tile_h=32, scan_level=1)
    outs = {}
    for mod, cfg, tag in ((jmod, jax_config(**kw), "ref"),
                          (tmod, default_config(**kw), "got")):
        outs[tag] = [str(tmp_path / tag / s) for s in ("train", "val")]
        mod.generate(slide_dir, outs[tag], cfg, option=option,
                     split=([0], [1]))
    assert assert_same_output(outs["got"][0], outs["ref"][0]) >= 3
    assert assert_same_output(outs["got"][1], outs["ref"][1]) == 0


@pytest.mark.parametrize("fmt", ["aperio", "sedeen"])
def test_mk_gt_matches_jax(slide_dir, tmp_path, fmt):
    from wsiseg_tpu.preprocess import mk_gt as jmod
    from wsiseg_tpu_torch.preprocess import mk_gt as tmod
    wsipath = os.path.join(slide_dir, "s1.npy")
    xml = os.path.join(slide_dir, "s1.xml" if fmt == "aperio"
                       else "s1.session.xml")
    slide = open_slide(wsipath)
    for mod, cfg, tag in ((jmod, jax_config(), "ref"),
                          (tmod, default_config(), "got")):
        os.makedirs(tmp_path / tag)
        kw = {} if mod is jmod else {"device": "cpu"}
        mod.generate_for_slide(slide, wsipath, xml, cfg, fmt=fmt,
                               out_dir=str(tmp_path / tag), **kw)
    assert assert_same_output(str(tmp_path / "got"),
                              str(tmp_path / "ref")) == 4
    assert _png(tmp_path / "got" / "s1.npy_find_nuclei.png").max() == 1


@pytest.mark.parametrize("fmt", ["aperio", "sedeen"])
def test_centered_matches_jax(slide_dir, tmp_path, monkeypatch, fmt):
    """Small components give one snapped tile, large ones a tile per
    k-means center (JAX's seeds on the unpadded points)."""
    from wsiseg_tpu.preprocess import mk_traindata_centered as jmod
    from wsiseg_tpu_torch.preprocess import mk_traindata_centered as tmod
    monkeypatch.setattr(tkm, "plusplus_init", jax_seeds("none"))
    kw = dict(tile_w=32, tile_h=32, scan_level=1)
    jmod.generate(slide_dir, str(tmp_path / "ref"), jax_config(**kw),
                  fmt=fmt)
    tmod.generate(slide_dir, str(tmp_path / "got"), default_config(**kw),
                  fmt=fmt, device="cpu")
    n = assert_same_output(str(tmp_path / "got"), str(tmp_path / "ref"))
    assert n >= 2 * 4 + 1          # tile pairs and the store


def test_no_tumors_matches_jax(slide_dir, tmp_path, monkeypatch):
    from wsiseg_tpu.preprocess import mk_traindata_no_tumors as jmod
    from wsiseg_tpu_torch.preprocess import mk_traindata_no_tumors as tmod
    monkeypatch.setattr(tkm, "plusplus_init", jax_seeds("none"))
    kw = dict(tile_w=32, tile_h=32, scan_level=1)
    jmod.generate(slide_dir, str(tmp_path / "ref"), jax_config(**kw))
    tmod.generate(slide_dir, str(tmp_path / "got"), default_config(**kw),
                  device="cpu")
    assert assert_same_output(str(tmp_path / "got"),
                              str(tmp_path / "ref")) >= 3
    store = md.load_store(str(tmp_path / "got"))
    for rec in store["s1.npy"].values():
        assert (_png(rec["label"]) == 0).all()


def test_region_proposal_points_cc_matches_jax(slide_dir, tmp_path,
                                               monkeypatch):
    from wsiseg_tpu.preprocess import region_proposal_points as jmod
    from wsiseg_tpu_torch.preprocess import region_proposal_points as tmod
    monkeypatch.setattr(tkm, "plusplus_init", jax_seeds("pow2"))
    ref = jmod.generate_cc(slide_dir, str(tmp_path / "ref"),
                           jax_config(scan_level=1), scan_level=1)
    got = tmod.generate_cc(slide_dir, str(tmp_path / "got"),
                           default_config(scan_level=1), scan_level=1,
                           device="cpu")
    assert assert_same_output(str(tmp_path / "got"),
                              str(tmp_path / "ref")) == 1
    _same(got, ref, "", "")
    regions = got["s1.npy"]
    assert len(regions) >= 2
    for rec in regions.values():
        assert rec[0]["cnt_xy"].shape == (8, 2)
        assert rec[0]["cnt_xy"].dtype == np.int64


def test_region_proposal_points_slic_matches_jax(slide_dir, tmp_path,
                                                 monkeypatch):
    """SLIC labels ≥ 99 % equal; then, both fed JAX's labels, the
    proposals at ``test_slic_and_cc_proposals_match_jax``'s limits."""
    from wsiseg_tpu.ops import slic as jslic
    from wsiseg_tpu.preprocess import region_proposal_points as jmod
    from wsiseg_tpu_torch.ops import slic as tslic
    from wsiseg_tpu_torch.preprocess import region_proposal_points as tmod
    monkeypatch.setattr(tkm, "plusplus_init", jax_seeds("pow2"))
    seen, port = {}, tslic.slic

    def port_slic(img, **kw):
        seen["got"] = port(img, **kw).numpy()
        seen["ref"] = np.asarray(jslic.slic(img.numpy(), **kw))
        return torch.from_numpy(np.array(seen["ref"]))

    monkeypatch.setattr(tslic, "slic", port_slic)
    kw = dict(num_segments=40, us_kmeans=4, scan_level=1)
    ref = jmod.generate_slic(slide_dir, str(tmp_path / "ref"),
                             jax_config(scan_level=1), **kw)
    got = tmod.generate_slic(slide_dir, str(tmp_path / "got"),
                             default_config(scan_level=1), device="cpu",
                             **kw)
    assert (seen["got"] == seen["ref"]).mean() >= 0.99
    assert len(np.unique(seen["ref"])) >= 20
    got, ref = got["s1.npy"][0], ref["s1.npy"][0]
    assert list(got) == list(ref) and len(ref) >= 10
    for key in ref:
        g, r = got[key], ref[key]
        assert g["cnt_xy"].shape == r["cnt_xy"].shape
        assert np.abs(g["cnt_xy"] - r["cnt_xy"]).max() <= kw["us_kmeans"]
        np.testing.assert_array_equal(g["perim_xy"], r["perim_xy"])
        for k in ("wsipath", "label", "scan_level", "tile_id"):
            assert g[k] == r[k]


def test_region_proposal_points_patch_matches_jax(photos_dir, tmp_path):
    from wsiseg_tpu.preprocess import region_proposal_points as jmod
    from wsiseg_tpu_torch.preprocess import region_proposal_points as tmod
    jmod.generate_patch(photos_dir, str(tmp_path / "ref"), jax_config())
    got = tmod.generate_patch(photos_dir, str(tmp_path / "got"),
                              default_config())
    assert assert_same_output(str(tmp_path / "got"),
                              str(tmp_path / "ref")) == 1
    assert len(got["P"][0]) == 8 and got["P"][0][0]["dimensions"] == \
        (128, 96)


# ---------- the CLI, and the card by default ----------

def test_cli_runs_generators_on_cpu(slide_dir, photos_dir, tmp_path,
                                    monkeypatch):
    """``python -m wsiseg_tpu_torch preprocess ...`` with ``--device cpu``
    (``patch-to-cls``'s CLI runs no device op and takes none) writes what
    the JAX module's ``main`` writes."""
    from wsiseg_tpu.preprocess import mk_gt as jmk_gt
    from wsiseg_tpu.preprocess import patch_to_cls as jpatch_to_cls
    from wsiseg_tpu.preprocess import region_proposal_points as jrpp
    from wsiseg_tpu_torch.__main__ import main
    monkeypatch.setattr(tkm, "plusplus_init", jax_seeds("pow2"))
    for tag in ("ref", "got"):
        os.makedirs(tmp_path / tag / "wsi")
        for f in ("s1.npy", "s1.xml"):
            os.symlink(os.path.join(slide_dir, f), tmp_path / tag / "wsi" / f)
    runs = [
        (jmk_gt.main, ["mk-gt"], ["--raw_val_pth", "{}/wsi"], "wsi"),
        (jrpp.main, ["region-proposal-points", "--mode", "cc"],
         ["--raw_train_pth", "{}/wsi", "--train_hr_image_pth", "{}/hr"],
         "hr"),
        (jpatch_to_cls.main, ["patch-to-cls", "--flavor", "bach"],
         ["--patch_folder", photos_dir, "--train_image_pth", "{}/cls",
          "--tile_w", "32", "--tile_h", "32"], "cls"),
    ]
    for jax_main, cmd, flags, out in runs:
        jax_main(cmd[1:] + [f.format(tmp_path / "ref") for f in flags])
        device = [] if cmd[0] == "patch-to-cls" else ["--device", "cpu"]
        main(["preprocess"] + cmd + [f.format(tmp_path / "got")
                                     for f in flags] + device)
        assert assert_same_output(
            str(tmp_path / "got" / out), str(tmp_path / "ref" / out),
            (str(tmp_path / "got"), str(tmp_path / "ref"))) >= 1


DEVICE_TOOLS = {
    "mk-gt": ["mk-gt", "--raw_val_pth", "{}"],
    "centered": ["centered", "--raw_train_pth", "{}"],
    "no-tumors": ["no-tumors", "--raw_train_pth", "{}"],
    "breastpathq-cells": ["breastpathq-cells", "--patch_folder", "{}"],
    "region-proposal-points-cc": ["region-proposal-points", "--mode", "cc",
                                  "--raw_train_pth", "{}"],
    "region-proposal-points-slic": ["region-proposal-points", "--mode",
                                    "slic", "--raw_train_pth", "{}"],
}


@pytest.mark.parametrize("tool", sorted(DEVICE_TOOLS) + ["patch-to-cls"])
def test_device_tools_need_a_card_by_default(tool, tmp_path):
    """Every generator that runs a device op defaults to the card and
    raises without one, before it reads or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from wsiseg_tpu_torch.__main__ import main
    if tool == "patch-to-cls":       # its CLI never quantizes
        from wsiseg_tpu_torch.preprocess.patch_to_cls import (
            generate_breastpathq)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            generate_breastpathq(str(tmp_path), "x.csv", str(tmp_path),
                                 default_config(), quantize_colors=4)
        return
    argv = [a.format(tmp_path) for a in DEVICE_TOOLS[tool]]
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["preprocess"] + argv)
    assert os.listdir(tmp_path) == []


def test_ellipse_dilate_is_square_as_in_jax():
    """The reference dilates with an ellipse; JAX's ``_ellipse_dilate``
    dilates with a square, and the port copies it (ROADMAP.md §3)."""
    from wsiseg_tpu_torch.preprocess.breastpathq_cells import _ellipse_dilate
    dot = np.zeros((21, 21), bool)
    dot[10, 10] = True
    out = _ellipse_dilate(dot, 10, device="cpu")
    assert out.dtype == np.uint8 and out.sum() == 100
    np.testing.assert_array_equal(np.argwhere(out)[[0, -1]],
                                  [[5, 5], [14, 14]])
