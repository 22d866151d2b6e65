"""The port's paper tools (``wsiseg_tpu_torch.paper_tools``) against the
JAX package's on the same seeded inputs, on the CPU (``device="cpu"``):
heatmap PNGs, a ``.npy`` synthetic slide and a class-coded GT raster.

Limits: ``check-fp``'s per-slide flags and metric report, and the line
it prints, exact (the opening equals JAX's since the eval slice);
``overlay-tb``'s arrays and PNGs pixel-exact; ``closest-regionproposal``'s
keypoints, perimeters, areas, pairs and printed lines exact, with JAX's
k-means seeds patched in (``jax_seeds("pow2")``: ``get_key_points`` pads
its points to a power of two; the port seeds from
``np.random.RandomState`` by design)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_proposals import jax_seeds
from wsiseg_tpu.paper_tools import check_for_false_positives as jfp
from wsiseg_tpu.paper_tools import closest_regionproposal as jcr
from wsiseg_tpu.paper_tools import overlay_tb_wsi as jov
from wsiseg_tpu.slides.reader import SyntheticSlide
from wsiseg_tpu_torch.__main__ import main
from wsiseg_tpu_torch.ops import kmeans as tkm
from wsiseg_tpu_torch.paper_tools import check_for_false_positives as tfp
from wsiseg_tpu_torch.paper_tools import closest_regionproposal as tcr
from wsiseg_tpu_torch.paper_tools import overlay_tb_wsi as tov

torch.set_num_threads(2)


def _heatmap(seed: int, hot: bool, hw=(96, 128)) -> np.ndarray:
    """A noisy heatmap; ``hot`` adds a 60×70 block at 255 with a hole
    that the 50×50 opening's windows have to avoid."""
    r = np.random.RandomState(seed)
    hm = r.randint(0, 240, hw).astype(np.uint8)
    hm[r.rand(*hw) < 0.01] = 255            # specks the opening removes
    if hot:
        hm[20:80, 30:100] = 255
        hm[30:32, 40:42] = 100
    return hm


@pytest.fixture(scope="module")
def screening_tree(tmp_path_factory):
    """``raw/`` with five ``.npy`` slides (ids 1–5; 1, 2 and 4 annotated,
    one in a ``Case*`` folder) and ``out/<ep>/<id>.npy_32_heatmap.png``
    (1, 3 and 4 hot)."""
    root = tmp_path_factory.mktemp("fp")
    raw, out = root / "raw", root / "out" / "0"
    (raw / "Case1").mkdir(parents=True)
    out.mkdir(parents=True)
    for sid in range(1, 6):
        d = raw / "Case1" if sid == 5 else raw
        np.save(d / f"{sid}.npy", np.zeros((4, 4, 3), np.uint8))
        if sid in (1, 2, 4):
            (d / f"{sid}.xml").write_text("<Annotations/>")
        Image.fromarray(_heatmap(sid, sid in (1, 3, 4))).save(
            out / f"{sid}.npy_32_heatmap.png")
    return str(raw), str(root / "out")


def test_screen_matches_jax(screening_tree):
    _, out = screening_tree
    for sid in range(1, 6):
        hm = np.asarray(Image.open(os.path.join(
            out, "0", f"{sid}.npy_32_heatmap.png")))
        for open_size, thresh in ((50, 0.0), (10, 0.0), (10, 0.02)):
            got = tfp.screen_heatmap(hm, open_size=open_size,
                                     cancer_thresh=thresh, device="cpu")
            assert got == jfp.screen_heatmap(hm, open_size=open_size,
                                             cancer_thresh=thresh)
    pairs = [(sid, os.path.join(out, "0", f"{sid}.npy_32_heatmap.png"))
             for sid in range(1, 6)]
    logs = {}
    for tag, mod, kw in (("got", tfp, {"device": "cpu"}), ("ref", jfp, {})):
        rep = mod.screen_slides(pairs, [1, 2, 4], benign_ids=[2],
                                log=lambda s, t=tag: logs.setdefault(t, s),
                                **kw)
        logs[tag + "_report"] = rep
    assert logs["got"] == logs["ref"]
    assert logs["got_report"] == logs["ref_report"]
    assert logs["got_report"]["acc"] == 0.8


def test_check_fp_cli_matches_jax(screening_tree, capsys):
    raw, out = screening_tree
    argv = ["--raw_val_pth", raw, "--val_save_pth", out, "--benign", "2"]
    jfp.main(argv)
    ref = capsys.readouterr().out
    report = main(["check-fp"] + argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == ref and got.startswith("acc. ")
    assert set(report) == {"acc", "f1", "precision", "recall", "auc",
                           "confusion"}
    with pytest.raises(SystemExit, match="no \\(slide, heatmap\\)"):
        main(["check-fp", "--raw_val_pth", raw, "--val_save_pth",
              os.path.join(out, "none"), "--device", "cpu"])


def test_overlay_tumor_bed_matches_jax():
    r = np.random.RandomState(0)
    wsi = r.randint(0, 255, (96, 128, 3), np.uint8)
    hm = _heatmap(1, True)
    for open_size, dilate_size in ((5, 3), (30, 20), (4, 7)):
        got = tov.overlay_tumor_bed(wsi, hm, open_size=open_size,
                                    dilate_size=dilate_size, device="cpu")
        ref = jov.overlay_tumor_bed(wsi, hm, open_size=open_size,
                                    dilate_size=dilate_size)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["tb_perim"].max() == 255


def test_overlay_cli_matches_jax(tmp_path, capsys):
    """``overlay-tb <id>`` finds the slide and its heatmap and writes the
    four PNGs the JAX tool writes."""
    raw, hms = tmp_path / "raw", tmp_path / "out" / "0"
    raw.mkdir()
    hms.mkdir(parents=True)
    np.save(raw / "7.npy", SyntheticSlide(width=2048, height=1536,
                                          num_levels=1, seed=3).read_level(0))
    Image.fromarray(_heatmap(7, True, (192, 256))).save(
        hms / "7.npy_32_heatmap.png")
    for tag in ("ref", "got"):
        (tmp_path / tag).mkdir()
    argv = ["7", "--raw_val_pth", str(raw), "--val_save_pth",
            str(tmp_path / "out")]
    jov.main(argv + ["--out_dir", str(tmp_path / "ref")])
    paths = main(["overlay-tb"] + argv + ["--out_dir", str(tmp_path / "got"),
                                          "--device", "cpu"])
    assert sorted(paths) == ["heatmap", "overlay", "tb_perim", "wsi"]
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "got")) == names and len(names) == 4
    for f in names:
        g = np.asarray(Image.open(tmp_path / "got" / f))
        np.testing.assert_array_equal(
            g, np.asarray(Image.open(tmp_path / "ref" / f)), err_msg=f)
    assert g.shape[:2] == (48, 64)
    with pytest.raises(SystemExit, match="not found"):
        main(["overlay-tb", "8"] + argv[1:] + ["--device", "cpu"])


@pytest.fixture(scope="module")
def gt_png(tmp_path_factory):
    """A 200×240 class-coded GT raster: five components, the third (in
    scan order) too small for keypoints."""
    gt = np.zeros((200, 240), np.uint8)
    gt[10:80, 20:100] = 3
    gt[30:70, 110:160] = 2
    gt[120:190, 40:130] = 1
    gt[150:180, 150:200] = 3
    gt[100:104, 220:224] = 2
    pth = str(tmp_path_factory.mktemp("gt") / "gt.png")
    Image.fromarray(gt).save(pth)
    return pth


def test_closest_regionproposal_matches_jax(gt_png, monkeypatch, capsys):
    monkeypatch.setattr(tkm, "plusplus_init", jax_seeds("pow2"))
    gt = np.asarray(Image.open(gt_png))
    got = tcr.analyze_regions(gt, 16, device="cpu")
    ref = jcr.analyze_regions(gt, 16)
    assert list(got) == list(ref) == [1, 2, 4, 5]   # 3: too small
    for rid in ref:
        assert got[rid]["area"] == ref[rid]["area"]
        for k in ("cnt_xy", "perim_xy"):
            assert got[rid][k].dtype == ref[rid][k].dtype
            np.testing.assert_array_equal(got[rid][k], ref[rid][k])
    assert got[1]["perim_xy"].shape == (16, 2)
    pairs = tcr.nearest_region_pairs(got)
    assert pairs == jcr.nearest_region_pairs(ref) and len(pairs) == 4
    mask = gt > 0
    np.testing.assert_array_equal(
        tcr.region_perimeter_points(mask, 12, us=2),
        jcr.region_perimeter_points(mask, 12, us=2))
    jcr.main([gt_png, "--num_perim_points", "16"])
    printed = capsys.readouterr().out
    assert main(["closest-regionproposal", gt_png, "--num_perim_points",
                 "16", "--device", "cpu"]) == pairs
    assert capsys.readouterr().out == printed
    assert printed.count("nearest region") == 4


@pytest.mark.parametrize("tool", ["overlay-tb", "check-fp",
                                  "closest-regionproposal"])
def test_paper_tools_need_a_card_by_default(tool, tmp_path):
    """Each paper tool defaults to the card and raises without one,
    before it reads anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = {"overlay-tb": ["7", "--raw_val_pth", str(tmp_path)],
            "check-fp": ["--raw_val_pth", str(tmp_path)],
            "closest-regionproposal": [str(tmp_path / "gt.png")]}[tool]
    with pytest.raises(RuntimeError, match="--device cpu"):
        main([tool] + argv)
    for fn, args in ((tov.overlay_tumor_bed, (np.zeros((4, 4, 3)),
                                              np.zeros((4, 4)))),
                     (tfp.screen_heatmap, (np.zeros((4, 4)),)),
                     (tcr.analyze_regions, (np.zeros((4, 4)),))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(*args)
