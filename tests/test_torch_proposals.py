"""The port's proposal ops and pipeline (``wsiseg_tpu_torch.ops.slic``,
``ops.kmeans``, ``ops.cc``, ``data.regions`` keypoints, ``proposals`` and
``cli.slic_demo.run_slic_pipeline``) against the JAX package's on the
same seeded numpy inputs, on the CPU.

k-means++ seeding differs by design: JAX draws from threefry, the port
from ``np.random.RandomState`` on the host (so the card and the CPU seed
alike). Lloyd is held against JAX's ``kmeans`` from JAX's own
``_plusplus_init`` seeds, and every keypoint and proposal test replaces
the port's ``plusplus_init`` with one that returns JAX's seeds
(:func:`jax_seeds`) for the points JAX seeds, padding included.

Limits: Lab and the blur 1e-5·max; SLIC labels ≥ 99 % equal; Lloyd's
centers rtol 1e-5 and labels ≥ 99.9 %; connected components exact; same
proposal keys, centers within ``us`` px, perimeter points exact,
foreground sets ≥ 99 % equal; painting and boundaries pixel-exact."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from wsiseg_tpu import proposals as jprop
from wsiseg_tpu.config import default_config as jax_config
from wsiseg_tpu.data import regions as jreg
from wsiseg_tpu.ops import cc as jcc
from wsiseg_tpu.ops import kmeans as jkm
from wsiseg_tpu.ops import slic as jslic
from wsiseg_tpu.ops.color import rgb_to_lab as jax_rgb_to_lab
from wsiseg_tpu_torch import proposals as tprop
from wsiseg_tpu_torch.config import default_config
from wsiseg_tpu_torch.data import regions as treg
from wsiseg_tpu_torch.data.bench_slide import level2_image
from wsiseg_tpu_torch.ops import cc as tcc
from wsiseg_tpu_torch.ops import kmeans as tkm
from wsiseg_tpu_torch.ops import slic as tslic
from wsiseg_tpu_torch.ops.color import rgb_to_lab

torch.set_num_threads(2)

_JAX_INIT = jax.jit(jkm._plusplus_init, static_argnums=2)


def jax_seeds(pad: str):
    """A stand-in for the port's ``plusplus_init`` returning JAX's seeds:
    ``_plusplus_init(PRNGKey(seed), ...)`` of the points as the JAX
    caller passes them — padded with zero weights to a power of two ≥ 256
    (``get_key_points``), to a multiple of 8 (``mask_keypoints``) or not
    at all (``quantize_image``)."""

    def seeds(points, k, weights=None, seed=0):
        p = np.asarray(points.cpu() if isinstance(points, torch.Tensor)
                       else points, np.float32)
        n = len(p)
        size = {"pow2": max(256, 1 << (n - 1).bit_length()),
                "8": n + (-n) % 8, "none": n}[pad]
        w = np.zeros(size, np.float32)
        w[:n] = 1.0 if weights is None else np.asarray(weights)
        pp = np.zeros((size, p.shape[1]), np.float32)
        pp[:n] = p
        return np.asarray(_JAX_INIT(jax.random.PRNGKey(seed),
                                    jnp.asarray(pp), k, jnp.asarray(w)))

    return seeds


@pytest.fixture
def jax_seeded(monkeypatch):
    monkeypatch.setattr(tkm, "plusplus_init", jax_seeds("pow2"))


# ---------- SLIC ----------

def test_lab_and_blur_match_jax():
    img = level2_image(48, 64, seed=2)
    ref = np.asarray(jax_rgb_to_lab(jnp.asarray(img, jnp.float32) / 255.0))
    got = rgb_to_lab(torch.from_numpy(img).float() / 255.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    ref_b = np.asarray(jslic._gaussian_blur(jnp.asarray(ref), 5.0))
    got_b = tslic._gaussian_blur(torch.tensor(ref), 5.0).numpy()
    np.testing.assert_allclose(got_b, ref_b, rtol=0,
                               atol=1e-5 * np.abs(ref_b).max())


def test_slic_matches_jax():
    img = level2_image(96, 128, seed=1)
    ref = np.asarray(jslic.slic(img, n_segments=12, compactness=20.0,
                                sigma=5.0))
    got = tslic.slic(torch.from_numpy(img), n_segments=12,
                     compactness=20.0, sigma=5.0)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    assert (got.numpy() == ref).mean() >= 0.99
    assert len(np.unique(ref)) >= 8


def test_mark_boundaries_matches_jax():
    r = np.random.RandomState(4)
    labels = r.randint(0, 3, (12, 16)).repeat(2, 0).repeat(2, 1)
    img = r.randint(0, 256, (24, 32, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        tslic.mark_boundaries(img, labels, color=(0, 0, 0)),
        jslic.mark_boundaries(img, labels, color=(0, 0, 0)))


# ---------- k-means ----------

def _blobs(seed=0, pad=12):
    r = np.random.RandomState(seed)
    pts = np.concatenate([r.randn(300, 2) * 5 + [20, 30],
                          r.randn(200, 2) * 3 + [60, 10],
                          r.randn(150, 2) * 4 + [5, 70],
                          np.zeros((pad, 2))]).astype(np.float32)
    w = np.concatenate([np.ones(650), np.zeros(pad)]).astype(np.float32)
    return pts, w


def test_lloyd_matches_jax_kmeans():
    pts, w = _blobs()
    key = jax.random.PRNGKey(3)
    c_ref, l_ref = jkm.kmeans(key, jnp.asarray(pts), 5,
                              weights=jnp.asarray(w))
    seeds = _JAX_INIT(key, jnp.asarray(pts), 5, jnp.asarray(w))
    c, lab = tkm.lloyd(torch.from_numpy(pts), np.asarray(seeds), 25,
                       torch.from_numpy(w))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(c_ref)).max())
    assert (lab.numpy() == np.asarray(l_ref)).mean() >= 0.999
    assert (lab.numpy()[w == 0] == -1).all()


def test_seeding_is_deterministic_and_skips_padding():
    pts, w = _blobs(1, pad=40)
    pts[w == 0] = 1e4        # far away: D² sampling would favour them
    a = tkm.plusplus_init(pts, 8, w, seed=5)
    b = tkm.plusplus_init(torch.from_numpy(pts), 8, torch.from_numpy(w),
                          seed=5)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.float32 and a.shape == (8, 2)
    assert (np.abs(a) < 1e3).all()
    assert not np.array_equal(a, tkm.plusplus_init(pts, 8, w, seed=6))
    # every weighted point on one spot: the later seeds fall back to the
    # weights and still never pick padding
    same = np.concatenate([np.ones((5, 2)), np.full((3, 2), 9.0)])
    got = tkm.plusplus_init(same, 3, np.array([1] * 5 + [0] * 3), seed=0)
    np.testing.assert_array_equal(got, np.ones((3, 2)))


def test_quantize_and_mask_keypoints_match_jax(monkeypatch):
    img = level2_image(24, 32, seed=3)
    monkeypatch.setattr(tkm, "plusplus_init", jax_seeds("none"))
    ref = np.asarray(jkm.quantize_image(jax.random.PRNGKey(0),
                                        jnp.asarray(img), 4))
    got = tkm.quantize_image(torch.from_numpy(img), 4)
    np.testing.assert_array_equal(got.numpy(), ref)
    t = torch.from_numpy(img)
    assert tkm.quantize_image(t, 1) is t

    mask = np.zeros((80, 96), np.uint8)
    mask[10:70, 20:90] = 1
    monkeypatch.setattr(tkm, "plusplus_init", jax_seeds("8"))
    k_ref, c_ref = jkm.mask_keypoints(jax.random.PRNGKey(0), mask, 2, 6)
    k, c = tkm.mask_keypoints(mask, 2, 6, device="cpu")
    assert k == k_ref == 6
    np.testing.assert_array_equal(c, c_ref)
    assert tkm.mask_keypoints(mask[:4, :4], 2, 6, device="cpu") == \
        (None, None)


# ---------- connected components ----------

@pytest.mark.parametrize("connectivity", [4, 8])
def test_label_propagation_matches_jax(connectivity):
    r = np.random.RandomState(connectivity)
    mask = (r.rand(40, 56) < 0.5).astype(np.uint8)
    mask[5:35, 20] = 1       # a long component: more than one check
    ref = np.asarray(jcc.label_propagation(jnp.asarray(mask),
                                           connectivity=connectivity))
    got, steps = tcc.label_propagation_steps(torch.from_numpy(mask),
                                             connectivity=connectivity)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert steps % tcc.CHECK_EVERY == 0 and steps > tcc.CHECK_EVERY
    # a cap stops both at the same partial flood
    capped = np.asarray(jcc.label_propagation(
        jnp.asarray(mask), max_iters=5, connectivity=connectivity))
    np.testing.assert_array_equal(tcc.label_propagation(
        torch.from_numpy(mask), max_iters=5,
        connectivity=connectivity).numpy(), capped)


def test_connected_components_match_jax():
    r = np.random.RandomState(7)
    mask = (r.rand(48, 40) < 0.4).astype(np.uint8)
    for conn in (4, 8):
        lab, n = tcc.connected_components(mask, conn)
        lab_r, n_r = jcc.connected_components(mask, conn)
        np.testing.assert_array_equal(lab, lab_r)
        assert n == n_r
    st, st_r = (tcc.connected_components_with_stats(mask),
                jcc.connected_components_with_stats(mask))
    assert st.num == st_r.num
    for a, b in zip(st, st_r):
        np.testing.assert_array_equal(a, b)


# ---------- keypoints and proposals ----------

def _assert_proposals(got: dict, ref: dict, us: int):
    assert sorted(got) == sorted(ref)
    for key in ref:
        g, r = got[key], ref[key]
        assert g["cnt_xy"].shape == r["cnt_xy"].shape
        assert np.abs(g["cnt_xy"] - r["cnt_xy"]).max() <= us, key
        np.testing.assert_array_equal(g["perim_xy"], r["perim_xy"])
        for k in ("wsipath", "scan_level", "tile_id"):
            assert g[k] == r[k]
        gs = set(zip(*g["foreground_indices"]))
        rs = set(zip(*r["foreground_indices"]))
        assert len(gs & rs) >= 0.99 * max(len(gs), len(rs)), key


@pytest.mark.parametrize("side,us", [(120, 2), (150, 1)])
def test_get_key_points_matches_jax(jax_seeded, side, us):
    """(150, 1): 18k foreground points, past the 16384-point cap, so the
    host labels the rest by nearest center."""
    mask = np.zeros((side + 20, side + 30), np.uint8)
    mask[10:10 + side, 20:20 + side] = 1
    mask[40:60, 40:70] = 0
    ref = jreg.get_key_points(mask, us, 8)
    got = treg.get_key_points(mask, us, 8, device="cpu")
    assert got[0] == ref[0] == 8
    assert np.abs(got[1] - ref[1]).max() <= us
    assert (got[2] == ref[2]).mean() >= 0.99
    assert got[2].dtype == ref[2].dtype
    assert treg.get_key_points(mask[:6, :6], 1, 8, device="cpu")[0] is None


def test_get_key_points_for_patch_matches_jax(jax_seeded):
    ref = jreg.get_key_points_for_patch((2048, 1536))
    got = treg.get_key_points_for_patch((2048, 1536), device="cpu")
    np.testing.assert_array_equal(got["perim_xy"], ref["perim_xy"])
    assert np.abs(got["cnt_xy"] - ref["cnt_xy"]).max() <= 1
    assert got["scan_level"] == ref["scan_level"] == 1


def test_slic_and_cc_proposals_match_jax(jax_seeded):
    labels = np.zeros((200, 200), np.int32)
    labels[20:90, 20:90] = 1
    labels[110:190, 110:190] = 2
    labels[100:120, 10:60] = 3
    _assert_proposals(tprop.slic_proposals(labels, "s.npy", device="cpu"),
                      jprop.slic_proposals(labels, "s.npy"), 4)

    cc = np.zeros((400, 400), np.int32)
    cc[20:60, 20:60] = 1          # small: one proposal
    cc[100:300, 80:330] = 2       # large: split by k-means
    cc[350:380, 300:390] = 3
    tissue = np.zeros((400, 400), np.uint8)
    tissue[:, :200] = 1
    _assert_proposals(
        tprop.cc_proposals(cc, "s.npy", tissue_mask=tissue, device="cpu"),
        jprop.cc_proposals(cc, "s.npy", tissue_mask=tissue), 4)


def test_perimeter_keypoints_match_jax():
    m = np.zeros((64, 80), np.uint8)
    m[16:48, 10:70] = 1
    m[20:30, 30:40] = 0
    np.testing.assert_array_equal(tprop.perimeter_keypoints(m),
                                  jprop.perimeter_keypoints(m))
    assert tprop.perimeter_keypoints(np.zeros((4, 4))).shape == (0, 2)


@pytest.fixture(scope="module")
def npy_slide(tmp_path_factory):
    """A 4096² level-0 ``.npy`` slide: a 256² level-2 image repeated 16×
    per axis, so every pyramid level is the same picture."""
    root = tmp_path_factory.mktemp("proposal_slide")
    l2 = level2_image(256, 256, seed=5)
    pth = str(root / "slide.npy")
    np.save(pth, np.repeat(np.repeat(l2, 16, 0), 16, 1))
    return pth


@pytest.mark.parametrize("gate", [False, True])
def test_classify_and_paint_match_jax(jax_seeded, npy_slide, gate):
    from wsiseg_tpu.slides.reader import open_slide as jax_open
    from wsiseg_tpu_torch.slides.reader import open_slide

    labels = np.zeros((256, 256), np.int32)
    labels[30:120, 40:200] = 1
    labels[140:230, 60:180] = 2
    labels[0:8, 0:8] = 3
    meta_r = jprop.slic_proposals(labels, npy_slide)
    meta = tprop.slic_proposals(labels, npy_slide, device="cpu")
    assert sorted(meta) == sorted(meta_r) and 1 in meta

    def stub(images_u8):
        """Logits from the patches' mean colour: deterministic, and the
        same patches give the same classes on both sides."""
        m = images_u8.reshape(len(images_u8), -1, 3).mean(1)
        return np.stack([m[:, 0] / 50, m[:, 1] / 40, m[:, 2] / 60,
                         np.full(len(m), 3.2)], 1).astype(np.float32)

    probs = (0.0, 0.3, 0.3, 0.0) if gate else (0.0,) * 4
    jcfg = jax_config(batch_size=2, class_probs=probs)
    cfg = default_config(batch_size=2, class_probs=probs)
    ref = jprop.classify_proposals(stub, meta_r, labels.shape, jcfg,
                                   slide=jax_open(npy_slide),
                                   gate_class_probs=gate)
    got = tprop.classify_proposals(stub, meta, labels.shape, cfg,
                                   slide=open_slide(npy_slide),
                                   gate_class_probs=gate)
    assert (got == ref).mean() >= 0.99 and len(np.unique(got)) >= 2
    np.testing.assert_array_equal(
        np.asarray(tprop.paint_mask_rgb(ref, 4)),
        np.asarray(jprop.paint_mask_rgb(ref, 4)))


def test_run_slic_pipeline_matches_jax(jax_seeded, npy_slide, tmp_path):
    """The whole pipeline on the 4096² ``.npy`` slide (64² SLIC thumbnail)
    with one random f32 ensemble carried from flax: painted masks ≥ 99 %
    equal, both PNGs written by each side."""
    from test_torch_hr import flax_hr_model
    from wsiseg_tpu.cli import slic_demo as jdemo
    from wsiseg_tpu.slides.reader import open_slide as jax_open
    from wsiseg_tpu_torch.cli import slic_demo as tdemo
    from wsiseg_tpu_torch.cli.common import make_hr_apply
    from wsiseg_tpu_torch.slides.reader import open_slide

    jcfg = jax_config(compute_dtype="float32", batch_size=16)
    cfg = default_config(compute_dtype="float32", batch_size=16)
    jmodel, variables, model = flax_hr_model(jcfg, cfg, num_patches=16)
    ref = jdemo.run_slic_pipeline(
        jax_open(npy_slide), npy_slide, jcfg,
        jdemo.make_hr_forward(jmodel, variables, jcfg),
        out_prefix=str(tmp_path / "jax"), num_segments=12)
    apply = make_hr_apply(model, cfg, device="cpu")
    got = tdemo.run_slic_pipeline(
        open_slide(npy_slide), npy_slide, cfg,
        lambda u8: apply(u8)[1], out_prefix=str(tmp_path / "port"),
        num_segments=12, device="cpu")
    assert got.shape == ref.shape == (256, 256)
    assert (got == ref).mean() >= 0.99
    assert len(np.unique(ref)) >= 2
    for side in ("jax", "port"):
        for suffix in ("_mask.png", ".png"):
            assert os.path.exists(tmp_path / f"{side}{suffix}")
    same = (np.asarray(Image.open(tmp_path / "port.png"))
            == np.asarray(Image.open(tmp_path / "jax.png"))).all(-1)
    assert same.mean() >= 0.99
