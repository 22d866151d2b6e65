"""Port's serving slice (wsiseg_tpu_torch: tissue mask, engine,
evaluators, CLI) against the JAX engine on the same slides and weights."""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from wsiseg_tpu.config import default_config
from wsiseg_tpu.data.wsi_tiles import plan_slide as jax_plan_slide
from wsiseg_tpu.infer.engine import DenseInferenceEngine as JaxEngine
from wsiseg_tpu.models.ynet import init_ynet as flax_init_ynet
from wsiseg_tpu.ops.tissue import find_nuclei as jax_find_nuclei
from wsiseg_tpu.slides import SyntheticSlide
from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection, plan_slide, \
    resize_mask_to
from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
from wsiseg_tpu_torch.infer.evaluators import _pipelined_results
from wsiseg_tpu_torch.infer import writers
from wsiseg_tpu_torch.models.fast_decoder import depth_to_space
from wsiseg_tpu_torch.models.flax_import import from_flax
from wsiseg_tpu_torch.models.ynet import build_ynet, init_ynet
from wsiseg_tpu_torch.ops.tissue import find_nuclei

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE, STRIDE = 64, 32


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_eval")
    return default_config(tile_w=TILE, tile_h=TILE, tile_stride_w=STRIDE,
                          tile_stride_h=STRIDE, compute_dtype="float32",
                          val_save_pth=str(d / "out"), wsi_mask_pth="")


@pytest.fixture(scope="module")
def slide():
    return SyntheticSlide(width=4096, height=3072, num_levels=3, seed=11)


@pytest.fixture(scope="module")
def flax_pair(cfg):
    return flax_init_ynet(cfg, jax.random.PRNGKey(0), tile_hw=(TILE, TILE))


@pytest.fixture(scope="module")
def engine(cfg, flax_pair):
    m = build_ynet(cfg)
    m.load_state_dict(from_flax(jax.tree_util.tree_map(
        np.asarray, dict(flax_pair[1]))))
    return DenseInferenceEngine(m, cfg, device="cpu")


@pytest.mark.parametrize("mode", ["hsv", "lab"])
def test_find_nuclei_matches_jax(slide, mode):
    imgs = [slide.read_level(2), np.random.RandomState(0).randint(
        0, 256, (64, 96, 3)).astype(np.uint8)]
    for img in imgs:
        ref = np.asarray(jax_find_nuclei(jnp.asarray(img), mode=mode))
        got = find_nuclei(img, mode=mode).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("src,dst", [((192, 256), (48, 64)),
                                     ((191, 257), (48, 65)),
                                     ((37, 53), (100, 211)),
                                     ((300, 7), (13, 29))])
def test_resize_mask_matches_pil(src, dst):
    m = np.random.RandomState(src[0]).randint(0, 3, src).astype(np.uint8)
    ref = np.asarray(Image.fromarray(m).resize((dst[1], dst[0]),
                                               Image.NEAREST))
    np.testing.assert_array_equal(resize_mask_to(m, dst), ref)


def test_postprocess_s2d_matches_jax(cfg, flax_pair, engine):
    """Identical f32 logits and mask → equal labels, heat within 1/255."""
    floors = (0.1, 0.3, 0.2, 0.25)
    cfg_f = cfg.replace(class_probs=floors)
    jax_eng = JaxEngine(flax_pair[0], flax_pair[1], cfg_f)
    r = np.random.RandomState(5)
    y = (r.randn(24, 32, 64) * 2).astype(np.float32)
    mask = (r.rand(24, 32) > 0.3).astype(np.uint8)
    jl, jh, _ = jax_eng._postprocess_s2d(jnp.asarray(y), jnp.asarray(mask))
    engine.cfg = cfg_f
    try:
        tl, th = engine._postprocess_s2d(
            torch.from_numpy(y).permute(2, 0, 1)[None],
            torch.from_numpy(mask)[None])
    finally:
        engine.cfg = cfg
    np.testing.assert_array_equal(tl[0].numpy(), np.asarray(jl))
    dh = np.abs(th[0].numpy().astype(int) - np.asarray(jh).astype(int))
    assert dh.max() <= 1


@pytest.mark.parametrize("f", [2, 4])
def test_depth_to_space_matches_interleave4(f):
    """The depth-to-space that ``_postprocess_full`` runs on the fused
    route's u8 planes against JAX's host interleave, cropped at odd
    sizes."""
    planes = torch.from_numpy(np.random.RandomState(f).randint(
        0, 256, (3, f * f, 5, 7)).astype(np.uint8))
    full = depth_to_space(planes, f)[:, 0]
    assert full.dtype == torch.uint8 and full.shape == (3, 5 * f, 7 * f)
    assert full.is_contiguous()
    for k, (hs, ws) in enumerate([(5 * f, 7 * f), (5 * f - 1, 7 * f - 3),
                                  (3, 1)]):
        np.testing.assert_array_equal(
            full[k, :hs, :ws].numpy(),
            JaxEngine._interleave4(planes[k].numpy(), hs, ws))


def test_whole_slice_matches_jax_engine(cfg, slide, flax_pair, engine):
    """The port (bf16, plain stem on the CPU) against the JAX fast path
    (bf16, Pallas stem in interpret mode) on the same slide and weights.
    Measured: labels agree on 99.91 %, heat |Δ| ≤ 1/255 everywhere."""
    jax_eng = JaxEngine(flax_pair[0], flax_pair[1], cfg)
    jax_eng.fcn_fast_interpret = True
    jres = jax_eng.predict_slide_fcn(jax_plan_slide("syn", slide, cfg))
    plan = plan_slide("syn", slide, cfg)
    assert len(plan.grid) == len(jax_plan_slide("syn", slide, cfg).grid)
    res = engine.predict_slide_fcn(plan)
    assert res.labels.shape == res.heatmap.shape == plan.canvas_hw
    agree = (res.labels == jres.labels).mean()
    assert agree >= 0.998, agree
    assert np.abs(res.heatmap - jres.heatmap).max() <= 2 / 255 + 1e-6


@pytest.fixture(scope="module")
def fold_engine(cfg, engine):
    eng = DenseInferenceEngine(engine.model, cfg, device="cpu")
    eng.fcn_fold = True
    return eng


def test_fold_route_matches_jax_engine(cfg, slide, flax_pair, fold_engine):
    """The fold route (plain stem_conv and conv9 versions on the CPU)
    against the JAX engine's fold route (Pallas stem_conv and conv9 in
    interpret mode) on the same slide and weights. Measured: labels agree
    on 99.93 %, heat |Δ| ≤ 1/255 everywhere."""
    jax_eng = JaxEngine(flax_pair[0], flax_pair[1], cfg)
    jax_eng.fcn_fast_interpret = True
    jax_eng.fcn_fold = True
    jres = jax_eng.predict_slide_fcn(jax_plan_slide("syn", slide, cfg))
    res = fold_engine.predict_slide_fcn(plan_slide("syn", slide, cfg))
    assert fold_engine.fast.fold is not None
    assert res.labels.shape == res.heatmap.shape == (192, 256)
    assert (res.labels == jres.labels).mean() >= 0.99
    heat_ok = np.abs(res.heatmap - jres.heatmap) <= 2 / 255 + 1e-6
    assert heat_ok.mean() >= 0.99


def test_fold_route_head_and_throughput(cfg, slide, fold_engine):
    """The fold head is s2d(2): the tissue mask is taken at half
    resolution, the labels and heat leave the route at full resolution,
    and device_throughput runs the fold route too."""
    plan = plan_slide("syn", slide, cfg)
    imgs, masks = fold_engine._inputs([plan])
    assert masks.shape == (1, 96, 128)
    labels, heat = fold_engine._run_fused(imgs, masks)
    assert labels.shape == heat.shape == (1, 192, 256)
    assert labels.dtype == heat.dtype == torch.uint8
    tp = fold_engine.device_throughput(plan, iters=1, slides_in_flight=2)
    assert tp["sec_per_slide"] > 0


def test_group_equals_per_slide(cfg, engine):
    slides = [SyntheticSlide(width=4096, height=3072, num_levels=3, seed=s)
              for s in (21, 22)]
    plans = [plan_slide(f"s{k}", s, cfg) for k, s in enumerate(slides)]
    group = engine.predict_slides_fcn(plans)
    for p, g in zip(plans, group):
        one = engine.predict_slide_fcn(p)
        assert g.name == one.name == p.name
        np.testing.assert_array_equal(g.labels, one.labels)
        np.testing.assert_array_equal(g.heatmap, one.heatmap)


@pytest.fixture(scope="module")
def fpn_engine(cfg):
    c = cfg.replace(model_name="FPN", arch_encoder="resnet18")
    return DenseInferenceEngine(
        init_ynet(c, torch.Generator().manual_seed(0)), c, device="cpu")


def _kept_bytes(a: np.ndarray) -> int:
    """Bytes of the block of memory that ``a`` keeps alive."""
    b = a.base
    if isinstance(b, torch.Tensor):
        return b.untyped_storage().nbytes()
    return a.nbytes if b is None else b.nbytes


#: engine fixture and each slide's level-0 (width, height); "crop" gives
#: two stitch sizes under one padded geometry (150×200 and 140×144 in
#: 160×256)
SERVED_GROUPS = {
    "unet": ("engine", [(4096, 3072), (4096, 3072)]),
    "fold": ("fold_engine", [(4096, 3072), (4096, 3072)]),
    "fpn": ("fpn_engine", [(4096, 3072), (4096, 3072)]),
    "crop": ("engine", [(3200, 2400), (2304, 2240)]),
}


@pytest.mark.parametrize("case", sorted(SERVED_GROUPS))
def test_serve_equals_host_interleave(request, case):
    """A group through ``_serve`` (depth-to-space on the device, each
    slide's crop copied, the heat to f32 in one pass) against the JAX
    engine's host path on the same planes (``_postprocess_s2d`` of the
    forward's head planes): ``_interleave4`` of each slide's planes, then
    ``astype(np.float32) / 255.0``. Bit for bit, and each slide's arrays
    C-contiguous, holding only their own memory."""
    fixture, sizes = SERVED_GROUPS[case]
    eng = request.getfixturevalue(fixture)
    plans = [plan_slide(f"s{k}", SyntheticSlide(width=w, height=h,
                                                num_levels=3, seed=50 + k),
                        eng.cfg) for k, (w, h) in enumerate(sizes)]
    if case == "crop":
        assert len({p.stitch_hw for p in plans}) == 2
        assert all(eng._fcn_fast_dims(*p.stitch_hw) == (160, 256)
                   for p in plans)
    with torch.no_grad():
        batch, masks = eng._inputs(plans)
        labels_p, heat_p = eng._postprocess_s2d(eng._forward(batch), masks)
        got = eng._serve(plans)
    assert labels_p.shape[1] == (4 if case == "fold" else 16)
    arrays = []
    for k, (p, res) in enumerate(zip(plans, got)):
        hs, ws = p.stitch_hw
        lab = JaxEngine._interleave4(labels_p[k].numpy(), hs, ws)
        heat = JaxEngine._interleave4(heat_p[k].numpy(), hs,
                                      ws).astype(np.float32) / 255.0
        assert res.name == p.name
        assert res.labels.dtype == np.uint8 and res.labels.shape == (hs, ws)
        assert res.heatmap.dtype == np.float32
        assert res.heatmap.shape == (hs, ws)
        assert np.array_equal(res.labels, lab)
        assert np.array_equal(res.heatmap, heat)
        for a in (res.labels, res.heatmap):
            assert a.flags.c_contiguous and _kept_bytes(a) == a.nbytes
            arrays.append(a)
    assert not any(np.shares_memory(a, b) for i, a in enumerate(arrays)
                   for b in arrays[i + 1:])


def test_pipelined_groups_keep_pairing(cfg, engine):
    slides = [(f"s{k}", SyntheticSlide(width=2048, height=1536,
                                       num_levels=3, seed=30 + k))
              for k in range(3)]
    coll = SlideCollection(slides, cfg)
    engine.slides_in_flight = 2
    try:
        out = list(_pipelined_results(engine, coll, fcn=True))
    finally:
        engine.slides_in_flight = 1
    assert [name for name, _, _ in out] == ["s0", "s1", "s2"]
    for name, plan, res in out:
        assert res.name == name
        np.testing.assert_array_equal(
            res.labels, engine.predict_slide_fcn(plan).labels)


def test_cli_eval_tumorbed_writes_heatmap(tmp_path):
    l0 = SyntheticSlide(width=2048, height=1536, num_levels=1,
                        seed=3).read_level(0)
    slides = tmp_path / "slides"
    slides.mkdir()
    np.save(slides / "a.npy", l0)
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "wsiseg_tpu_torch", "eval-tumorbed",
         "--raw_val_pth", str(slides), "--eval_model_pth",
         str(tmp_path / "none"), "--val_save_pth", str(out),
         "--wsi_mask_pth", "", "--tile_w", "64", "--tile_h", "64",
         "--tile_stride_w", "32", "--tile_stride_h", "32", "--device",
         "cpu"], capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    hm = np.asarray(Image.open(out / "0" / "a.npy_32_heatmap.png"))
    assert hm.shape == (96, 128)
    ov = np.asarray(Image.open(out / "0" / "a.npy_32_overlay.png"))
    assert ov.shape == (96, 128, 3)


def test_unported_command_points_at_roadmap():
    """Every command of the JAX package is ported; a name neither package
    has is refused with a pointer to what ROADMAP.md lists."""
    from wsiseg_tpu_torch.__main__ import main
    with pytest.raises(SystemExit, match="ROADMAP"):
        main(["no-such-command"])


def test_writers_match_jax(cfg, tmp_path):
    """Heatmap and overlay PNGs decode to the JAX writers' pixels."""
    from wsiseg_tpu.infer import writers as jax_writers
    r = np.random.RandomState(2)
    heat = r.rand(6, 10).astype(np.float32)
    heat[0, :3] = (0.995, 1.2, -0.1)
    rgb = r.randint(0, 256, (6, 10, 3)).astype(np.uint8)
    outs = []
    for k, mod in enumerate((writers, jax_writers)):
        c = cfg.replace(val_save_pth=str(tmp_path / str(k)))
        outs.append([np.asarray(Image.open(p)) for p in (
            mod.save_heatmap(c, 0, "s", heat),
            mod.save_overlay(c, 0, "s", rgb, heat))])
    got, ref = outs
    assert got[0].shape == (6, 10) and got[1].shape == (6, 10, 3)
    for g, rf in zip(got, ref):
        np.testing.assert_array_equal(g, rf)


def test_cuda_engine_raises_without_cuda(cfg):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        DenseInferenceEngine(init_ynet(cfg, torch.Generator()), cfg,
                             device="cuda")


def test_engine_defaults_to_cuda(cfg):
    """An engine built without a device runs on the card: without one it
    raises, it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cpu"):
        DenseInferenceEngine(init_ynet(cfg, torch.Generator()), cfg)


def test_cli_defaults_to_cuda(tmp_path):
    """eval-tumorbed without --device runs on the card: without one it
    raises before it reads a slide."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from wsiseg_tpu_torch.__main__ import main
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["eval-tumorbed", "--raw_val_pth", str(tmp_path),
              "--eval_model_pth", str(tmp_path / "none"),
              "--val_save_pth", str(tmp_path / "out"), "--wsi_mask_pth",
              ""])


@pytest.mark.parametrize("what", ["sharded"])
def test_unported_routes_raise(cfg, what, monkeypatch):
    """``--sharded --mesh 2x2`` once raised for want of spatial training;
    now, as in JAX (whose ``make_eval_mesh`` ignores ``--mesh``'s shape),
    it serves over its 2·2 ranks on the one-dim data mesh: the CLI asks
    for four ranks (the spawn is stood in for here). (The sharded routes:
    tests/test_torch_sharded_inference.py.)"""
    from wsiseg_tpu_torch.cli import eval_tumorbed
    asked = []
    monkeypatch.setattr(eval_tumorbed, "spawn_ranks",
                        lambda n, on, fn, **kw: asked.append(
                            (n, kw["sharded"])) or {})
    assert eval_tumorbed.main(["--sharded", "--mesh", "2x2", "--device",
                               "cpu", "--raw_val_pth", "/nonexistent"]) == {}
    assert asked == [(4, True)]


def test_engine_decides_through_the_model_and_its_own_api():
    """The engine asks the model's prepared weights what it needs of a
    family (no ``is_mit``, no ``NATIVE_DECODERS``), and the evaluators
    call only the engine's public methods (no underscore attribute of an
    engine or of ``DenseInferenceEngine``)."""
    pkg = os.path.join(REPO, "wsiseg_tpu_torch", "infer")
    names = {n.id if isinstance(n, ast.Name) else n.name
             for n in ast.walk(ast.parse(open(os.path.join(
                 pkg, "engine.py")).read()))
             if isinstance(n, (ast.Name, ast.alias))}
    assert not names & {"is_mit", "NATIVE_DECODERS"}, names
    tree = ast.parse(open(os.path.join(pkg, "evaluators.py")).read())
    private = [(n.value.id, n.attr, n.lineno) for n in ast.walk(tree)
               if isinstance(n, ast.Attribute) and n.attr.startswith("_")
               and isinstance(n.value, ast.Name)
               and n.value.id in ("engine", "DenseInferenceEngine")]
    assert not private, private


def test_port_imports_no_jax():
    """Importing every module of the port, chip_smoke and every module
    chip_smoke imports inside its phases loads nothing of the JAX package
    and no JAX library; nor does a rank that ``parallel.launch`` spawns."""
    code = (
        "import ast, importlib, pkgutil, sys\n"
        "import wsiseg_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'wsiseg_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "tree = ast.parse(open(chip_smoke.__file__).read())\n"
        "for n in ast.walk(tree):\n"
        "    if isinstance(n, ast.ImportFrom) and n.module:\n"
        "        importlib.import_module(n.module)\n"
        "    elif isinstance(n, ast.Import):\n"
        "        for a in n.names:\n"
        "            importlib.import_module(a.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('wsiseg_tpu', 'jax', 'jaxlib', 'flax', 'optax')]\n"
        "assert not bad, bad\n"
        "import os\n"
        "sys.path.insert(0, os.path.abspath('tests'))\n"
        "import torch_rank_cases\n"
        "from wsiseg_tpu_torch.parallel import launch\n"
        "roots = launch.run_ranks(torch_rank_cases.loaded_roots, 2, 'cpu', "
        "threads=1)\n"
        "assert 'wsiseg_tpu_torch' in roots, roots\n"
        "bad = [k for k in roots if k in "
        "('wsiseg_tpu', 'jax', 'jaxlib', 'flax', 'optax')]\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules "
        "if k.startswith('wsiseg_tpu_torch')]))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=300,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")
    assert int(r.stdout.split()[1]) >= 20
