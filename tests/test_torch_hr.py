"""The port's HR region-ensemble path against the JAX package's, on the
CPU: ``models.ensemble.MultiPatchResNet`` through
``flax_import.ensemble_from_flax`` (f32 forward; the bf16 compute copy),
the HR datasets and ``cls_ratios_hr`` (identical batches; the plain
patches' k-means seeds replaced by JAX's, as in
tests/test_torch_proposals.py), ``validate_hr``, ``make_preprocess`` on
(B, P, H, W, 3) batches, one float64 sgd HR step with class weights
(``grad_accum`` 1 and 2; the momentum carried by
``optimizer_state_from_flax``), the flax checkpoint converter, and the
``train-hr``, ``slic`` and ``scannet`` CLIs with ``--device cpu`` (each
raises without a card when the device is not given).

The JAX ensemble runs at 4 patches of 32² (64² for grad accumulation, so
that each microbatch's deepest BatchNorm sees 4·4 values per channel),
batch 2; the datasets and CLIs at the reference's 16 patches of 64²."""

import contextlib
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_proposals import jax_seeds
from test_torch_train_step import jax_f64
from wsiseg_tpu.config import default_config as jax_config
from wsiseg_tpu.data import metadata as jmd
from wsiseg_tpu.data import regions as jreg
from wsiseg_tpu.models import ensemble as jax_ensemble
from wsiseg_tpu_torch.__main__ import main
from wsiseg_tpu_torch.config import default_config
from wsiseg_tpu_torch.data import regions as treg
from wsiseg_tpu_torch.data.bench_slide import level2_image
from wsiseg_tpu_torch.models import ensemble
from wsiseg_tpu_torch.models.ensemble import (MultiPatchResNet,
                                              compute_copy)
from wsiseg_tpu_torch.models.flax_import import (ensemble_from_flax,
                                                 optimizer_state_from_flax)
from wsiseg_tpu_torch.ops import kmeans as tkm

torch.set_num_threads(2)

REL = 1e-9                       # × max(1, |ref|), float64 both sides
CW = np.array([0.3, 1.0, 0.6, 0.8])


@pytest.fixture(scope="module", autouse=True)
def shared_ensemble_init():
    """``init_ensemble`` of one (arch, classes, generator state) once for
    the module, a deep copy for each caller: ``lecun_init`` of ``fc_1``'s
    33.5 M weights takes ~5 s, and ``setup_hr``, ``restore_for_eval`` and
    the CLIs here all draw the same weights from a fresh generator of the
    same seed. The copies are the weights a fresh draw gives."""
    real, cache = ensemble.init_ensemble, {}

    def init(cfg, generator):
        key = (cfg.arch_encoder, cfg.num_classes,
               bytes(generator.get_state().numpy()))
        if key not in cache:
            cache[key] = real(cfg, generator)
        return copy.deepcopy(cache[key])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ensemble, "init_ensemble", init)
        yield


@contextlib.contextmanager
def hr_f64():
    """``jax_f64`` with the ensemble's output casts read as float64 too."""
    from wsiseg_tpu import losses as jax_losses
    with jax_f64():
        jax_ensemble.jnp = jax_losses.jnp
        try:
            yield
        finally:
            jax_ensemble.jnp = jnp


def flax_variables(model, shape, seed=0, dtype=np.float32):
    """The flax init's tree (``jax.eval_shape``, nothing compiled) filled
    from ``np.random.RandomState(seed)``."""
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros(shape)),
                            jax.random.PRNGKey(0))
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
        return np.asarray(v, dtype)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def flax_hr_model(jcfg, cfg, num_patches=4, hw=64, seed=0,
                  dtype=jnp.float32):
    """(flax model, its random variables, the port's model carrying
    them)."""
    jmodel = jax_ensemble.MultiPatchResNet(
        arch=jcfg.arch_encoder, num_classes=jcfg.num_classes,
        num_patches=num_patches, dtype=dtype,
        param_dtype=jnp.float64 if dtype == jnp.float64 else jnp.float32,
        norm_dtype=jnp.float32 if dtype == jnp.bfloat16 else dtype)
    variables = flax_variables(
        jmodel, (1, num_patches, hw, hw, 3), seed,
        np.float64 if dtype == jnp.float64 else np.float32)
    model = MultiPatchResNet(cfg.arch_encoder, cfg.num_classes, num_patches)
    if dtype == jnp.float64:
        model = model.double()
    model.load_state_dict(ensemble_from_flax(variables))
    return jmodel, variables, model.eval()


@pytest.fixture(scope="module")
def f32_pair():
    return flax_hr_model(jax_config(), default_config(), hw=32)


def _patches(seed=1, b=2, p=4, hw=32):
    return np.random.RandomState(seed).randn(b, p, hw, hw, 3).astype(
        np.float32)


def test_ensemble_matches_flax(f32_pair):
    jmodel, variables, model = f32_pair
    x = _patches()
    ref = jmodel.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.dtype == torch.float32 and g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(r).max()))
    with pytest.raises(ValueError, match="expected 4 patches"):
        model(torch.zeros(1, 3, 32, 32, 3))


def test_compute_copy_rounds_as_flax_bf16():
    """The bf16 compute copy against the flax model applied in bf16 (BN
    output f32, as ``setup_hr`` builds it) on the same weights: within
    2^-5·max(1, |ref|), four bf16 ulps at magnitude 1."""
    jcfg, cfg = jax_config(), default_config()
    jmodel, variables, model = flax_hr_model(jcfg, cfg, hw=32,
                                             dtype=jnp.bfloat16)
    x = _patches(2)
    ref = jmodel.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = compute_copy(model, torch.bfloat16)(torch.from_numpy(x))
    for g, r in zip(got, ref):
        r = np.asarray(r, np.float32)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=2.0 ** -5 * max(1.0, np.abs(r).max()))


def test_make_preprocess_takes_patch_batches():
    from wsiseg_tpu.cli.common import make_preprocess as jax_preprocess
    from wsiseg_tpu_torch.cli.common import make_preprocess
    u8 = np.random.RandomState(3).randint(0, 256, (2, 3, 8, 8, 3)).astype(
        np.uint8)
    ref = jax_preprocess(jax_config(), train=False)(
        {"image": jnp.asarray(u8)}, jax.random.PRNGKey(0))["image"]
    got = make_preprocess(default_config(), train=False)(
        {"image": torch.from_numpy(u8)})["image"]
    assert got.shape == (2, 3, 8, 8, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    g = torch.Generator().manual_seed(0)
    jit = make_preprocess(default_config())({"image": torch.from_numpy(u8)},
                          g)["image"]
    assert jit.shape == (2, 3, 8, 8, 3) and not torch.equal(jit, got)


# ---------- datasets ----------

@pytest.fixture(scope="module")
def hr_store(tmp_path_factory):
    """One ``.npy`` slide region and one plain 'P' photo, the JAX tests'
    store (tests/test_regions_ssr.py)."""
    root = tmp_path_factory.mktemp("hr_store")
    rng = np.random.RandomState(0)
    level0 = np.full((4096, 4096, 3), 240, np.uint8)
    level0[512:3584, 512:3584] = rng.randint(60, 200, (3072, 3072, 3))
    slide_pth = str(root / "slide.npy")
    np.save(slide_pth, level0)
    cnt = np.stack([np.linspace(60, 200, 8), np.linspace(70, 190, 8)],
                   1).astype(np.int64)
    perim = np.stack([np.linspace(40, 216, 24),
                      np.linspace(40, 216, 24)], axis=1).astype(np.int64)
    photo_pth = str(root / "photo.png")
    Image.fromarray(rng.randint(0, 255, (1536, 2048, 3), np.uint8)).save(
        photo_pth)
    store = {
        "P": {0: {0: {"cnt_xy": None, "perim_xy": None, "label": 1,
                      "wsipath": photo_pth, "scan_level": None,
                      "dimensions": (2048, 1536)}}},
        "slide.npy": {1: {0: {"cnt_xy": cnt, "perim_xy": perim, "label": 2,
                              "wsipath": slide_pth, "scan_level": 2}}},
    }
    jmd.save_store(store, str(root))
    return str(root)


@pytest.fixture
def jax_seeded(monkeypatch):
    monkeypatch.setattr(tkm, "plusplus_init", jax_seeds("pow2"))


@pytest.mark.parametrize("eval_mode", [False, True])
def test_hr_datasets_match_jax(jax_seeded, hr_store, eval_mode):
    jcfg = jax_config(batch_size=1)
    cfg = default_config(batch_size=1)
    ref = jreg.HRRegionDataset(hr_store, jcfg, eval=eval_mode,
                               duplicate_dataset=2, seed=3)
    got = treg.HRRegionDataset(hr_store, cfg, eval=eval_mode,
                               duplicate_dataset=2, seed=3, device="cpu")
    assert len(got) == len(ref) == (2 if eval_mode else 4)
    np.testing.assert_array_equal(got.cls_ratios, ref.cls_ratios)
    for _ in range(2):          # two epochs: the generator runs on
        for g, r in zip(got.batches(), ref.batches()):
            assert g.keys() == r.keys()
            for k in r:
                np.testing.assert_array_equal(g[k], r[k])


def test_hr_batches_keep_rank_rows(hr_store):
    from test_torch_train_data import assert_rank_rows
    cfg = default_config(batch_size=4)
    assert_rank_rows(*(treg.HRRegionDataset(hr_store, cfg,
                                            duplicate_dataset=2, seed=3,
                                            device="cpu")
                       for _ in range(2)))


def test_hr_eval_dataset_and_cls_ratios_match_jax(jax_seeded, hr_store):
    from wsiseg_tpu.data.ssr import cls_ratios_hr as jax_ratios
    from wsiseg_tpu_torch.data.ssr import cls_ratios_hr

    region = jmd.load_store(hr_store)["slide.npy"][1][0]
    meta = {0: {**region, "tile_id": 7}, 1: {**region, "tile_id": 9}}
    ref = next(jreg.HRRegionEvalDataset(meta, jax_config()).batches())
    got = next(treg.HRRegionEvalDataset(meta, default_config()).batches())
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    for ig in (None, 1):
        np.testing.assert_array_equal(
            cls_ratios_hr(hr_store, default_config(), ig, device="cpu"),
            jax_ratios(hr_store, jax_config(), ig))


def _ssr_cls_store(root):
    """Five 48×40 regions with labels 0-3 in a gt.npy store."""
    rng = np.random.RandomState(0)
    store = {}
    for i in range(5):
        pth = str(root / f"r{i}.png")
        Image.fromarray(rng.randint(0, 255, (48, 40, 3), np.uint8)).save(pth)
        store[f"s{i}"] = {0: {"image": pth, "label": i % 4, "times": 1}}
    jmd.save_store(store, str(root))


def test_ssr_cls_dataset_matches_jax(tmp_path):
    from wsiseg_tpu.data.ssr import SSRClsDataset as JaxSSRCls
    from wsiseg_tpu_torch.data.ssr import SSRClsDataset
    _ssr_cls_store(tmp_path)
    for ev in (False, True):
        kw = dict(batch_size=3, tile_w=32, tile_h=32)
        ref = JaxSSRCls(str(tmp_path), jax_config(**kw), eval=ev, seed=2)
        got = SSRClsDataset(str(tmp_path), default_config(**kw), eval=ev,
                            seed=2)
        assert len(got) == len(ref)
        for g, r in zip(got.batches(), ref.batches()):
            for k in r:
                np.testing.assert_array_equal(g[k], r[k])


def test_ssr_cls_batches_keep_rank_rows(tmp_path):
    from test_torch_train_data import assert_rank_rows
    from wsiseg_tpu_torch.data.ssr import SSRClsDataset
    _ssr_cls_store(tmp_path)
    assert_rank_rows(*(SSRClsDataset(str(tmp_path), default_config(
        batch_size=3, tile_w=32, tile_h=32), seed=2) for _ in range(2)))


def test_validate_hr_matches_jax(jax_seeded, hr_store):
    """``validate_hr`` on the same f32 weights: the JAX forward (the
    trainer's) and the port's ``make_hr_apply`` give the same accuracy and
    confusion matrix."""
    from wsiseg_tpu.data.patches import normalize_batch_images
    from wsiseg_tpu_torch.cli.common import make_hr_apply

    jcfg = jax_config(compute_dtype="float32", batch_size=2)
    cfg = default_config(compute_dtype="float32", batch_size=2)
    jmodel, variables, model = flax_hr_model(jcfg, cfg, num_patches=16,
                                             seed=4)

    @jax.jit
    def forward(images_u8):
        x = jnp.asarray(images_u8)
        b, p = x.shape[:2]
        f = normalize_batch_images(x.reshape(b * p, *x.shape[2:]), jcfg)
        return jmodel.apply(variables, f.reshape(b, p, *f.shape[1:]))

    ref = jreg.validate_hr(forward, jreg.HRRegionDataset(
        hr_store, jcfg, eval=True), jcfg)
    got = treg.validate_hr(make_hr_apply(model, cfg, device="cpu"),
                           treg.HRRegionDataset(hr_store, cfg, eval=True,
                                                device="cpu"), cfg)
    assert got.keys() == ref.keys()
    for k in ref:               # classwise_acc is NaN for absent classes
        np.testing.assert_equal(got[k], ref[k])


# ---------- the HR train step ----------

_STEPS = {}


def hr_step_pair(grad_accum):
    """One JAX and one port float64 sgd HR step (class weights CW) from
    the same variables and batch; JAX's new state as a port state_dict,
    its optimizer state, and the port's step."""
    if grad_accum in _STEPS:
        return _STEPS[grad_accum]
    from wsiseg_tpu.optim import build_optimizer as jax_optimizer
    from wsiseg_tpu.train import steps as jax_steps
    from wsiseg_tpu.train.state import TrainState as JaxTrainState
    from wsiseg_tpu_torch.optim import build_optimizer
    from wsiseg_tpu_torch.train.state import TrainState
    from wsiseg_tpu_torch.train.steps import make_hr_train_step

    hw = 32 * grad_accum
    kw = dict(compute_dtype="float64", param_dtype="float64", optim="sgd",
              lr=1e-2, weight_decay=1e-4, batch_size=2)
    jcfg, cfg = jax_config(norm_dtype="float64", **kw), default_config(**kw)
    r = np.random.RandomState(5)
    batch = {"image": r.randn(2, 4, hw, hw, 3),
             "cls_label": np.array([2, 1], np.int32)}
    with hr_f64():
        jmodel, variables, model = flax_hr_model(jcfg, cfg, hw=hw,
                                                 dtype=jnp.float64)
        tx = jax_optimizer(jcfg)
        make = jax_steps.make_hr_train_step(
            jmodel, tx, jcfg, class_weights=jnp.asarray(CW),
            grad_accum=grad_accum)
        new, jm = jax.jit(make)(JaxTrainState.create(variables, tx), batch,
                                jax.random.PRNGKey(0))
        new_vars = jax.device_get(new.variables())
        jm = {k: float(v) for k, v in jm.items()}
        opt_state = jax.device_get(new.opt_state)
    state = TrainState(model.train(),
                       build_optimizer(cfg, model.parameters()))
    tm = make_hr_train_step(model, cfg, class_weights=CW,
                            grad_accum=grad_accum)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    _STEPS[grad_accum] = (jm, ensemble_from_flax(new_vars), new_vars,
                          opt_state, {k: float(v) for k, v in tm.items()},
                          state)
    return _STEPS[grad_accum]


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_hr_step_matches_jax(grad_accum):
    jm, ref_sd, _, _, tm, state = hr_step_pair(grad_accum)
    assert set(jm) == set(tm) == {"loss", "acc"}
    for k in jm:
        assert abs(tm[k] - jm[k]) <= REL * max(1.0, abs(jm[k])), (k, tm, jm)
    got = state.model.state_dict()
    assert state.step == 1
    for k, ref in ref_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        scale = ref.double().abs().clamp(min=1.0)
        d = ((got[k].double() - ref.double()).abs() / scale).max().item()
        assert d <= REL, (k, d)


def test_hr_optimizer_state_carries_from_jax():
    """JAX's sgd trace after the HR step, through
    ``optimizer_state_from_flax``, equals the port's momentum buffers."""
    from wsiseg_tpu_torch.optim import build_optimizer
    _, _, new_vars, opt_state, _, state = hr_step_pair(1)
    model = MultiPatchResNet(num_patches=4).double()
    model.load_state_dict(ensemble_from_flax(new_vars))
    opt = build_optimizer(default_config(optim="sgd", lr=1e-2),
                          model.parameters())
    opt.load_state_dict(optimizer_state_from_flax(opt_state, new_vars,
                                                  model, opt))
    mine = state.optimizer.state_dict()["state"]
    carried = opt.state_dict()["state"]
    assert sorted(carried) == sorted(mine)
    for i in mine:
        torch.testing.assert_close(carried[i]["momentum_buffer"],
                                   mine[i]["momentum_buffer"], rtol=REL,
                                   atol=REL)


# ---------- checkpoints, pretrained trunk, CLIs ----------

def test_convert_flax_hr_checkpoint(tmp_path):
    """scripts/convert_flax_checkpoint.py converts a JAX HR checkpoint (a
    ``trunk`` in its params) and ``restore_for_eval(cfg, setup=setup_hr)``
    restores it with the same weights and epoch."""
    import importlib.util

    from wsiseg_tpu.optim import build_optimizer as jax_optimizer
    from wsiseg_tpu.train.state import TrainState as JaxTrainState
    from wsiseg_tpu.train.state import save_checkpoint as flax_save
    from wsiseg_tpu_torch.cli.common import restore_for_eval, setup_hr

    jcfg = jax_config(model_save_pth=str(tmp_path / "jax"), optim="sgd")
    jmodel = jax_ensemble.MultiPatchResNet(num_patches=16)
    state = JaxTrainState.create(
        flax_variables(jmodel, (1, 16, 64, 64, 3), seed=6),
        jax_optimizer(jcfg))
    src = flax_save(state, jcfg, 4)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "convert_flax_checkpoint",
        os.path.join(repo, "scripts", "convert_flax_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main([src, str(tmp_path / "pt")])
    assert out.endswith("model_resnet18_4.pt")
    model, epoch = restore_for_eval(
        default_config(eval_model_pth=str(tmp_path / "pt")),
        setup=setup_hr)
    assert epoch == 4 and isinstance(model, MultiPatchResNet)
    for name, leaf in (("fc_1", "kernel"), ("fc0", "kernel")):
        np.testing.assert_array_equal(
            getattr(model, name).weight.detach().numpy(),
            np.asarray(state.params[name][leaf]).T)
    np.testing.assert_array_equal(
        model.trunk.layer4[1].bn2.running_var.numpy(),
        np.asarray(state.batch_stats["trunk"]["layer4_1"]["bn2"]["var"]))


def test_setup_hr_grafts_pretrained_trunk(tmp_path):
    """``--pretrained_pth`` with torchvision names loads into ``trunk``
    only; the dense heads keep their random init."""
    from wsiseg_tpu_torch.cli.common import setup_hr
    from wsiseg_tpu_torch.models.resnet import ResNetEncoder
    src = ResNetEncoder("resnet18")
    with torch.no_grad():
        for p in src.parameters():
            p.uniform_(-1, 1)
    sd = {k: v for k, v in src.state_dict().items()}
    sd["fc.weight"] = torch.zeros(1000, 512)
    pth = str(tmp_path / "r18.pth")
    torch.save(sd, pth)
    fresh, _ = setup_hr(default_config(), device="cpu")
    state, _ = setup_hr(default_config(pretrained_pth=pth), device="cpu")
    got = state.model.state_dict()
    for k, v in src.state_dict().items():
        assert torch.equal(got["trunk." + k], v), k
    for k in ("fc0.weight", "fc_1.weight", "fc_2.bias"):
        assert torch.equal(got[k], fresh.model.state_dict()[k]), k


def _hr_argv(store, out, *extra):
    return ["train-hr", "--device", "cpu", "--train_hr_image_pth", store,
            "--val_hr_image_pth", store, "--batch_size", "2",
            "--save_models", "1", "--validate_model", "2",
            "--model_save_pth", str(out),
            "--train_model_pth", os.path.join(str(out), "*"),
            "--compute_dtype", "float32", *extra]


def test_train_hr_cli_trains_validates_and_resumes(hr_store, tmp_path):
    first = main(_hr_argv(hr_store, tmp_path, "--num_epoch", "2"))
    again = main(_hr_argv(hr_store, tmp_path, "--num_epoch", "3",
                          "--continue_train", "true"))
    hist = first.history + again.history
    assert [r["epoch"] for r in hist] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in hist)
    assert [("val_acc" in r) for r in hist] == [False, True, False]
    assert 0.0 <= hist[1]["val_acc"] <= 1.0
    assert again.state.step == 3 * first.state.step // 2 == 3
    assert (tmp_path / "model_resnet18_3.pt").exists()


@pytest.fixture(scope="module")
def demo_slide(tmp_path_factory):
    """A 4096² ``.npy`` slide (a 256² level-2 image repeated 16× per
    axis) with a GT thumbnail of two 72² regions: at this level-2 size a
    connected component yields proposals with 8 keypoints only when its
    bounding box exceeds 5 % of the image and its area stays under ~9000
    px (the k-means split of ``cc_proposals``)."""
    root = tmp_path_factory.mktemp("demo")
    l2 = level2_image(256, 256, seed=8)
    pth = str(root / "slide.npy")
    np.save(pth, np.repeat(np.repeat(l2, 16, 0), 16, 1))
    gt = np.zeros((256, 256), np.uint8)
    gt[30:102, 40:112] = 2
    gt[150:222, 130:202] = 1
    Image.fromarray(gt).save(str(root / "gt.png"))
    return pth, str(root / "gt.png")


@pytest.fixture(scope="module")
def demo_checkpoint(tmp_path_factory):
    """An HR checkpoint of random weights, the ensemble's output bias
    moved to class 2 so that painted proposals show."""
    from wsiseg_tpu_torch.train.state import save_checkpoint
    root = str(tmp_path_factory.mktemp("demo_ck"))
    model = ensemble.init_ensemble(default_config(),
                                   torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.fc_2.bias[2] += 30.0
    save_checkpoint(model, root, "resnet18", 0)
    return root


@pytest.mark.parametrize("cmd", ["slic", "scannet"])
def test_demo_clis_paint_on_cpu(demo_slide, demo_checkpoint, tmp_path,
                                monkeypatch, cmd):
    """Each demo restores the HR checkpoint and writes both PNGs; the
    painted classes are in range."""
    pth, gt = demo_slide
    monkeypatch.chdir(tmp_path)
    extra = (["--gt_thumbnail", gt] if cmd == "scannet"
             else ["--num_segments", "12"])
    mask = main([cmd, pth, "--eval_model_pth", demo_checkpoint,
                 "--device", "cpu"] + extra)
    prefix = {"slic": "slic_out", "scannet": "scannet_out"}[cmd]
    assert mask.shape == (256, 256)
    assert mask.min() >= 0 and mask.max() < 4 and (mask == 2).mean() > 0.05
    png = np.asarray(Image.open(tmp_path / f"{prefix}_mask.png"))
    assert png.shape == (64, 64, 3)
    assert np.asarray(Image.open(tmp_path / f"{prefix}.png")).shape == \
        (256, 256, 3)


@pytest.mark.parametrize("cmd", ["slic", "scannet", "train-hr"])
def test_hr_clis_need_a_card_by_default(cmd, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = {"slic": ["slic", "x.npy"],
            "scannet": ["scannet", "x.npy", "--gt_thumbnail", "gt.png"],
            "train-hr": ["train-hr", "--train_hr_image_pth",
                         str(tmp_path)]}[cmd]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(args)
