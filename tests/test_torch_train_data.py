"""The port's training data, cache, checkpoints and pretrained grafting
against the JAX package on seeded inputs:

* ``PatchDataset`` batches (shuffles, rotations, resizes, task rows) are
  identical to JAX's for the same seed over two epochs, ``cls_weights``
  too, and so are ``SSRSegDataset``'s batches and ``cls_ratios_ssr``;
* ``DeviceEpochCache`` on the CPU gives JAX's index batches, and the
  cached step given a host batch's rows equals the host-fed step on it
  (same generator for the jitter);
* checkpoints save, restore and resume with the optimizer state (start
  epoch + 1, the step count, the next step equal); an eval checkpoint
  without ``"optimizer"`` still restores;
* grafting a torchvision-named resnet18 state_dict (seeded, no download)
  or a whole reference checkpoint through the port equals JAX's
  ``apply_pretrained`` followed by ``from_flax``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from wsiseg_tpu.config import default_config as jax_config
from wsiseg_tpu.data import patches as jpatches
from wsiseg_tpu.data import ssr as jssr
from wsiseg_tpu.models.torch_import import apply_pretrained as jax_graft
from wsiseg_tpu.models.ynet import build_ynet as jax_build_ynet
from wsiseg_tpu.train.device_cache import DeviceEpochCache as JaxCache
from wsiseg_tpu_torch.cli.common import make_preprocess
from wsiseg_tpu_torch.config import default_config
from wsiseg_tpu_torch.data import metadata as md
from wsiseg_tpu_torch.data import patches, ssr
from wsiseg_tpu_torch.models.flax_import import from_flax
from wsiseg_tpu_torch.models.torch_import import apply_pretrained
from wsiseg_tpu_torch.models.ynet import build_ynet, init_ynet
from wsiseg_tpu_torch.optim import build_optimizer
from wsiseg_tpu_torch.train.device_cache import DeviceEpochCache, \
    gather_batch, make_cached_hybrid_train_step
from wsiseg_tpu_torch.train.loop import step_generator
from wsiseg_tpu_torch.train.state import (TrainState, latest_checkpoint,
                                          load_checkpoint_config,
                                          restore_train_state,
                                          save_checkpoint, save_train_state)
from wsiseg_tpu_torch.train.steps import make_hybrid_train_step

torch.set_num_threads(2)

TILE = 32


def make_store(root, n=24, tile=TILE, seed=0, sizes=((40, 36), (32, 32))):
    """A gt.npy patch store of cls, seg (mask PNG) and reg rows, patches
    of a few sizes (rotations and resizes show)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    store = {}
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        img = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
        kind = i % 3
        if kind == 0:
            c = (i // 3) % 3 + 1
            img[..., c - 1] += 180
            label = int(c)
        elif kind == 1:
            mask = np.zeros((h, w), np.uint8)
            mask[: h // 2] = 1
            mask[: h // 4, : w // 3] = 2
            img[: h // 2, :, 0] += 160
            label = os.path.join(root, f"m{i}.png")
            Image.fromarray(mask).save(label)
        else:
            img = (img.astype(np.int32) + (i * 7) % 160).clip(0, 255) \
                .astype(np.uint8)
            label = float(img.mean() / 255.0)
        ipth = os.path.join(root, f"p{i}.png")
        Image.fromarray(img).save(ipth)
        md.add_patch(store, "synthetic", i, ipth, label)
    md.save_store(store, root)
    return root


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return make_store(str(tmp_path_factory.mktemp("store")))


def cfgs(**kw):
    kw = dict(tile_w=TILE, tile_h=TILE, batch_size=5, **kw)
    return jax_config(**kw), default_config(**kw)


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("drop", [False, True])
def test_patch_batches_equal_jax(store, drop):
    jcfg, tcfg = cfgs()
    jds = jpatches.PatchDataset(store, jcfg, seed=3, duplicate_dataset=2)
    tds = patches.PatchDataset(store, tcfg, seed=3, duplicate_dataset=2)
    assert len(tds) == len(jds) == 48
    for _ in range(2):                          # the generator carries on
        _assert_batches_equal(list(tds.batches(drop_remainder=drop)),
                              list(jds.batches(drop_remainder=drop)))
    ev_j = jpatches.PatchDataset(store, jcfg, eval=True)
    ev_t = patches.PatchDataset(store, tcfg, eval=True)
    _assert_batches_equal(list(ev_t.batches()), list(ev_j.batches()))


def assert_rank_rows(full_ds, part_ds, epochs=2, **kw):
    """``part_ds.batches(rows=odd rows, **kw)`` yields the odd rows of
    each of ``full_ds.batches(**kw)`` (two datasets built alike), epoch
    after epoch: a data-parallel rank decodes only its rows and draws
    every row's rotation, so its rows are the single device's."""
    def keep(b):
        return np.arange(b)[1::2]

    for _ in range(epochs):
        full = list(full_ds.batches(**kw))
        part = list(part_ds.batches(rows=keep, **kw))
        assert len(part) == len(full) > 0
        for p, f in zip(part, full):
            assert p.keys() == f.keys()
            for k in f:
                np.testing.assert_array_equal(p[k], f[k][keep(len(f[k]))],
                                              err_msg=k)


@pytest.mark.parametrize("drop", [False, True])
def test_patch_batches_keep_rank_rows(store, drop):
    _, tcfg = cfgs()
    assert_rank_rows(*(patches.PatchDataset(store, tcfg, seed=3,
                                            duplicate_dataset=2)
                       for _ in range(2)), drop_remainder=drop)


def test_cls_weights_equal_jax(store):
    jcfg, tcfg = cfgs()
    for kw in ({}, {"ignore_seg": True}, {"ignore_index": 0}):
        for g, r in zip(patches.cls_weights(store, tcfg, **kw),
                        jpatches.cls_weights(store, jcfg, **kw)):
            np.testing.assert_array_equal(g, r)


@pytest.fixture(scope="module")
def ssr_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("ssr")
    r = np.random.RandomState(1)
    for i in range(3):
        Image.fromarray(r.randint(0, 255, (60 + i, 50, 3)).astype(
            np.uint8)).save(root / f"r{i}_image.png")
        gt = np.zeros((60 + i, 50, 3), np.uint8)
        gt[: 20, :, 0] = 255
        gt[30:, 10:30, 2] = 255
        Image.fromarray(gt).save(root / f"r{i}_gt.png")
    return str(root)


def test_ssr_batches_and_ratios_equal_jax(ssr_dir):
    jcfg, tcfg = cfgs()
    jds = jssr.SSRSegDataset(ssr_dir, jcfg, seed=2, duplicate=2)
    tds = ssr.SSRSegDataset(ssr_dir, tcfg, seed=2, duplicate=2)
    _assert_batches_equal(list(tds.batches(batch_size=4)),
                          list(jds.batches(batch_size=4)))
    np.testing.assert_array_equal(ssr.cls_ratios_ssr(ssr_dir, tcfg),
                                  jssr.cls_ratios_ssr(ssr_dir, jcfg))


def test_ssr_batches_keep_rank_rows(ssr_dir):
    _, tcfg = cfgs()
    assert_rank_rows(*(ssr.SSRSegDataset(ssr_dir, tcfg, seed=2, duplicate=2)
                       for _ in range(2)), batch_size=4)


def _u8_batches(n=3, b=4, seed=0):
    rng = np.random.RandomState(seed)
    return [{
        "image": rng.randint(0, 255, (b, TILE, TILE, 3)).astype(np.uint8),
        "seg_label": rng.randint(0, 4, (b, TILE, TILE)).astype(np.int32),
        "cls_label": np.array([1, -1, 3, -1], np.int32),
        "reg_label": rng.rand(b).astype(np.float32),
        "is_cls": np.array([1, 0, 1, 0], np.float32),
        "is_reg": np.array([0, 1, 0, 0], np.float32),
        "is_seg": np.array([0, 0, 0, 1], np.float32)} for _ in range(n)]


def test_cache_index_batches_equal_jax():
    jcfg, tcfg = cfgs()
    jc = JaxCache.build(iter(_u8_batches()), jcfg)
    tc = DeviceEpochCache.build(iter(_u8_batches()), tcfg, "cpu")
    assert tc.n == jc.n == 12
    assert tc.arrays["seg_label"].dtype == torch.uint8
    for epoch in range(3):
        for drop in (True, False):
            got = list(tc.index_batches(5, seed=7, epoch=epoch,
                                        drop_remainder=drop))
            ref = list(jc.index_batches(5, seed=7, epoch=epoch,
                                        drop_remainder=drop))
            assert len(got) == len(ref)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g, r)
    capped = DeviceEpochCache.build(iter(_u8_batches()), tcfg, "cpu",
                                    max_bytes=2 * 4 * TILE * TILE * 3)
    assert capped.n == 8


def test_cached_step_equals_host_fed_step():
    """The cached step on rows ``idx`` equals the host-fed step on the
    host batch of those rows, the jitter drawn from generators of one
    seed."""
    _, cfg = cfgs(compute_dtype="float32", optim="sgd", lr=1e-2)
    host = _u8_batches()
    cache = DeviceEpochCache.build(iter(host), cfg, "cpu")
    idx = next(cache.index_batches(4, seed=1))
    rows = {k: np.concatenate([b[k] for b in host])[idx] for k in host[0]}

    def fresh():
        net = init_ynet(cfg, torch.Generator().manual_seed(0))
        return TrainState(net, build_optimizer(cfg, net.parameters()))

    s_host, s_cache = fresh(), fresh()
    batch = make_preprocess(cfg)(
        {k: torch.from_numpy(v) for k, v in rows.items()},
        step_generator(0, 1, 0, "cpu"))
    m_host = make_hybrid_train_step(s_host.model, cfg)(s_host, batch)
    m_cache = make_cached_hybrid_train_step(s_cache.model, cfg)(
        s_cache, cache.arrays, torch.from_numpy(idx),
        step_generator(0, 1, 0, "cpu"))
    for k in m_host:
        assert float(m_cache[k]) == float(m_host[k]), k
    for (k, a), b in zip(s_host.model.state_dict().items(),
                         s_cache.model.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
    g = gather_batch(cache.arrays, torch.from_numpy(idx), cfg, train=False)
    assert g["image"].dtype == torch.float32
    assert g["seg_label"].dtype == torch.int64


def test_checkpoint_resume_with_optimizer_state(tmp_path):
    _, cfg = cfgs(compute_dtype="float32", optim="adam",
                  model_save_pth=str(tmp_path))
    batch = {k: torch.from_numpy(v) for k, v in _u8_batches(1)[0].items()}
    batch = make_preprocess(cfg, train=False)(batch)

    def fresh(seed):
        net = init_ynet(cfg, torch.Generator().manual_seed(seed))
        return TrainState(net, build_optimizer(cfg, net.parameters()))

    a = fresh(0)
    step = make_hybrid_train_step(a.model, cfg)
    step(a, batch)
    pth = save_train_state(a, cfg, epoch=4)
    assert latest_checkpoint(str(tmp_path)) == pth
    assert load_checkpoint_config(pth) == cfg
    b = fresh(1)
    assert restore_train_state(pth, b) == 5
    assert b.step == a.step == 1
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), k
    ma = step(a, batch)
    mb = make_hybrid_train_step(b.model, cfg)(b, batch)
    assert float(ma["loss"]) == float(mb["loss"])
    for x, y in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(x, y)

    # an eval checkpoint (no "optimizer") restores; the optimizer stays
    ev = save_checkpoint(a.model, str(tmp_path / "eval"), "resnet18", 9)
    c = fresh(2)
    assert restore_train_state(ev, c) == 10
    assert not c.optimizer.state
    assert load_checkpoint_config(ev) is None


# ---- pretrained grafting ----

def _flax_variables(cfg, seed=0):
    model = jax_build_ynet(cfg)
    shapes = jax.eval_shape(lambda k: model.init(
        k, jnp.zeros((1, 64, 64, 3)), train=False), jax.random.PRNGKey(0))
    r = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: r.randn(*s.shape).astype(np.float32), dict(shapes))


def _torchvision_sd(arch, seed):
    """A torchvision-named ResNet state_dict (ImageNet ``fc`` included)
    from a seeded generator: the port's encoder names are torchvision's."""
    g = torch.Generator().manual_seed(seed)
    enc = build_ynet(default_config(arch_encoder=arch)).encoder
    sd = {k: torch.randn(v.shape, generator=g) for k, v in
          enc.state_dict().items() if not k.endswith("num_batches_tracked")}
    sd["fc.weight"] = torch.randn(1000, 512, generator=g)
    sd["fc.bias"] = torch.randn(1000, generator=g)
    return sd


def _graft_both(cfg, path):
    """(JAX apply_pretrained → from_flax, the port's graft) from the same
    starting variables."""
    variables = _flax_variables(cfg)
    ref = from_flax(jax_graft(variables, path, encoder_name="encoder"))
    net = build_ynet(default_config())
    net.load_state_dict(from_flax(variables))
    apply_pretrained(net, path)
    return ref, net.state_dict()


@pytest.mark.parametrize("wrapped", [False, True])
def test_torchvision_graft_equals_jax(tmp_path, wrapped):
    sd = _torchvision_sd("resnet18", 5)
    if wrapped:                      # a DataParallel reference checkpoint
        sd = {"state_dict": {"module." + k: v for k, v in sd.items()}}
    path = str(tmp_path / "resnet18.pth")
    torch.save(sd, path)
    ref, got = _graft_both(jax_config(), path)
    assert set(ref) == set(got)
    for k in ref:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], ref[k]), k
    enc = _torchvision_sd("resnet18", 5)
    assert torch.equal(got["encoder.layer3.0.downsample.0.weight"],
                       enc["layer3.0.downsample.0.weight"])


def test_full_checkpoint_graft_equals_jax(tmp_path):
    donor = init_ynet(default_config(), torch.Generator().manual_seed(9))
    path = str(tmp_path / "ref.pt")
    torch.save({"epoch": 3, "state_dict": donor.state_dict()}, path)
    ref, got = _graft_both(jax_config(), path)
    for k in ref:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], ref[k]), k
            assert torch.equal(got[k], donor.state_dict()[k]), k


def test_graft_refuses_mismatches(tmp_path):
    net = build_ynet(default_config())
    path = str(tmp_path / "r34.pth")
    torch.save(_torchvision_sd("resnet34", 1), path)
    with pytest.raises(KeyError):
        apply_pretrained(net, path)
    bad = {"decoder.nope.weight": torch.zeros(3),
           "encoder.conv1.weight": torch.zeros(64, 3, 7, 7)}
    torch.save(bad, path)
    with pytest.raises(ValueError, match="decoder"):
        apply_pretrained(net, path)
    torch.save({"conv1.weight": torch.zeros(64, 3, 3, 3)}, path)
    with pytest.raises(ValueError, match="shape"):
        apply_pretrained(net, path)
