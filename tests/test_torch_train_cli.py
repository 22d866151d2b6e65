"""The port's trainer CLIs (``python -m wsiseg_tpu_torch train``,
``train-cellularity``, ``train-p``, ``train-ssr``) with ``--device cpu``
on a synthetic 32² gt.npy store: the loss falls, checkpoints are written
and resume at epoch + 1, the device epoch cache trains, and the hybrid
trainer's whole-slide validation after an epoch equals a fresh engine on
that epoch's checkpoint (the engine's weights are refreshed between
validations). Without a card the trainers raise, and ``--mesh`` raises
``NotImplementedError`` naming the Multi-GPU item."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_eval import _npy_slide_dir
from test_torch_train_data import make_store
from wsiseg_tpu_torch.__main__ import main
from wsiseg_tpu_torch.config import parse_args
from wsiseg_tpu_torch.data import ssr
from wsiseg_tpu_torch.infer import evaluators

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return make_store(str(tmp_path_factory.mktemp("store")), n=48,
                      sizes=((32, 32),))


def _args(store, out, *extra):
    return ["--train_image_pth", store, "--val_image_pth", store,
            "--tile_w", "32", "--tile_h", "32", "--batch_size", "8",
            "--num_epoch", "2", "--save_models", "1", "--model_save_pth",
            str(out), "--train_model_pth", os.path.join(str(out), "*"),
            "--compute_dtype", "float32", "--lr", "3e-4", *extra]


def _falls(trainer):
    h = trainer.history
    assert [r["epoch"] for r in h] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in h)
    assert h[-1]["loss"] < h[0]["loss"], [r["loss"] for r in h]


def test_train_learns_checkpoints_and_validates(tmp_path, store,
                                                monkeypatch):
    slides = _npy_slide_dir(tmp_path)
    seen = {}
    real = evaluators.predict_wsis

    def recording(engine, collection, ep, **kw):
        seen[ep] = real(engine, collection, ep, **kw)
        return seen[ep]

    monkeypatch.setattr(evaluators, "predict_wsis", recording)
    argv = _args(store, tmp_path / "ck", "--raw_val_pth", str(slides),
                 "--wsi_mask_pth", "", "--tile_stride_w", "32",
                 "--tile_stride_h", "32", "--val_save_pth",
                 str(tmp_path / "val"))
    trainer = main(["train", "--device", "cpu"] + argv)
    _falls(trainer)
    assert sorted(seen) == [1, 2]
    assert trainer.history[-1]["val_mean_tb_iou"] == \
        seen[2]["_mean_tb_iou"]
    ck = tmp_path / "ck"
    assert (ck / "model_resnet18_2.pt").exists()
    assert (ck / "model_resnet18_2.pt.config.json").exists()

    # a fresh engine on epoch 2's checkpoint gives the same validation
    from wsiseg_tpu_torch.cli.common import restore_for_eval
    from wsiseg_tpu_torch.data.wsi_tiles import SlideCollection
    from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
    cfg = parse_args(argv).replace(eval_model_pth=str(ck / "*"))
    model, ep = restore_for_eval(cfg)
    assert ep == 2
    fresh = real(DenseInferenceEngine(model, cfg, device="cpu"),
                 SlideCollection(str(slides), cfg), "fresh")
    assert fresh["s0.npy"]["acc"] == seen[2]["s0.npy"]["acc"]
    assert fresh["_mean_tb_iou"] == seen[2]["_mean_tb_iou"]
    a = np.asarray(Image.open(tmp_path / "val" / "2" / "s0.npy_32.png"))
    b = np.asarray(Image.open(tmp_path / "val" / "fresh" / "s0.npy_32.png"))
    np.testing.assert_array_equal(a, b)


def test_train_device_cache_and_resume(tmp_path, store):
    out = tmp_path / "ck"
    trainer = main(["train", "--device", "cpu"] + _args(
        store, out, "--device_cache", "true", "--raw_val_pth", ""))
    _falls(trainer)
    again = main(["train", "--device", "cpu"] + _args(
        store, out, "--raw_val_pth", "", "--continue_train", "true",
        "--num_epoch", "3"))
    assert [r["epoch"] for r in again.history] == [3]
    assert again.state.step == 3 * trainer.state.step // 2
    assert (out / "model_resnet18_3.pt").exists()


def test_train_cellularity(tmp_path, store):
    trainer = main(["train-cellularity", "--device", "cpu"] + _args(
        store, tmp_path / "ck"))
    _falls(trainer)
    assert {"val_l1", "val_mse"} <= set(trainer.history[-1])


def test_train_p(tmp_path, store):
    trainer = main(["train-p", "--device", "cpu"] + _args(
        store, tmp_path / "ck"))
    _falls(trainer)
    assert 0.0 <= trainer.history[-1]["val_acc"] <= 1.0
    assert (tmp_path / "ck" / "model_resnet18_2.pt").exists()


def test_train_ssr(tmp_path, monkeypatch):
    """train-ssr on 32² regions (``SSR_SIZE`` is 512 in use)."""
    monkeypatch.setattr(ssr, "SSR_SIZE", 32)
    r = np.random.RandomState(0)
    for i in range(2):
        img = r.randint(0, 80, (40, 40, 3)).astype(np.uint8)
        gt = np.zeros((40, 40, 3), np.uint8)
        gt[:20, :, 1] = 255
        img[:20, :, 1] += 150
        Image.fromarray(img).save(tmp_path / f"r{i}_image.png")
        Image.fromarray(gt).save(tmp_path / f"r{i}_gt.png")
    trainer = main(["train-ssr", "--device", "cpu"] + _args(
        str(tmp_path), tmp_path / "ck", "--batch_size", "10"))
    _falls(trainer)
    assert 0.0 <= trainer.history[-1]["val_acc"] <= 1.0


@pytest.mark.parametrize("cmd", ["train", "train-cellularity", "train-p",
                                 "train-ssr"])
def test_trainers_default_to_cuda_and_refuse_mesh(tmp_path, store, cmd):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main([cmd] + _args(store, tmp_path))
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        main([cmd, "--device", "cpu", "--mesh", "2"] + _args(store,
                                                              tmp_path))
