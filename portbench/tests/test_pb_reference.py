"""The plain reference against the program at a tiny size on the CPU:
the same weights give the same forward (eval and train mode), the same
labels and heat from one slide, and the same first training step."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness import slides as slide_gen
from portbench.harness.weights import make_state
from portbench.reference import postprocess
from portbench.reference import train as ref_train
from portbench.reference.infer import model_from_state, slide_probs
from portbench.reference.ynet import YNet as RefYNet

CFG = {"class_probs": [0.0] * 4, "dataset_mean": [0.485, 0.456, 0.406],
       "dataset_std": [0.229, 0.224, 0.225], "num_classes": 4}
MODELS = [("resnet18", "Unet"), ("resnet50", "FPN")]


def _pair(arch, dec, seed=3):
    from wsiseg_tpu_torch.models.ynet import YNet
    ref = RefYNet(arch, dec)
    state = make_state(ref, torch.Generator().manual_seed(seed))
    ref.load_state_dict(state)
    prog = YNet(arch, 4, 1, dec)
    prog.load_state_dict(state)
    return ref, prog, state


@pytest.mark.parametrize("arch,dec", MODELS)
def test_forward_equals_program(arch, dec):
    torch.manual_seed(0)
    ref, prog, _ = _pair(arch, dec)
    x = torch.randn(2, 3, 64, 96)
    for mode in ("eval", "train"):
        getattr(ref, mode)()
        getattr(prog, mode)()
        a, b = ref(x), prog(x)
        for k in ("seg", "cls", "reg"):
            torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,dec", MODELS)
def test_labels_heat_equal_program_in_f32(arch, dec):
    """The engine in f32 on the CPU against the reference's
    postprocess: the same labels but where the reference is within
    rounding of a tie, heat within one step."""
    from wsiseg_tpu_torch.config import default_config
    from wsiseg_tpu_torch.data.wsi_tiles import plan_slide
    from wsiseg_tpu_torch.infer.engine import DenseInferenceEngine
    from wsiseg_tpu_torch.slides import VirtualPyramidSlide

    _, prog, state = _pair(arch, dec)
    img = slide_gen.level2_images(1, 128, 256,
                                  torch.Generator().manual_seed(4))[0]
    cfg = default_config(model_name=dec, arch_encoder=arch, tile_w=64,
                         tile_h=64, tile_stride_w=32, tile_stride_h=32,
                         wsi_mask_pth="", compute_dtype="float32")
    eng = DenseInferenceEngine(prog, cfg, device="cpu", dtype=torch.float32)
    plan = plan_slide("s", VirtualPyramidSlide({2: img}, num_levels=3), cfg)
    plan.mask = slide_gen.tissue_mask(img)
    res = eng.predict_slide_fcn(plan)
    model = model_from_state({**CFG, "arch_encoder": arch,
                              "model_name": dec}, state, "cpu")
    probs = slide_probs(model, CFG, img, "cpu")
    r = postprocess.judge(probs, torch.from_numpy(plan.mask), res.labels,
                          np.rint(res.heatmap * 255).astype(np.uint8))
    assert r["heat_err"] <= 2 and r["label_miss"] == 0, r


def test_first_step_equals_program_in_f32():
    """One hybrid step of the program's cached path in f32 against the
    reference's step on the same rows, jitter and weights."""
    from wsiseg_tpu_torch.config import default_config
    from wsiseg_tpu_torch.models.ynet import YNet
    from wsiseg_tpu_torch.optim import build_optimizer
    from wsiseg_tpu_torch.train.device_cache import \
        make_cached_hybrid_train_step
    from wsiseg_tpu_torch.train.state import TrainState

    gen = torch.Generator().manual_seed(7)
    ref = RefYNet("resnet18", "Unet")
    state = make_state(ref, gen)
    n, t = 8, 64
    arrays = {"image": torch.randint(0, 256, (n, t, t, 3), generator=gen,
                                     dtype=torch.uint8),
              "seg_label": torch.randint(0, 4, (n, t, t), generator=gen,
                                         dtype=torch.uint8),
              "cls_label": torch.tensor([0, 1, -1, -1, 2, -1, 3, -1]),
              "reg_label": torch.rand(n, generator=gen),
              "is_cls": torch.tensor([1., 1, 0, 0, 1, 0, 1, 0]),
              "is_reg": torch.tensor([0., 0, 1, 0, 0, 1, 0, 0]),
              "is_seg": torch.tensor([0., 0, 0, 1, 0, 0, 0, 1])}
    cfg = default_config(compute_dtype="float32", tile_w=t, tile_h=t,
                         batch_size=n, seed=5)
    prog = YNet("resnet18", 4, 1, "Unet")
    prog.load_state_dict(state)
    st = TrainState(prog, build_optimizer(cfg, prog.parameters()))
    cw, sw = np.array([1.0, .5, .5, 1]), np.array([.2, 1, .7, .9])
    step = make_cached_hybrid_train_step(prog, cfg, cls_weights=cw,
                                         seg_weights=sw)
    idx = torch.arange(n)
    kept = {}
    hook = prog.register_forward_hook(lambda mod, a, o: kept.update(o))
    m = step(st, arrays, idx, ref_train.step_generator(5, 1, 0, "cpu"))
    hook.remove()
    model = model_from_state({**CFG, "arch_encoder": "resnet18",
                              "model_name": "Unet"}, state, "cpu")
    out = ref_train.run_steps(
        model, [{k: v.clone() for k, v in arrays.items()}],
        [ref_train.step_generator(5, 1, 0, "cpu")], CFG,
        {"lr": cfg.lr, "beta1": .9, "beta2": .999,
         "weight_decay": cfg.weight_decay},
        torch.tensor(cw, dtype=torch.float32),
        torch.tensor(sw, dtype=torch.float32))
    assert abs(float(m["loss"]) - out["losses"][0]) < 1e-4 * out["losses"][0]
    rows = ref_train.row_losses(kept, arrays, torch.tensor(cw).float(),
                                torch.tensor(sw).float())
    torch.testing.assert_close(rows, out["rows"], rtol=1e-4, atol=1e-5)
    for name, p in prog.named_parameters():
        g = st.optimizer.state[p]["exp_avg"] / 0.1
        ref_g = out["grads"][name]
        assert float((g - ref_g).norm()) <= 2e-2 * max(
            float(ref_g.norm()), 1e-3), name
