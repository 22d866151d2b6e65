"""The port's profiling helpers (wsiseg_tpu_torch.utils.profiling) against
wsiseg_tpu.utils.profiling on the CPU: the analytic FLOP count (exactly
JAX's for every encoder and decoder), the peak table, and the CPU forms of ``timed``,
``device_memory_stats`` and ``trace``. Then the FLOP count against the
port's own modules: 2·MAC of every ``nn.Conv2d`` that fires in
``YNet.segment``, which shows the count's two faults (ROADMAP §3). The
CUDA forms run in ``tests/test_torch_cuda.py``."""

import functools
import glob
import json
import os

import numpy as np
import pytest
import torch

from wsiseg_tpu.utils import profiling as jax_profiling
from wsiseg_tpu_torch.config import default_config
from wsiseg_tpu_torch.models.resnet import ENCODER_SPECS
from wsiseg_tpu_torch.models.ynet import build_ynet
from wsiseg_tpu_torch.utils import profiling

torch.set_num_threads(2)
ARCHS = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152")
DECODERS = ("Unet", "Linknet", "FPN", "PSPNet")
MODULE_HW = 256


@pytest.mark.parametrize("hw", [(256, 256), (3072, 4096)])
@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_forward_flops_equals_jax(arch, decoder, hw):
    got = profiling.dense_forward_flops(arch, *hw, 4, decoder)
    assert got == jax_profiling.dense_forward_flops(arch, *hw, 4, decoder)
    assert got > 0


@pytest.mark.parametrize("kind,peak", [
    ("NVIDIA H100 80GB HBM3", 989.0),       # SXM5, the chip check's card
    ("NVIDIA H100 SXM5 80GB", 989.0),
    ("NVIDIA H100 PCIe", 756.0),
    ("NVIDIA H100 NVL", 835.0),
])
def test_detect_peak_tflops_h100_names(kind, peak):
    assert profiling.detect_peak_tflops(kind=kind) == peak
    assert profiling.detect_peak_tflops(default=1.0, kind=kind) == peak


def test_detect_peak_tflops_unknown_card():
    kind = "NVIDIA A100-SXM4-80GB"
    with pytest.raises(ValueError, match="PEAK_TFLOPS"):
        profiling.detect_peak_tflops(kind=kind)
    assert profiling.detect_peak_tflops(default=312.0, kind=kind) == 312.0
    # the difference by design: JAX answers with the TPU v5e's peak
    assert jax_profiling.detect_peak_tflops(kind=kind) == 197.0


def test_timed_cpu_logs_label():
    lines = []
    with profiling.timed("block", log=lines.append, device="cpu"):
        torch.ones(4).sum()
    assert len(lines) == 1 and lines[0].startswith("block: ")
    assert lines[0].endswith("s") and float(lines[0][7:-1]) >= 0


def test_device_memory_stats_cpu_is_empty():
    assert profiling.device_memory_stats(device="cpu") == {}


@pytest.mark.parametrize("host_profile", [False, True])
def test_trace_cpu_writes_the_ops_of_the_block(tmp_path, host_profile):
    a = torch.from_numpy(np.random.RandomState(0).rand(8, 8).astype(
        np.float32))
    with profiling.trace(str(tmp_path), host_profile=host_profile,
                         device="cpu") as prof:
        torch.mm(a, a)
    files = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert mm and all(e["cat"] == "cpu_op" for e in mm)
    assert ("Input Dims" in mm[0]["args"]) == host_profile
    assert any(ev.key == "aten::mm" for ev in prof.key_averages())


def test_trace_without_log_dir_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profiling.trace(None, device="cpu") as prof:
        torch.ones(4).sum()
    assert any(ev.key == "aten::sum" for ev in prof.key_averages())
    assert os.listdir(str(tmp_path)) == []


def test_cuda_forms_raise_without_a_card(tmp_path, monkeypatch):
    """Without a card the CUDA forms raise: none drops to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profiling.trace(str(tmp_path)):
            pass
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profiling.device_memory_stats()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profiling.timed("block", log=lambda s: None):
            pass
    assert os.listdir(str(tmp_path)) == []


@functools.lru_cache(maxsize=None)
def module_flops(arch: str, decoder: str) -> int:
    """2·MAC of every ``nn.Conv2d`` that fires in ``YNet.segment`` on one
    MODULE_HW² image, 4 classes, seeded random weights."""
    with torch.random.fork_rng():
        torch.manual_seed(0)
        model = build_ynet(default_config(arch_encoder=arch,
                                          model_name=decoder)).eval()
    macs = []

    def count(mod, inputs, out):
        kh, kw = mod.kernel_size
        macs.append(out[0].numel() * (mod.in_channels // mod.groups)
                    * kh * kw)

    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            mod.register_forward_hook(count)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        1, 3, MODULE_HW, MODULE_HW).astype(np.float32))
    with torch.no_grad():
        y = model.segment(x)
    assert y.shape == (1, 4, MODULE_HW, MODULE_HW)
    return 2 * sum(macs)


@pytest.mark.parametrize("arch", ["resnet18", "resnet34"])
def test_flops_equal_module_count_on_basic_unet(arch):
    assert profiling.dense_forward_flops(arch, MODULE_HW, MODULE_HW) == \
        module_flops(arch, "Unet")


@pytest.mark.parametrize("arch,decoder", [
    ("resnet50", "Unet"),
    *[(a, d) for a in ("resnet18", "resnet50")
      for d in ("Linknet", "FPN", "PSPNet")]])
def test_flops_below_module_count(arch, decoder):
    """Fault 1 (no decoder or head off Unet) and fault 2 (Bottleneck)."""
    assert profiling.dense_forward_flops(
        arch, MODULE_HW, MODULE_HW, 4, decoder) < module_flops(arch, decoder)


def test_resnet50_unet_gap_is_the_reduce_at_input_resolution():
    """Fault 2 alone: stages 2–4's first 1×1 reduce runs at the input
    resolution (the stride sits on the 3×3), four times the output's
    pixels, where the count takes the output's."""
    gap = module_flops("resnet50", "Unet") - profiling.dense_forward_flops(
        "resnet50", MODULE_HW, MODULE_HW)
    _, stages = ENCODER_SPECS["resnet50"]
    missed = 0
    for i in range(1, len(stages)):
        planes = 64 * 2 ** i
        cin = planes * 2                   # the stage before's 4·planes/2
        hw_out = (MODULE_HW // (4 * 2 ** i)) ** 2
        missed += 3 * hw_out * cin * planes
    assert gap == 2 * missed == 603_979_776
