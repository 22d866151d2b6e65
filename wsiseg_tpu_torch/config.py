"""Typed, validated configuration.

Replaces the reference's single global argparse namespace (``myargs.py:1-139``)
with an explicit dataclass. Field names and defaults mirror the reference
flags one-for-one so CLI invocations port directly; undeclared-but-assigned
fields from the reference (``raw_val1_pth``, ``patch_folder``,
``label_csv_path``, ``cls_ratios`` — see reference ``eval.py:43``,
``utils/dataset_hr.py:133``) are declared explicitly here.

Unlike the reference, nothing is parsed at import time: construct a
:class:`Config` directly in code/tests, or call :func:`parse_args` in a CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

# Losses registered in the reference loss factory (models/losses.py:23-39).
KNOWN_LOSSES = (
    "xent", "bce", "focal", "ohem", "cent", "dice", "jaccard", "tversky",
    "zeroloss", "mse", "l1", "logcosh", "xtanh", "xsigmoid", "rmse",
)
KNOWN_OPTIMIZERS = ("adam", "sgd", "adabound")
# smp-style decoder architectures (reference myargs.py:9-10).
KNOWN_MODELS = ("Unet", "FPN", "PSPNet", "Linknet")
KNOWN_ENCODERS = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152")


@dataclass
class Config:
    # ---- model (reference myargs.py:9-17) ----
    model_name: str = "Unet"
    arch_encoder: str = "resnet18"
    num_classes: int = 4
    class_probs: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)

    # ---- optimizer (myargs.py:20-30) ----
    optim: str = "adam"
    lr: float = 1e-4
    weight_decay: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999

    # ---- schedule (myargs.py:32-42) ----
    num_epoch: int = 2000
    start_epoch: int = 1
    batch_size: int = 30
    workers: int = 10
    # reference selects GPUs via gpu_ids; here it names JAX devices.
    device_ids: str = "0"

    # ---- loss (myargs.py:45-60) ----
    loss: str = "mse"

    # ---- checkpointing (myargs.py:64-78) ----
    eval_model_pth: str = "data/models/model_resnet18_194"
    train_model_pth: str = "data/models/*"
    model_save_pth: str = "data/models"
    continue_train: bool = False
    save_models: int = 1
    validate_model: int = 1
    # Pretrained torch weights grafted at model build: a torchvision-style
    # encoder state_dict OR a full reference checkpoint (.pt/.pth/.npz).
    # The reference always trains from ImageNet encoders (train.py:29).
    pretrained_pth: Optional[str] = None

    # ---- source data paths (myargs.py:82-101) ----
    raw_train_pth: str = "data/bach/wsi"
    raw_val_pth: str = "data/bach/wsi"
    wsi_mask_pth: str = "data/test/wsi_mask"
    train_image_pth: str = "data/train"
    val_image_pth: str = "data/val"
    train_hr_image_pth: str = "data/train_hr"
    val_hr_image_pth: str = "data/val_hr"
    val_save_pth: str = "data/val/out"
    # Declared-on-use fields in the reference, made explicit:
    raw_val1_pth: Optional[str] = None
    patch_folder: Optional[str] = None
    label_csv_path: Optional[str] = None

    # ---- tiling geometry (myargs.py:105-122) ----
    tile_w: int = 512
    tile_h: int = 512
    tile_stride_w: int = 128
    tile_stride_h: int = 128
    scan_level: int = 2
    scan_resize: int = 1

    # ---- normalization stats (myargs.py:127-130) ----
    dataset_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    dataset_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)

    # ---- numerics (myargs.py:135-136) ----
    epsilon: float = 1e-8

    # ---- TPU-native additions (no reference equivalent) ----
    compute_dtype: str = "bfloat16"      # dtype for conv/matmul compute
    param_dtype: str = "float32"         # dtype for parameters / BN stats
    norm_dtype: str = ""                 # BatchNorm OUTPUT dtype; "" follows
                                         # compute_dtype. Statistics, running
                                         # averages and scale/bias stay f32
                                         # regardless (flax forces f32
                                         # reductions; unet._S2dGroupBatchNorm
                                         # normalizes in f32 too) — this only
                                         # stores the normalized activations in
                                         # the compute dtype. Train step b32:
                                         # 115→98 ms bf16 (scripts/exp_r4e.py).
    mesh_shape: Tuple[int, ...] = (-1,)  # data-parallel mesh; -1 = all devices
    mesh_axes: Tuple[str, ...] = ("data",)
    # --mesh flag: "" = single device, "all" = every visible device,
    # "N" = first N devices; enables data-parallel training in all trainers
    mesh: str = ""
    prefetch_depth: int = 2              # host→device pipeline depth
    infer_batch_size: int = 32           # dense-inference tile batch
    # Train-mode s2d cell-domain decoder tail (Unet only): exact math,
    # identical param tree, ~2x faster steps on TPU (models/unet.py).
    train_s2d_tail: bool = True
    # Segmentation loss consumed directly in the tail's s2d layout (labels
    # space-to-depth'd host-side; exact same loss/grads, skips the full-res
    # f32 logit materialization — losses.cross_entropy_s2d).
    train_s2d_loss: bool = True
    # Gradient accumulation: split each batch into this many microbatches
    # and accumulate grads over a lax.scan before ONE optimizer update.
    # Peak activation memory drops by the factor — unlocks batch sizes
    # whose single-pass graph exceeds HBM (b192+ at 512²;
    # scripts/exp_r6c.py). Exact mean-of-microbatch-grads semantics
    # (tests/test_train_e2e.py::test_grad_accum_matches_manual_microbatches).
    grad_accum: int = 1
    # Device-resident epoch cache: upload the u8 training set ONCE and
    # gather/shuffle on device — steady-state epochs move only a (B,) i32
    # index array over the host→device link instead of ~100 MB/step
    # (train/device_cache.py; measured train_e2e_* vs train_cached_* bench
    # keys). Caps at device_cache_gb of image bytes.
    device_cache: bool = False
    device_cache_gb: float = 4.0
    seed: int = 0

    def __post_init__(self) -> None:
        if not self.norm_dtype:
            self.norm_dtype = self.compute_dtype
        if self.loss not in KNOWN_LOSSES:
            raise ValueError(f"unknown loss {self.loss!r}; expected one of {KNOWN_LOSSES}")
        if self.optim not in KNOWN_OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self.optim!r}; expected one of {KNOWN_OPTIMIZERS}")
        if self.model_name not in KNOWN_MODELS:
            raise ValueError(f"unknown model {self.model_name!r}; expected one of {KNOWN_MODELS}")
        if self.arch_encoder not in KNOWN_ENCODERS:
            raise ValueError(f"unknown encoder {self.arch_encoder!r}; expected one of {KNOWN_ENCODERS}")
        if self.num_classes < 1:
            raise ValueError("num_classes must be >= 1")
        if len(self.class_probs) != self.num_classes:
            # Mirror the reference default of one threshold per class
            # (myargs.py:15-17) but validate instead of failing downstream.
            raise ValueError(
                f"class_probs has {len(self.class_probs)} entries for "
                f"{self.num_classes} classes")
        for name in ("tile_w", "tile_h", "tile_stride_w", "tile_stride_h"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be positive")
        if self.scan_level < 0:
            raise ValueError("scan_level must be >= 0")
        if self.scan_resize < 1:
            raise ValueError("scan_resize must be >= 1")
        if self.grad_accum < 1:
            raise ValueError("grad_accum must be >= 1")
        if self.grad_accum > 1 and self.batch_size % self.grad_accum:
            raise ValueError(
                f"batch_size ({self.batch_size}) must be divisible by "
                f"grad_accum ({self.grad_accum})")

    def replace(self, **kw) -> "Config":
        # norm_dtype FOLLOWS compute_dtype (the "" sentinel is resolved at
        # construction, so re-resolve on a compute_dtype change unless the
        # caller pins norm_dtype explicitly in the same call)
        if "compute_dtype" in kw and "norm_dtype" not in kw:
            kw["norm_dtype"] = ""
        return dataclasses.replace(self, **kw)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def fromdict(cls, d: dict) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        clean = {}
        for k, v in d.items():
            if k not in known:
                continue
            if isinstance(v, list):
                v = tuple(v)
            clean[k] = v
        return cls(**clean)


def default_config(**overrides) -> Config:
    """A Config with reference defaults; num_classes/class_probs kept in sync."""
    if "num_classes" in overrides and "class_probs" not in overrides:
        overrides["class_probs"] = tuple(0.0 for _ in range(overrides["num_classes"]))
    return Config(**overrides)


def _add_all_flags(parser: argparse.ArgumentParser) -> None:
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.type in ("bool", bool):
            parser.add_argument(name, default=default, type=lambda s: s.lower() in ("1", "true", "yes"))
        elif isinstance(default, tuple):
            parser.add_argument(name, default=default, nargs="*",
                                type=type(default[0]) if default else float)
        elif isinstance(default, int):
            parser.add_argument(name, default=default, type=int)
        elif isinstance(default, float):
            parser.add_argument(name, default=default, type=float)
        else:
            parser.add_argument(name, default=default, type=str)


def parse_args(argv: Optional[Sequence[str]] = None, **overrides) -> Config:
    """Build a Config from CLI flags (same names as reference myargs)."""
    parser = argparse.ArgumentParser(description="wsiseg_tpu")
    _add_all_flags(parser)
    ns = parser.parse_args(argv)
    d = vars(ns)
    d.update(overrides)
    if "num_classes" in d and len(d.get("class_probs", ())) != d["num_classes"]:
        d["class_probs"] = tuple(0.0 for _ in range(d["num_classes"]))
    return Config.fromdict(d)
