"""wsiseg_tpu_torch — the PyTorch/CUDA port of :mod:`wsiseg_tpu`.

The JAX package stays the reference; this package mirrors its layout
(``models``, ``ops``, ``data``, ``infer``, ``train``, ``cli``) and is held
against it by the ``tests/test_torch_*.py`` parity tests.

Design:
- plain tensor code is eager PyTorch; activations are logical NCHW
  tensors in ``torch.channels_last`` memory, which is the JAX package's
  NHWC layout byte for byte;
- the TPU's Pallas kernels become hand-written CUDA kernels for Hopper
  (``csrc/``), built with ``nvcc`` at first use and bound with ``ctypes``;
  each has a plain PyTorch version beside it that CPU tensors take;
- the JAX-free modules of ``wsiseg_tpu`` (``config``, ``slides``,
  ``ops.geometry``, ``utils.filesystem``) are shared as they are.

This package never imports ``jax``, ``flax`` or ``optax``.
"""

from wsiseg_tpu.config import Config, default_config  # noqa: F401
