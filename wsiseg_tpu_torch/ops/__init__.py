"""Tensor ops and kernels (counterpart of :mod:`wsiseg_tpu.ops`)."""
