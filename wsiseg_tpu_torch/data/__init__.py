"""Slide planning (counterpart of :mod:`wsiseg_tpu.data`)."""
