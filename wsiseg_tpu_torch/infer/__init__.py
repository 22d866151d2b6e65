"""Dense inference (counterpart of :mod:`wsiseg_tpu.infer`)."""
