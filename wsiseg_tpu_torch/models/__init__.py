"""Y-Net model family (counterpart of :mod:`wsiseg_tpu.models`)."""
