"""Host utilities (counterpart of :mod:`wsiseg_tpu.utils`)."""
