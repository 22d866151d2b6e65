"""Training: steps, loop, checkpoints and the device epoch cache
(counterpart of :mod:`wsiseg_tpu.train`)."""
