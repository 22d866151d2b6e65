"""Checkpoints (counterpart of :mod:`wsiseg_tpu.train`). Training itself
is still to be ported (ROADMAP.md, queue 1, 'training')."""
