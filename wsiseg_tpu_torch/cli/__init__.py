"""Command-line entry points (counterpart of :mod:`wsiseg_tpu.cli`)."""
