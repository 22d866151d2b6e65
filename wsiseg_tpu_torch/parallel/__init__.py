"""Multi-rank training and inference on ``torch.distributed``
(counterpart of :mod:`wsiseg_tpu.parallel`): :mod:`.mesh` (the mesh and
the batch/state helpers), :mod:`.comm` (the collectives), :mod:`.launch`
(starting a group of ranks) and :mod:`.dryrun` (the multi-rank checks of
``__graft_entry__.dryrun_multichip``)."""
