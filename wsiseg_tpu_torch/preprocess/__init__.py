"""Offline training-data generators — counterpart of
``wsiseg_tpu/preprocess`` (twins of reference ``preprocess/*.py``).

Every module exposes a ``generate(...)`` library function (operating on
:class:`wsiseg_tpu_torch.slides.reader.SlideReader` objects and plain
paths, so tests run hermetically on synthetic slides) plus a
``main(argv)`` CLI. The generators whose work includes a device op
(``find_nuclei``, the binary morphology, k-means and ``quantize_image``,
SLIC) take ``device`` (CLI: ``--device``): the card by default, which
raises without one; the CPU when asked. The others are copies of the JAX
modules and take no device.

Reference script                         →  module
----------------------------------------------------
mk_gt.py                                 →  mk_gt
mk_traindata_bach_centered.py            →  mk_traindata_centered (aperio)
mk_traindata_sunnybrook_centered.py      →  mk_traindata_centered (sedeen)
mk_traindata_sunny_no_tumors.py          →  mk_traindata_no_tumors
patch_to_gt.py                           →  patch_to_gt
patch_to_cls_bach.py                     →  patch_to_cls (bach)
patch_to_cls_breakhis.py                 →  patch_to_cls (breakhis)
patch_to_cls_spie_breastpathq.py         →  patch_to_cls (breastpathq)
mk_traindata_spie_breastpathq_cells.py   →  breastpathq_cells
makedata_ssr.py                          →  makedata_ssr
ssr_patch_to_gt.py                       →  ssr_patch_to_gt
region_proposal_points.py                →  region_proposal_points (cc)
region_proposal_points_slic.py           →  region_proposal_points (slic)
region_proposal_points_patch.py          →  region_proposal_points (patch)
collage_of_patches.py                    →  collage_of_patches
"""
