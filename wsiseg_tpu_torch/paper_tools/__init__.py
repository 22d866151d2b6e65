"""Analysis/paper tools — counterpart of ``wsiseg_tpu/paper_tools`` (twins
of reference ``paper_tools/*.py``)."""
