"""Filesystem helpers (capability parity with reference utils/filesystem.py:7-21)."""

from __future__ import annotations

import os
import shutil
from pathlib import Path

import numpy as np


def make_folder(pth: str, purge: bool = False) -> None:
    """mkdir -p, optionally purging first (reference utils/filesystem.py:7-10)."""
    if purge and os.path.exists(pth):
        shutil.rmtree(pth)
    os.makedirs(pth, exist_ok=True)


def fetch_metadata(pth: str) -> dict:
    """Load a pickled gt.npy metadata store, or {} if absent
    (reference utils/filesystem.py:13-16)."""
    if os.path.exists(pth):
        return np.load(pth, allow_pickle=True).flatten()[0]
    return {}


def find_heatmaps(save_pth: str, slide_id) -> list[str]:
    """Heatmap artifacts for ONE slide under a val_save_pth tree.

    The engine writes ``<slide>_<stride>_heatmap.png`` (reference
    utils/eval.py:227-229). Matches are anchored on the full slide-id token
    (basename starts with ``<id>.`` or ``<id>_``) — a bare ``*{id}*``
    substring glob (the reference's pattern, inherited in round 1) pairs
    slide 1 with slide 10/21/100's heatmaps and corrupts the screening
    metrics (ADVICE.md round-1)."""
    import glob

    sid = str(slide_id)
    out = []
    for p in sorted(glob.glob(os.path.join(save_pth, "**", "*heatmap*"),
                              recursive=True)):
        base = os.path.basename(p)
        if base.startswith(sid + ".") or base.startswith(sid + "_"):
            out.append(p)
    return out


def fix_path(pth: str, anchor: str | None = None) -> str:
    """Resolve ``pth`` relative to an anchor directory (default: repo root).

    The reference resolved relative to ``utils/`` (utils/filesystem.py:19-21);
    here the anchor is explicit and defaults to the package's parent so the
    behavior is location-independent.
    """
    base = Path(anchor) if anchor is not None else Path(__file__).resolve().parents[2]
    return (base / pth).resolve().as_posix()
