"""Helpers for the benchmark's own tests: the checkout's root, the
benchmark file, and a tiny run of a cell in a subprocess."""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_run(workload: str, trace: int = 0, seed: int = 2 ** 31 + 5,
             seconds: float = 1.5, env=None):
    """(exit code, last stdout line as JSON or None, stderr) of a
    ``--tiny`` run on the CPU."""
    e = dict(os.environ, PYTHONWARNINGS="ignore", **(env or {}))
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace), "--tiny"], cwd=ROOT, env=e, capture_output=True,
        text=True, timeout=300)
    lines = p.stdout.strip().splitlines()
    return p.returncode, (json.loads(lines[-1]) if lines else None), \
        p.stderr
