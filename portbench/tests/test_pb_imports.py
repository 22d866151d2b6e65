"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module name (the port's name begins with the JAX
package's); the reference imports nothing of the program."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

from pb_util import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "wsiseg_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    for path in glob.glob(os.path.join(ROOT, "portbench", "**", "*.py"),
                          recursive=True):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, "portbench", "reference",
                                       "*.py")):
        assert "wsiseg_tpu_torch" not in set(_imports(path)), path


def test_loaded_modules_hold_no_jax():
    """Import the harness, every driver and the program's modules they
    reach, then look at ``sys.modules`` by top-level name."""
    code = (
        "import sys, glob, importlib, os\n"
        "import portbench.run, portbench.calibrate\n"
        "for p in glob.glob('portbench/drivers/*.py'):\n"
        "    importlib.import_module('portbench.drivers.' + "
        "os.path.basename(p)[:-3])\n"
        "import wsiseg_tpu_torch.infer.evaluators, "
        "wsiseg_tpu_torch.train.loop, wsiseg_tpu_torch.train.device_cache\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n"
        % FORBIDDEN)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
