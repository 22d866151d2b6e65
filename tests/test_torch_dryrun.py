"""``python -m wsiseg_tpu_torch.parallel.dryrun 4 --device cpu``: the
port's counterpart of ``__graft_entry__.dryrun_multichip`` on four gloo
CPU ranks (four ranks make the uneven-stripe case and a real ×n): three
data-parallel hybrid steps (finite, falling, nonzero seg loss, step 1
equal to the single-device step), psum == rows, slide-parallel ×4 ==
single, row-striped FCN == the chunked oracle (Unet and Linknet), and
check 5: the first step on a (2, 2) data × space mesh has the DP step's
loss within JAX's 1e-3·max(1, loss)."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dryrun():
    r = subprocess.run(
        [sys.executable, "-m", "wsiseg_tpu_torch.parallel.dryrun", "4",
         "--device", "cpu"], capture_output=True, text=True, cwd=REPO,
        timeout=600, env=dict(os.environ, PYTHONPATH=REPO))
    return r


def test_dryrun_exits_zero(dryrun):
    assert dryrun.returncode == 0, dryrun.stderr[-4000:]


@pytest.mark.parametrize("phrase", [
    "dryrun_multichip(4): 3 hybrid train steps OK",
    "step 1 == single device",
    "psum==rows",
    "slide-parallel fcn serving x4 == single",
    "row-striped FCN == chunked oracle (Unet + Linknet)",
    "check 5 OK: spatial (2x2) step-0 loss"])
def test_dryrun_reports_each_check(dryrun, phrase):
    assert phrase in dryrun.stdout, dryrun.stdout


def test_dryrun_defaults_to_cuda():
    """Without ``--device`` the dryrun asks for one card a rank and, with
    fewer visible, raises; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from wsiseg_tpu_torch.parallel import dryrun
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.main(["2"])
