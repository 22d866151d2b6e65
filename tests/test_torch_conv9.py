"""Fused 3×3 convs (wsiseg_tpu_torch.ops.conv9) against the Pallas kernels
``wsiseg_tpu.ops.conv9.conv9`` / ``conv_chain`` and
``wsiseg_tpu.ops.pallas_conv.conv3x3_small`` in interpret mode.

On the CPU the port's wrappers run their plain versions; the CUDA kernel
itself is held against those in tests/test_torch_cuda.py, on a machine
with a card. H and W are not multiples of the Pallas blocks (br = 8,
wc = 16), so the chain's per-layer border zeroing is exercised.

Tolerances: f32 inputs rtol = atol = 1e-4 (only the summation order
differs); bf16 inputs those of tests/test_conv9.py (bf16 intermediates
round at the same points, one ulp apart where the f32 sums straddle a
rounding boundary).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wsiseg_tpu.ops.conv9 import conv9 as jax_conv9
from wsiseg_tpu.ops.conv9 import conv_chain as jax_chain
from wsiseg_tpu.ops.pallas_conv import conv3x3_small as jax_small
from wsiseg_tpu_torch.ops import conv9 as c9

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _mk(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _layers(rng, chans, relus):
    """numpy (kernel HWIO, scale | None, bias, relu) per layer."""
    out = []
    for ci, co, relu in zip(chans[:-1], chans[1:], relus):
        out.append((_mk(rng, 3, 3, ci, co, scale=1 / np.sqrt(9 * ci)),
                    rng.rand(co).astype(np.float32) + 0.5,
                    _mk(rng, co, scale=0.1), relu))
    return out


def _port_layers(layers, dtype):
    return [(*c9.prep_layer(torch.from_numpy(k), torch.from_numpy(s),
                            torch.from_numpy(b), dtype), relu)
            for k, s, b, relu in layers]


def _jax_layers(layers):
    return [(jnp.asarray(k), jnp.asarray(s), jnp.asarray(b), relu)
            for k, s, b, relu in layers]


def _np(t):
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("h,w,cin,cout,relu", [(19, 45, 8, 16, True),
                                              (13, 21, 40, 12, False)])
def test_conv9_ref_matches_pallas(dtype, h, w, cin, cout, relu):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(h)
    x = _mk(rng, h, w, cin)
    (k, s, b, _), = _layers(rng, [cin, cout], [relu])
    want = jax_conv9(jnp.asarray(x).astype(jdt), jnp.asarray(k),
                     jnp.asarray(s), jnp.asarray(b), relu=relu, br=8, wc=16,
                     out_dtype=jdt, interpret=True)
    wt, bt = c9.prep_layer(torch.from_numpy(k), torch.from_numpy(s),
                           torch.from_numpy(b), tdt)
    before = dict(c9.LAUNCHES)
    got = c9.conv9(torch.from_numpy(x).to(tdt), wt, bt, relu=relu,
                   out_dtype=tdt)
    assert c9.LAUNCHES == before          # CPU tensors take the plain path
    assert got.shape == (h, w, cout) and got.dtype == tdt
    tol = F32_TOL if dtype == "float32" else dict(atol=0.15, rtol=0.05)
    np.testing.assert_allclose(_np(got.float()), _np(want), **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chans,relus,dims", [
    ([8, 16], [True], (19, 45)),
    ([8, 16, 8], [True, True], (21, 41)),
    ([8, 16, 8, 4], [True, True, False], (21, 41)),
])
def test_conv_chain_ref_matches_pallas(dtype, chans, relus, dims):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(len(chans))
    x = _mk(rng, *dims, chans[0])
    layers = _layers(rng, chans, relus)
    want = jax_chain(jnp.asarray(x).astype(jdt), _jax_layers(layers), br=8,
                     wc=16, out_dtype=jnp.float32, interpret=True)
    got = c9.conv_chain(torch.from_numpy(x).to(tdt),
                        _port_layers(layers, tdt), out_dtype=torch.float32)
    assert got.shape == (*dims, chans[-1]) and got.dtype == torch.float32
    tol = F32_TOL if dtype == "float32" else dict(atol=0.25, rtol=0.05)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_conv_chain_ref_zeroes_borders_per_layer():
    """The chain equals its layers run one by one (each with its own zero
    padding); one unpadded chain over a zero-extended input would not."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(_mk(rng, 1, 11, 13, 8))
    layers = _port_layers(_layers(rng, [8, 8, 8], [True, True]),
                          torch.float32)
    chained = c9.conv_chain(x, layers, out_dtype=torch.float32)
    y = x
    for w, b, relu in layers:
        y = c9.conv9(y, w, b, relu=relu, out_dtype=torch.float32)
    torch.testing.assert_close(chained, y)
    big = torch.zeros(1, 15, 17, 8)
    big[:, 2:13, 2:15] = x
    no_rezero = c9.conv_chain(big, layers, out_dtype=torch.float32)
    assert not torch.allclose(no_rezero[:, 2:13, 2:15], chained)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conv3x3_small_ref_matches_pallas(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(3)
    x = _mk(rng, 21, 37, 16)
    k = _mk(rng, 3, 3, 16, 4, scale=0.1)
    b = _mk(rng, 4)
    want = jax_small(jnp.asarray(x).astype(jdt), jnp.asarray(k),
                     jnp.asarray(b), blk_h=8, blk_w=16, interpret=True)
    got = c9.conv3x3_small(torch.from_numpy(x).to(tdt), torch.from_numpy(k),
                           torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (21, 37, 4)
    tol = F32_TOL if dtype == "float32" else dict(atol=0.15, rtol=0.05)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_prep_layer_rounds_once():
    """kernel·scale in f32, rounded once to the target dtype, taps dy·3+dx
    on axis 1 and Cin last."""
    rng = np.random.RandomState(4)
    k = torch.from_numpy(_mk(rng, 3, 3, 5, 6))
    s = torch.from_numpy(rng.rand(6).astype(np.float32) + 0.5)
    w, b = c9.prep_layer(k, s, None, torch.bfloat16)
    assert w.shape == (6, 9, 5) and w.dtype == torch.bfloat16
    assert b.dtype == torch.float32 and not b.any()
    ref = (k * s).to(torch.bfloat16)
    for dy in range(3):
        for dx in range(3):
            assert torch.equal(w[:, 3 * dy + dx], ref[dy, dx].t())


@pytest.mark.parametrize("bad", ["dims", "layers", "device"])
def test_wrappers_reject(bad):
    x = torch.zeros(4, 5, 8)
    w, b = c9.prep_layer(torch.zeros(3, 3, 8, 8))
    with pytest.raises(ValueError):
        if bad == "dims":
            c9.conv9(torch.zeros(5, 8), w, b)
        elif bad == "layers":
            c9._launch_chain(x[None].bfloat16(), [(w, b, True)] * 4,
                             torch.bfloat16, "conv_chain_ref")
        else:
            c9.conv9(x.to("meta"), w.to("meta"), b.to("meta"))
