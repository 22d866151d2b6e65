"""The stem's cell form (wsiseg_tpu_torch/ops/stem.py: ``fold_stem_weights_cells``,
``stem_cells_ref``, ``plan_stem``; kernel ``csrc/stem_sm90.cu``) and the
plain versions of the stem probes (``wsiseg_tpu_torch.probes``), on the CPU.

- The cell-form weights against ``pallas_stem.fold_stem_weights2``.
- The plain cell-form forward against the P1 kernel itself
  (``scripts/exp_r6e.py::stem_pool_conv3``, stem v3) under
  ``force_tpu_interpret_mode()``, and against ``pallas_stem.stem_pool_conv``
  in interpret mode, on ``pack_image2``-style inputs: the JAX kernels emit
  bf16, the plain version f32 with the same bf16 weights, so they agree
  within half a bf16 ulp (rtol 2^-8) plus 1e-5·max|ref| for the f32 sum
  order.
- ``plan_stem`` covers every output cell and row exactly once.
- A model of the kernel's schedule — slab assembly in each of the three
  forms through the ring of input rows, the 21 k-steps in order, the
  fragment-level pool epilogue with its shuffles and segment halos —
  reproduces the plain version, and its three forms agree bit for bit.
- The P2c plain version against ``scripts/probe_retile.py::kernel`` through
  the same ``pl.pallas_call`` in interpret mode, and a fragment-level model
  of probe 6's shuffle and staged forms against it.

The kernels themselves are held against the plain versions in
tests/test_torch_cuda.py and ``chip_smoke.py``, on a machine with a card.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from wsiseg_tpu.models.infer_fast import pack_for_stem2
from wsiseg_tpu.ops.pallas_stem import (fold_stem_weights,
                                        fold_stem_weights2, stem_pool_conv)
from wsiseg_tpu_torch import probes
from wsiseg_tpu_torch.ops import stem

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
PAD = stem.pad_value(MEAN)


def _script(name):
    """``scripts/<name>.py`` as a module. The scripts point JAX's
    compilation cache at a directory of their own when imported; the
    settings are put back."""
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in keep.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def stem_vars():
    """Random stem weights and BN, as tests/test_torch_stem.py makes them."""
    r = np.random.RandomState(0)
    return dict(
        kernel=r.randn(7, 7, 3, 64).astype(np.float32) * 0.05,
        scale=r.rand(64).astype(np.float32) + 0.5,
        bias=r.randn(64).astype(np.float32) * 0.1,
        mean=r.randn(64).astype(np.float32) * 0.1,
        var=r.rand(64).astype(np.float32) + 0.5,
    )


def _jax_args(v):
    return [jnp.asarray(v[k]) for k in ("kernel", "scale", "bias", "mean",
                                        "var")]


def _jax_folds(v):
    """(w147 as (7, 7, 3, 64), bias (64,), w336, bias2) from the JAX folds."""
    w147, b = fold_stem_weights(*_jax_args(v), MEAN, STD)
    w336, b2 = fold_stem_weights2(*_jax_args(v), MEAN, STD)
    return (torch.from_numpy(np.asarray(w147)).reshape(7, 7, 3, 64),
            torch.from_numpy(np.asarray(b)[0]), np.asarray(w336),
            np.asarray(b2)[0])


def _bf16(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float32)


def test_cell_fold_matches_fold2_in_f32(stem_vars):
    """The scatter of the JAX fold's f32 taps is fold_stem_weights2's w336,
    bit for bit."""
    w147, _, w336, b2 = _jax_folds(stem_vars)
    got = stem.fold_stem_weights_cells(w147)
    assert got.dtype == torch.float32 and got.shape == (336, 128)
    np.testing.assert_array_equal(got.numpy(), w336)
    np.testing.assert_array_equal(b2[:64], b2[64:])


def test_cell_fold_from_bf16_fold(stem_vars):
    """From bf16 taps the scatter is exact: the bf16 rounding of JAX's
    w336; and the port's own bf16 fold lands there within its rounding."""
    w147, _, w336, _ = _jax_folds(stem_vars)
    got = stem.fold_stem_weights_cells(w147.to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _bf16(w336))
    wf, _ = stem.fold_stem_weights(
        torch.from_numpy(stem_vars["kernel"]).permute(3, 2, 0, 1),
        *(torch.from_numpy(stem_vars[k]) for k in ("scale", "bias", "mean",
                                                   "var")), MEAN, STD)
    own = stem.fold_stem_weights_cells(wf).float().numpy()
    np.testing.assert_allclose(own, _bf16(w336), rtol=2.0 ** -8, atol=0)
    assert not own[np.asarray(w336) == 0].any()


def test_cells_operand_layout(stem_vars):
    """The kernel's B operand: k-step ks, plane p, column n, value k is
    w336[16·ks + 8·p + k, n]."""
    w336 = torch.from_numpy(np.random.RandomState(1).randn(336, 128)
                            .astype(np.float32))
    op = stem.cells_operand(w336)
    assert op.shape == (21, 2, 128, 8) and op.is_contiguous()
    for ks, p, n, k in [(0, 0, 0, 0), (3, 1, 77, 5), (20, 1, 127, 7)]:
        assert op[ks, p, n, k] == w336[16 * ks + 8 * p + k, n]


def _jax_inputs(img, v):
    _, _, w336, b2 = _jax_folds(v)
    packed = np.pad(pack_for_stem2(img, MEAN), ((0, 0), (0, 4), (0, 0)))
    return jnp.asarray(packed), jnp.asarray(w336), jnp.asarray(b2[None])


def _port_cells(v):
    """f32 w336 holding the bf16 weights the JAX kernels use, and bias."""
    _, _, w336, b2 = _jax_folds(v)
    return torch.from_numpy(_bf16(w336)), torch.from_numpy(b2[:64].copy())


def _half_ulp_close(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2.0 ** -8,
                               atol=1e-5 * np.abs(ref).max())


@pytest.fixture(scope="module")
def exp_r6e():
    return _script("exp_r6e")


def test_plain_cells_match_stem_v3(stem_vars, exp_r6e):
    """stem_cells_ref against the P1 kernel (stem v3, block-wide patch
    assembly) at c1 16×240, run on the CPU in TPU interpret mode."""
    h, w = 32, 480
    img = np.random.RandomState(7).randint(0, 256, (h, w, 3)).astype(np.uint8)
    packed, w336, b2 = _jax_inputs(img, stem_vars)
    with pltpu.force_tpu_interpret_mode():
        ref_s2d, ref_pool = exp_r6e.stem_pool_conv3(packed, w336, b2,
                                                    h // 2, w // 2)
    wc, bias = _port_cells(stem_vars)
    s2d, pool = stem.stem_cells_ref(torch.from_numpy(img)[None], wc, bias,
                                    PAD, pool=True)
    assert s2d.shape == (1, h // 4, w // 4, 256) and s2d.dtype == wc.dtype
    _half_ulp_close(s2d[0], ref_s2d[:h // 4])
    _half_ulp_close(pool[0], ref_pool[:h // 4])


@pytest.mark.parametrize("hw", [(32, 128), (48, 256)])
def test_plain_cells_match_stem_v2(stem_vars, hw):
    """stem_cells_ref against pallas_stem.stem_pool_conv (interpret=True),
    and its native mode against stem_conv_ref."""
    h, w = hw
    img = np.random.RandomState(h).randint(0, 256, (h, w, 3)).astype(np.uint8)
    packed, w336, b2 = _jax_inputs(img, stem_vars)
    ref_s2d, ref_pool = stem_pool_conv(packed, w336, b2, h // 2, w // 2,
                                       interpret=True)
    wc, bias = _port_cells(stem_vars)
    x = torch.from_numpy(img)[None]
    s2d, pool = stem.stem_cells_ref(x, wc, bias, PAD, pool=True)
    _half_ulp_close(s2d[0], ref_s2d[:h // 4])
    _half_ulp_close(pool[0], ref_pool[:h // 4])
    w147, b, _, _ = _jax_folds(stem_vars)
    w147 = w147.to(torch.bfloat16).float()
    torch.testing.assert_close(stem.stem_cells_ref(x, wc, bias, PAD, False),
                               stem.stem_conv_ref(x, w147, b, PAD),
                               rtol=1e-5, atol=1e-5)


# (n, h, w, pool): the bench geometry at N = 1 and 4 in both modes, the
# cuda tests' shapes, and ragged ones (W/4 not a multiple of 63 or 64;
# W % 4 == 2 in native mode)
PLAN_SHAPES = [(1, 3072, 4096, True), (4, 3072, 4096, True),
               (1, 3072, 4096, False), (4, 3072, 4096, False),
               (1, 96, 256, True), (2, 100, 260, True), (1, 96, 256, False),
               (2, 100, 262, False), (1, 10, 26, False), (3, 8, 1000, True),
               (1, 2, 2, False)]


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=["x".join(map(str, s)) for s in PLAN_SHAPES])
def test_plan_covers_every_output_once(shape):
    n, h, w, pool = shape
    for form in stem.FORMS:
        p = stem.plan_stem(n, h, w, pool, form)
        assert 1 <= p.wgs <= stem.MAX_WGS
        assert p.smem_bytes + stem.STATIC_BYTES <= stem.MAX_SMEM
        assert p.grid * p.wgs >= p.units > (p.grid - 1) * p.wgs
        if pool:
            assert p.seg_rows % 2 == 0
        cover = np.zeros((n, p.rows, p.cells_out), np.int32)
        for u in range(p.units):
            nb, c0, y_first, y_begin, y_end = p.unit(u)
            assert y_first == y_begin - (1 if pool and y_begin else 0)
            assert y_begin < y_end
            q0 = c0 + p.halo
            cover[nb, y_begin:y_end, max(q0, 0):c0 + stem.CELLS] += 1
        assert (cover == 1).all(), form


def test_plan_fills_the_card():
    """At the bench geometry every form's units fill whole waves of the
    H100's warpgroup slots within a few percent."""
    for form in stem.FORMS:
        p = stem.plan_stem(1, 3072, 4096, True, form)
        slots = stem.H100_SMS * p.wgs
        assert p.units / (-(-p.units // slots) * slots) > 0.9


# ---- a model of csrc/stem_sm90.cu's schedule ------------------------------

def _load_cells(img, nb, iy, cs):
    """load_cell: cells ``cs`` of image row iy (columns 4c - 3 ... 4c,
    value 3·pixel + channel, pad outside the image), (len(cs), 16) f32."""
    n, h, w, _ = img.shape
    out = np.zeros((len(cs), 16), np.float32)
    for px in range(4):
        x = 4 * cs - 3 + px
        ok = (x >= 0) & (x < w) & (0 <= iy < h)
        vals = img[nb, min(max(iy, 0), h - 1), np.clip(x, 0, w - 1)]
        out[:, 3 * px:3 * px + 3] = np.where(ok[:, None], vals,
                                             np.asarray(PAD, np.float32))
    return out


def _fragments(a):
    """(64, N) → the m64nN accumulator fragments f[warp, lane, j, h, e] =
    a[16·warp + lane/4 + 8h, 8j + 2·(lane%4) + e]."""
    w, l, j, h, e = np.meshgrid(np.arange(4), np.arange(32),
                                np.arange(a.shape[1] // 8), np.arange(2),
                                np.arange(2), indexing="ij")
    rows, cols = 16 * w + l // 4 + 8 * h, 8 * j + 2 * (l % 4) + e
    return a[rows, cols], (rows, cols)


def _shift_fragments(o, carry):
    """The kernel's o[q - 1] on fragments o[warp, lane, j(8), h, e]: 4 lanes
    up (shfl_up) inside an 8-row group, lane + 28's h = 0 value (row 7) for
    row 8, the previous warp's lanes 28-31 h = 1 (row 15, through shared
    memory) for row 0, ``carry`` (warp 0's source) for warp 0."""
    lane = np.arange(32)
    up = o.copy()
    up[:, 4:] = o[:, :-4]                    # shfl_up: lanes < 4 keep theirs
    r7 = o[:, (lane + 28) % 32][..., 0, :]
    xw = o[:, 28:32, :, 1]                   # per warp, per lane % 4
    xv = np.concatenate([carry[None], xw[:-1]])[:, lane % 4]
    first = (lane // 4 == 0)[None, :, None, None]
    prev = up.copy()
    prev[..., 0, :] = np.where(first, xv, up[..., 0, :])
    prev[..., 1, :] = np.where(first, r7, up[..., 1, :])
    return prev


def _unfrag(f, where, shape):
    out = np.full(shape, np.nan, np.float32)
    out[where] = f
    return out


def _pool_row(r, c0):
    """The pool epilogue on the row max r (64 cells, 128): parity max and
    the one-cell shift on fragments; M row 0's odd half is masked to zero
    when it lies left of the image (c0 < 0)."""
    if c0 < 0:
        r = r.copy()
        r[0, 64:] = 0
    f, _ = _fragments(r)
    e, o = f[:, :, :8], f[:, :, 8:]
    prev = _shift_fragments(o, np.zeros((4, 8, 2), np.float32))
    _, where = _fragments(np.zeros((64, 64), np.float32))
    return _unfrag(np.maximum(np.maximum(e, o), prev), where, (64, 64))


def _model(img, w336, bias, pool, form, sms):
    """csrc/stem_sm90.cu on the CPU, unit by unit, in f32."""
    n, h, w, _ = img.shape
    p = stem.plan_stem(n, h, w, pool, form, sms)
    b_op = stem.cells_operand(torch.from_numpy(w336))
    # the B tile of k-step ks, (16 K values, 128 columns)
    bks = [b_op[ks].permute(0, 2, 1).reshape(16, 128) for ks in range(21)]
    b128 = np.concatenate([bias, bias])
    if pool:
        out = [np.full((n, h // 4, w // 4, 256), np.nan, np.float32),
               np.full((n, h // 4, w // 4, 64), np.nan, np.float32)]
    else:
        out = [np.full((n, h // 2, w // 2, 64), np.nan, np.float32)]
    for u in range(p.units):
        nb, c0, y_first, y_begin, y_end = p.unit(u)
        # the ring of input rows, unwritten entries NaN
        ring = np.full((stem.RING, 3, 64, 16) if form == "block"
                       else (stem.RING, 66, 16), np.nan, np.float32)

        def assemble_rows(pr0, nr):
            for pr in range(pr0, pr0 + nr):
                cells = _load_cells(img, nb, pr - 3, c0 + np.arange(66))
                if form == "block":
                    for s in range(3):
                        ring[pr % stem.RING, s] = cells[s:s + 64]
                else:
                    ring[pr % stem.RING] = cells

        if form != "per_row":
            assemble_rows(2 * y_first, 7)
        carry = np.zeros((64, 128), np.float32)
        for y in range(y_first, y_end):
            acc = torch.zeros(64, 128)
            for ks in range(21):
                ky, s = divmod(ks, 3)
                slot = (2 * y + ky) % stem.RING
                if form == "per_row":
                    a = _load_cells(img, nb, 2 * y + ky - 3,
                                    c0 + s + np.arange(64))
                elif form == "block":
                    a = ring[slot, s]
                else:
                    a = ring[slot, s:s + 64]
                acc = acc + torch.from_numpy(a) @ bks[ks]
            if form != "per_row" and y + 1 < y_end:
                assemble_rows(2 * y + 7, 2)
            v = acc.numpy() + b128
            v = np.where(v > 0, v, 0).astype(np.float32)
            if pool and y % 2:
                carry = np.maximum(carry, v)
            if y >= y_begin:
                for m in range(p.halo, 64):
                    q = c0 + m
                    if q >= p.cells_out:
                        continue
                    if pool:
                        out[0][nb, y // 2, q, 128 * (y % 2):128 * (y % 2)
                               + 128] = v[m]
                    else:
                        cols = min(2, w // 2 - 2 * q)
                        out[0][nb, y, 2 * q:2 * q + cols] = \
                            v[m].reshape(2, 64)[:cols]
            if pool:
                if y % 2:
                    if y >= y_begin:
                        pr = _pool_row(carry, c0)
                        for m in range(1, 64):
                            if c0 + m < p.cells_out:
                                out[1][nb, y // 2, c0 + m] = pr[m]
                    carry = v
                else:
                    carry = np.maximum(carry, v)
    return [torch.from_numpy(o) for o in out]


# (n, h, w, pool): two strips (ragged), several segments with the small
# ``sms`` the model is planned for; native with W % 4 == 2
MODEL_SHAPES = [(1, 40, 264, True), (2, 24, 100, True), (1, 18, 262, False),
                (2, 12, 36, False)]


@pytest.mark.parametrize("shape", MODEL_SHAPES,
                         ids=["x".join(map(str, s)) for s in MODEL_SHAPES])
def test_schedule_model_reproduces_plain(stem_vars, shape):
    n, h, w, pool = shape
    img = np.random.RandomState(w).randint(0, 256, (n, h, w, 3)).astype(
        np.uint8)
    wc, bias = _port_cells(stem_vars)
    want = stem.stem_cells_ref(torch.from_numpy(img), wc, bias, PAD, pool)
    want = list(want) if pool else [want]
    got = {}
    for form in stem.FORMS:
        p = stem.plan_stem(n, h, w, pool, form, sms=2)
        assert p.segs > 1
        got[form] = _model(img, wc.numpy(), bias.numpy(), pool, form, 2)
    for form, outs in got.items():
        for g, ref, r in zip(outs, got["per_row"], want):
            assert not g.isnan().any(), form      # every output written
            assert torch.equal(g, ref), form      # bit for bit across forms
            torch.testing.assert_close(g, r, rtol=1e-5,
                                       atol=1e-5 * r.abs().max().item())


# ---- P2c: the pool epilogue probe ----------------------------------------

@pytest.fixture(scope="module")
def probe_retile():
    return _script("probe_retile")


def test_pool_probe_plain_matches_probe_retile(probe_retile):
    """probe_pool_epilogue_ref (shift 0) against probe_retile's kernel
    through the probe's own pl.pallas_call, in interpret mode, on its
    (128, 128) shape."""
    r = np.random.RandomState(0)
    x = jnp.asarray(r.rand(128, 128).astype(np.float32)).astype(jnp.bfloat16)
    m = jnp.ones((128, 1), jnp.bfloat16).at[0].set(0)
    o, p = pl.pallas_call(
        probe_retile.kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=(pl.BlockSpec(memory_space=pltpu.VMEM),
                   pl.BlockSpec(memory_space=pltpu.VMEM)),
        out_shape=(jax.ShapeDtypeStruct((128, 128), jnp.bfloat16),
                   jax.ShapeDtypeStruct((128, 64), jnp.bfloat16)),
        interpret=True,
    )(x, m)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    mt = torch.from_numpy(np.asarray(m, np.float32)[:, 0]).to(torch.bfloat16)
    go, gp = probes.probe_pool_epilogue_ref(xt[None], mt, 0)
    assert go.dtype == gp.dtype == torch.bfloat16
    assert torch.equal(go[0].float(), torch.from_numpy(np.asarray(o,
                                                                  np.float32)))
    assert torch.equal(gp[0].float(), torch.from_numpy(np.asarray(p,
                                                                  np.float32)))


def _probe6_model(x, m, staged):
    """probe 6's kernel (shift 1) on the CPU: per row, 64-cell tiles in
    turn, o of the cell before by the fragment shuffles with the previous
    tile's cell 63 carried (or by a staged o row)."""
    xs = x.float().numpy()
    mf = m.float().numpy()
    rows, cells, _ = xs.shape
    p = np.zeros((rows, cells, 64), np.float32)
    for r in range(rows):
        carry = np.zeros((4, 8, 2), np.float32)      # per lane % 4, j, e
        last = np.zeros(64, np.float32)
        for q0 in range(0, cells, 64):
            f, where = _fragments(xs[r, q0:q0 + 64])
            e, o = f[:, :, :8], f[:, :, 8:]
            if staged:
                ost = np.concatenate([last[None], xs[r, q0:q0 + 64, 64:]])
                prev, _ = _fragments(np.concatenate([ost[:64]] * 2, 1))
                prev = prev[:, :, :8]
            else:
                prev = _shift_fragments(o, carry)
                carry = o[3, 28:32, :, 1]
            last = xs[r, q0 + 63, 64:]
            mq, _ = _fragments(np.repeat(mf[q0:q0 + 64, None], 128, 1))
            pm = torch.from_numpy(prev * mq[:, :, :8]).to(torch.bfloat16)
            res = np.maximum(np.maximum(pm.float().numpy(), e), o)
            _, w64 = _fragments(np.zeros((64, 64), np.float32))
            p[r, q0:q0 + 64] = _unfrag(res, w64, (64, 64))
    return torch.from_numpy(p).to(torch.bfloat16)


@pytest.mark.parametrize("staged", [False, True])
def test_pool_probe_model_matches_plain(staged):
    r = np.random.RandomState(3)
    x = torch.from_numpy(r.rand(2, 192, 128).astype(np.float32)).to(
        torch.bfloat16)
    m = torch.from_numpy((r.rand(192) > 0.2).astype(np.float32)).to(
        torch.bfloat16)
    m[0] = 0
    o, p = probes.probe_pool_epilogue_ref(x, m, 1)
    assert torch.equal(o, x)
    assert torch.equal(_probe6_model(x, m, staged), p)
