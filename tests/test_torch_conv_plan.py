"""The tile plan of the TMA/wgmma conv (wsiseg_tpu_torch/ops/conv9.py,
``plan_conv9``; kernel ``csrc/conv3x3_sm90.cu``), on the CPU.

The kernel runs only on the card; what surrounds it is checked here: for
every fold-route layer at the bench geometry (a 3072×4096 level-2 slide),
the K5 head shape and the shapes of the ``cuda`` tests, the tiles cover
the image, K runs 9·⌈Cin/64⌉ steps and a block's shared memory fits the
H100's 232 448 bytes. On the small shapes a model of the kernel's schedule
(per tile, per 64-channel chunk, the plan's zero-filled x box, nine taps)
reproduces the plain conv, so the boxes read every input pixel the conv
needs. The channel-padding copy (Cin % 8 ≠ 0) is checked against the
unpadded conv. The kernel itself is held against the plain version in
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wsiseg_tpu_torch.ops import conv9 as c9

torch.set_num_threads(2)

# (n, h, w, cin, cout): the 11 fold layers at the bench geometry (N = 1
# and the serve's N = 2), the K5 head, the cuda tests' shapes
FOLD = [(192, 256, 768, 256), (192, 256, 256, 256), (384, 512, 384, 128),
        (384, 512, 128, 128), (384, 512, 384, 256), (384, 512, 256, 256),
        (768, 1024, 320, 128), (768, 1024, 128, 128), (1536, 2048, 32, 64),
        (1536, 2048, 64, 64), (1536, 2048, 64, 16)]
SHAPES = ([(1, *s) for s in FOLD] + [(2, *s) for s in FOLD]
          + [(1, 1664, 2176, 64, 16)]
          + [(1, 37, 45, 8, 16), (2, 19, 45, 40, 70), (1, 10, 17, 3, 5),
             (1, 384, 512, 384, 256), (1, 64, 200, 64, 16),
             (1, 96, 300, 32, 64), (1, 33, 333, 64, 64), (1, 1, 77, 16, 32),
             (2, 192, 256, 768, 256), (1, 208, 272, 64, 16),
             (1, 13, 35, 32, 64)])
SMALL = [(1, 37, 45, 8, 16), (2, 19, 45, 40, 70), (1, 10, 17, 3, 5),
         (1, 1, 77, 16, 32), (1, 9, 200, 72, 24), (1, 5, 130, 136, 256),
         (2, 6, 70, 64, 130), (1, 3, 140, 16, 300)]


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_plan_covers_the_conv(shape):
    n, h, w, cin, cout = shape
    p = c9.plan_conv9(n, h, w, cin, cout)
    # tiles of 128 pixels (256 for BN = 128), strips on every fold layer,
    # cover the image
    assert p.tr * p.tc == (256 if p.bn == 128 else 128)
    assert p.tc in (64, 128)
    assert p.tiles_x * p.tc >= w > (p.tiles_x - 1) * p.tc
    assert p.tiles_y * p.tr >= h > (p.tiles_y - 1) * p.tr
    assert p.tiles == n * p.tiles_x * p.tiles_y * p.n_tiles
    if w % 128 == 0:
        assert p.tc == 128
    # N: the smallest wgmma width holding Cout, more tiles past 256
    assert p.bn in c9.N_TILES and p.n_tiles * p.bn >= cout
    assert p.bn == 256 or p.bn == 16 or p.bn // 2 < cout <= p.bn
    # K: 9 taps × ⌈Cin / 64⌉ chunks; the channel pad never adds a chunk
    assert p.cin_pad % 8 == 0 and 0 <= p.cin_pad - cin < 8
    assert p.k_steps == 9 * math.ceil(cin / 64)
    # the x box: the halo window for BN ≤ 64, one tap's tile otherwise
    halo = 2 if p.bn <= 64 else 0
    assert p.window == (p.bn <= 64)
    assert p.x_box == (1, p.tr + halo, p.tc + halo, 64)
    # shared memory: stages of 1024-byte multiples, under the H100's limit
    assert p.stage_bytes % 1024 == 0 and p.smem_bytes <= c9.MAX_SMEM
    assert 2 <= p.stages <= 8
    if p.bn <= 64:                       # two blocks share an SM
        assert 2 * (p.smem_bytes + 1024) <= 233472


def _schedule(x, wt, bias, relu, p):
    """The kernel's schedule on the CPU: per tile and 64-channel chunk the
    plan's x box with TMA's zero fill (outside the image and past Cin),
    nine taps of (tr·tc × 64) · (64 × BN), f32 sums, + bias, ReLU,
    in-image pixels and channels < Cout stored."""
    n, h, w, cin = x.shape
    cout = wt.shape[0]
    kc = p.k_steps // 9
    # zero fill: one pixel before the image, enough after for every box
    hp, wp = p.tiles_y * p.tr + 2, p.tiles_x * p.tc + 2
    xz = torch.zeros(n, hp, wp, kc * 64)
    xz[:, 1:1 + h, 1:1 + w, :cin] = x.float()
    wz = torch.zeros(p.n_tiles * p.bn, 9, kc * 64)
    wz[:cout, :, :cin] = wt.float()
    out = torch.full((n, h, w, cout), float("nan"))
    for tile in range(p.tiles):
        spatial = tile % (n * p.tiles_x * p.tiles_y)
        x0 = spatial % p.tiles_x * p.tc
        y0 = spatial // p.tiles_x % p.tiles_y * p.tr
        nb = spatial // (p.tiles_x * p.tiles_y)
        n0 = tile // (n * p.tiles_x * p.tiles_y) * p.bn
        acc = torch.zeros(p.tr * p.tc, p.bn)
        for c in range(kc):
            # the window box at (x0 - 1, y0 - 1); a tap box is its shifted
            # sub-tile at (x0 + dx - 1, y0 + dy - 1)
            win = xz[nb, y0:y0 + p.tr + 2, x0:x0 + p.tc + 2,
                     64 * c:64 * c + 64]
            for t in range(9):
                dy, dx = divmod(t, 3)
                a = win[dy:dy + p.tr, dx:dx + p.tc].reshape(-1, 64)
                acc += a @ wz[n0:n0 + p.bn, t, 64 * c:64 * c + 64].t()
        acc = acc + F.pad(bias, (0, p.n_tiles * p.bn - cout))[n0:n0 + p.bn]
        if relu:
            acc = torch.relu(acc)
        acc = acc.view(p.tr, p.tc, p.bn)
        ys, xs = min(p.tr, h - y0), min(p.tc, w - x0)
        nc = min(p.bn, cout - n0)
        out[nb, y0:y0 + ys, x0:x0 + xs, n0:n0 + nc] = acc[:ys, :xs, :nc]
    return out


@pytest.mark.parametrize("shape", SMALL, ids=_ids(SMALL))
def test_plan_schedule_reproduces_conv(shape):
    n, h, w, cin, cout = shape
    r = np.random.RandomState(sum(shape))
    x = torch.from_numpy(r.randn(n, h, w, cin).astype(np.float32))
    k = torch.from_numpy(r.randn(3, 3, cin, cout).astype(np.float32)
                         / np.sqrt(9 * cin))
    b = torch.from_numpy(r.randn(cout).astype(np.float32))
    wt, bias = c9.prep_layer(k, None, b, torch.float32)
    p = c9.plan_conv9(n, h, w, cin, cout)
    got = _schedule(x, wt, bias, True, p)
    want = c9.conv9_ref(x, wt, bias, relu=True, out_dtype=torch.float32)
    assert not got.isnan().any()          # every output pixel written
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cin", [3, 5, 13, 40])
def test_channel_padding_copy(cin):
    r = np.random.RandomState(cin)
    x = torch.from_numpy(r.randn(2, 6, 9, cin).astype(np.float32)).bfloat16()
    k = torch.from_numpy(r.randn(3, 3, cin, 7).astype(np.float32))
    w, b = c9.prep_layer(k)
    p = c9.plan_conv9(2, 6, 9, cin, 7)
    before = c9.CHANNEL_PAD_COPIES
    xp, wp = c9.pad_channels(x, w, p.cin_pad)
    assert c9.CHANNEL_PAD_COPIES == before + 1
    assert p.cin_pad == 8 * math.ceil(cin / 8)
    assert xp.shape == (2, 6, 9, p.cin_pad) and wp.shape == (7, 9, p.cin_pad)
    assert xp.is_contiguous() and wp.is_contiguous()
    assert torch.equal(xp[..., :cin], x) and torch.equal(wp[..., :cin], w)
    assert not xp[..., cin:].any() and not wp[..., cin:].any()
    torch.testing.assert_close(
        c9.conv9_ref(xp, wp, b, out_dtype=torch.float32),
        c9.conv9_ref(x, w, b, out_dtype=torch.float32), rtol=0, atol=0)


def test_plan_rejects_empty():
    with pytest.raises(ValueError):
        c9.plan_conv9(1, 0, 16, 8, 8)
