"""The strip plan of the fused chain (wsiseg_tpu_torch/ops/conv9.py,
``plan_chain``; kernel ``csrc/conv_chain_sm90.cu``), on the CPU.

The kernel runs only on the card; what surrounds it is checked here: for
the five fold-route layer groups at the bench geometry (a 3072×4096 level-2
slide) at N = 1 and the serve's N = 2, the ragged chain of ``chip_smoke.py``
and the shapes of the ``cuda`` tests, the strips and segments cover every
output position once, a block's shared memory fits the H100's 232 448
bytes, and the plan reports its recompute factor. On small shapes a model
of the kernel's schedule — the tile walk, the steps and their lagging
layers, the layer-0 windows and the inner layers' ring rows in shared
memory written and read with the 128-byte swizzle's XOR through shifted
descriptors, every k16 step of a chunk (the channels past Cin must read
as zeros), the rows no output needs (not stored), the border zeroing and
the staging slots overwritten after each step — reproduces ``conv_chain_ref`` exactly in f32
(integer-valued inputs and weights, so no sum is rounded), across tile
seams, ragged edges and the image border. Shared memory starts as NaN, so
a needed output that reads a byte nothing wrote is caught.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from wsiseg_tpu_torch.ops import conv9 as c9

torch.set_num_threads(2)

# chip_smoke.py's FOLD_GROUPS and RAGGED_CHAIN: (H, W, channels)
GROUPS = {"block0": (192, 256, (768, 256, 256)),
          "block1": (384, 512, (384, 128, 128)),
          "block2": (384, 512, (384, 256, 256)),
          "block3": (768, 1024, (320, 128, 128)),
          "block4+head": (1536, 2048, (32, 64, 64, 16)),
          "ragged": (83, 131, (32, 64, 64, 16)),
          "cuda_small": (13, 35, (32, 64, 64)),
          "cuda_odd": (7, 19, (12, 20, 6, 10)),
          "cuda_320": (40, 150, (320, 128, 128))}
CASES = [(n, g) for g in GROUPS for n in (1, 2)]


def _cover(total, size, count):
    """Each index in [0, total) lies in exactly one of ``count`` ranges of
    ``size`` from multiples of ``size``."""
    hits = np.zeros(count * size, np.int64)
    for k in range(count):
        hits[k * size:(k + 1) * size] += 1
    return bool((hits[:total] == 1).all()) and count * size - total < size


@pytest.mark.parametrize("n,group", CASES, ids=[f"{g}-n{n}" for n, g in CASES])
def test_plan_chain_covers_the_chain(n, group):
    h, w, chans = GROUPS[group]
    p = c9.plan_chain(n, h, w, chans)
    L = len(chans) - 1
    assert p.layers == L and p.tc == 64 - 2 * L
    # the instantiation holds every channel count
    assert p.mt == c9.CHAIN_FORMS[(L, p.nm, p.nl)]
    assert p.nm >= max(chans[1:-1]) and p.nl >= chans[-1]
    assert p.cin_pad % 8 == 0 and 0 <= p.cin_pad - chans[0] < 8
    # strips of tc columns and segments of seg rows cover the image once
    assert _cover(w, p.tc, p.tiles_x) and _cover(h, p.seg, p.tiles_y)
    assert p.tiles == n * p.tiles_x * p.tiles_y
    # a tile's steps reach its last output row: the last layer computes
    # rows 1 + j·s - (L - 1) … of its window rows L … seg + L - 1
    last = 1 + (p.steps(p.seg) - 1) * p.s - (L - 1) + p.s - 1
    assert last >= p.seg + L - 1
    # shared memory: every region on the swizzle's 1024-byte period, under
    # the H100's limit
    assert p.smem_bytes <= c9.MAX_SMEM
    assert p.stage_bytes % 1024 == 0 and p.slot_bytes % 1024 == 0
    assert p.window_bytes % 1024 == 0
    assert 2 <= p.stages <= c9.CHAIN_MAX_STAGES and p.nwin in (1, 2)
    # the recompute factor: at least 1, and bounded on the fold groups
    assert p.recompute >= 1.0
    if group.startswith("block"):
        assert p.recompute < 1.6, p.recompute


def test_plan_chain_reports_the_fold_factors():
    factors = {g: c9.plan_chain(1, *GROUPS[g]).recompute
               for g in ("block1", "block2", "block3", "block4+head")}
    # tall segments: only the strip's 64-position pitch and a few halo
    # rows are recomputed on blocks 1-3; block4's C0 = 32 fills half of
    # each 64-channel k chunk with zeros
    assert all(1.1 < factors[g] < 1.25
               for g in ("block1", "block2", "block3")), factors
    assert 1.4 < factors["block4+head"] < 1.5, factors


@pytest.mark.parametrize("args", [
    (1, 0, 16, (8, 8, 8)),               # empty
    (1, 16, 16, (8, 0, 8)),
    (1, 16, 16, (8, 8)),                 # one layer: the single conv
    (1, 16, 16, (8, 8, 8, 8, 8)),        # four layers
    (1, 16, 16, (8, 512, 8)),            # inner width past 256
    (1, 16, 16, (8, 256, 256, 256)),     # two 256-wide rings do not fit
])
def test_plan_chain_rejects(args):
    with pytest.raises(ValueError):
        c9.plan_chain(*args)


# ---- a model of the kernel's schedule -----------------------------------

PITCH, PLANE = 64, 64 * 64 * 2


def _phys(addr, k):
    """Byte address of channel ``k`` (0..63) of the 128-byte row at
    ``addr`` in the 128-byte swizzle: 16-byte chunk k / 8 XOR address
    bits 7-9."""
    addr = np.asarray(addr)[..., None]
    k = np.asarray(k)
    return addr + (((k // 8) ^ ((addr >> 7) & 7)) * 16) + (k % 8) * 2


def _schedule(x, layers, p, out_dtype=torch.float32):
    """conv_chain_sm90.cu's schedule on the CPU, one block walking every
    tile; shared memory as 2-byte cells (f32 here), NaN until written."""
    n, h, w, _ = x.shape
    L, S, R = p.layers, p.s, p.ring_rows
    chans = p.chans
    ring0 = p.stages * p.stage_bytes
    win0 = ring0 + (L - 1) * R * p.slot_bytes
    smem = torch.full(((p.smem_bytes - 1024) // 2,), float("nan"))
    rows64, k64 = np.arange(PITCH), np.arange(64)
    out = torch.full((n, h, w, chans[-1]), float("nan"))
    # weights as the TMA boxes deliver them: zero past Cout and past Cin
    wz = []
    for l, (wl, _, _) in enumerate(layers):
        width = p.nl if l + 1 == L else p.nm
        kc = -(-chans[l] // 64)
        z = torch.zeros(width, 9, kc * 64)
        z[:wl.shape[0], :, :wl.shape[2]] = wl.float()
        wz.append(z)

    def read(addr):                      # a descriptor's 64 × 64 operand
        return smem[torch.from_numpy(_phys(addr + rows64 * 128, k64) // 2)]

    def slot(ring, u):
        return ring0 + ring * R * p.slot_bytes + (u + 4 * R) % R * p.slot_bytes

    g = 0
    for tile in range(p.tiles):
        per_image = p.tiles_x * p.tiles_y
        nb, r = divmod(tile, per_image)
        x0, y0 = r % p.tiles_x * p.tc, r // p.tiles_x * p.seg
        rows = min(p.seg, h - y0)
        for j in range(p.steps(rows)):
            for l in range(L):
                last = l + 1 == L
                width = p.nl if last else p.nm
                us = [1 + j * S - l + i for i in range(S)]   # WG-major rows
                need = [l + 1 <= u < rows + 2 * L - 1 - l for u in us]
                acc = [torch.zeros(PITCH, width) for _ in us]
                cin = chans[l]
                for c in range(-(-cin // 64)):
                    if l == 0:
                        # TMA: the window box, zero filled, swizzled
                        src = win0 + g % p.nwin * p.window_bytes
                        g += 1
                        box = torch.zeros(S + 2, PITCH, 64)
                        for i in range(S + 2):
                            yy = y0 - L + j * S + i
                            if not 0 <= yy < h:
                                continue
                            xs = np.arange(x0 - L, x0 - L + PITCH)
                            ok = (xs >= 0) & (xs < w)
                            cc = min(64, cin - 64 * c)
                            box[i, ok, :cc] = x[nb, yy, xs[ok],
                                                64 * c:64 * c + cc].float()
                        addr = src + np.arange((S + 2) * PITCH) * 128
                        smem[torch.from_numpy(_phys(addr, k64) // 2)] = \
                            box.reshape(-1, 64)
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        # every k16 step of the chunk: the channels past
                        # Cin must read as zeros, not as unwritten NaN
                        b = wz[l][:, tap, 64 * c:64 * c + 64]
                        for i, u in enumerate(us):
                            if not need[i]:
                                continue
                            if l == 0:
                                a = src + ((u - 1 + dy - j * S) * PITCH
                                           + dx) * 128
                            else:
                                a = slot(l - 1, u - 1 + dy) + c * PLANE \
                                    + dx * 128
                            acc[i] += read(a) @ b.t()
                wl, bl, relu = layers[l]
                cout = wl.shape[0]
                bias = torch.zeros(width)
                bias[:cout] = bl.float()
                for i, u in enumerate(us):
                    if not need[i]:
                        continue
                    v = acc[i] + bias
                    if relu:
                        v = torch.relu(v)
                    yy = y0 - L + u
                    if not last:
                        # zero outside the image; the planes' channels
                        # past NM read as zero
                        xx = x0 - L + l + 1 + np.arange(PITCH)
                        v[torch.from_numpy((xx < 0) | (xx >= w))] = 0
                        if not 0 <= yy < h:
                            v.zero_()
                        v = torch.cat([v, torch.zeros(PITCH, max(
                            0, 64 - width))], 1)
                        for pl in range(v.shape[1] // 64):
                            addr = slot(l, u) + pl * PLANE + rows64 * 128
                            smem[torch.from_numpy(_phys(addr, k64) // 2)] = \
                                v[:, 64 * pl:64 * pl + 64]
                        continue
                    m = np.arange(min(p.tc, w - x0))
                    out[nb, yy, x0 + m] = v[m, :cout].to(out_dtype).float()
                if last:
                    # the staging slots: overwritten, never read again
                    for wg in range(2):
                        a = slot(L - 2, j * S - L + 1 + wg * p.mt)
                        smem[a // 2:(a + p.slot_bytes) // 2] = float("nan")
    return out


def _int_layers(r, chans, last_relu):
    layers = []
    for i, (ci, co) in enumerate(zip(chans[:-1], chans[1:])):
        k = torch.from_numpy(r.randint(-1, 2, (3, 3, ci, co)).astype(
            np.float32))
        b = torch.from_numpy(r.randint(-3, 4, co).astype(np.float32))
        wt, bias = c9.prep_layer(k, None, b, torch.float32)
        layers.append((wt, bias, last_relu or i + 2 < len(chans)))
    return layers


SCHEDULE = [  # (n, h, w, chans, seg or None for the plan's, last ReLU)
    (1, 9, 70, (12, 20, 6, 10), 4, False),       # L = 3, NM 64 holds 20
    (2, 11, 130, (32, 64, 64, 16), 5, False),    # the head group's form
    (1, 13, 61, (16, 64, 64), 3, True),          # one column past a strip
    (1, 10, 50, (24, 128, 128), 4, True),        # NM 128, MT 2
    (1, 7, 40, (8, 256, 256), 3, True),          # NM 256, MT 1
    (2, 6, 33, (40, 128, 16), None, False),      # NL rounded up to NM
    (1, 9, 60, (8, 128, 64, 32), 2, True),       # L = 3, NM 128, MT 1
    (1, 5, 20, (72, 64, 64), None, True),        # two layer-0 chunks
    (2, 4, 7, (16, 32, 32), 1, False),           # seg 1, narrow image
    (1, 8, 30, (16, 64, 16), None, True),        # L = 2, NL 16 → 64
]


@pytest.mark.parametrize("case", SCHEDULE,
                         ids=[f"{c[0]}x{c[1]}x{c[2]}-{'-'.join(map(str, c[3]))}"
                              for c in SCHEDULE])
def test_chain_schedule_reproduces_ref(case):
    n, h, w, chans, seg, last_relu = case
    r = np.random.RandomState(sum(chans) + h)
    x = torch.from_numpy(r.randint(-2, 3, (n, h, w, chans[0])).astype(
        np.float32))
    layers = _int_layers(r, chans, last_relu)
    p = c9.plan_chain(n, h, w, chans)
    if seg is not None:
        p = replace(p, seg=seg)
    got = _schedule(x, layers, p)
    want = c9.conv_chain_ref(x, layers, out_dtype=torch.float32)
    assert not got.isnan().any()          # every output written, no NaN read
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the chain is not the zero map: the check has teeth
    assert want.abs().max() > 0


def test_schedule_model_catches_a_missing_border_zero():
    """The model fails when the inner epilogue leaves out-of-image
    positions unzeroed, the fault that only shows at the border."""
    n, h, w, chans = 1, 6, 20, (8, 16, 16)
    r = np.random.RandomState(3)
    x = torch.from_numpy(r.randint(-2, 3, (n, h, w, 8)).astype(np.float32))
    layers = _int_layers(r, chans, True)
    # a bias that survives ReLU: unzeroed border positions would be > 0
    layers[0] = (layers[0][0], layers[0][1].abs() + 5, True)
    want = c9.conv_chain_ref(x, layers, out_dtype=torch.float32)
    big = torch.zeros(n, h + 4, w + 4, 8)
    big[:, 2:2 + h, 2:2 + w] = x
    unzeroed = c9.conv_chain_ref(big, layers, out_dtype=torch.float32)
    assert not torch.equal(unzeroed[:, 2:2 + h, 2:2 + w], want)
    got = _schedule(x, layers, c9.plan_chain(n, h, w, chans))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
