"""The FLOP and K1 byte counts against hand arithmetic."""

from __future__ import annotations

from portbench.harness import flops, roofline

R18 = {"arch_encoder": "resnet18", "model_name": "Unet", "num_classes": 4}
R50 = {"arch_encoder": "resnet50", "model_name": "FPN", "num_classes": 4}


def r18_unet_macs(h, w):
    """ResNet-18 + smp Unet (256, 128, 64, 32, 16) + 3×3 head, by hand."""
    mac = (h // 2) * (w // 2) * 49 * 3 * 64
    cin = 64
    for i in range(4):
        p, hw = 64 * 2 ** i, (h // 4 >> i) * (w // 4 >> i)
        mac += hw * 9 * (cin * p + p * p) + hw * 9 * (p * p + p * p)
        if i > 0:
            mac += hw * cin * p
        cin = p
    x = 512
    for i, (c, s) in enumerate(zip((256, 128, 64, 32, 16),
                                   (256, 128, 64, 64, 0))):
        hw = (h >> (4 - i)) * (w >> (4 - i))
        mac += hw * 9 * ((x + s) * c + c * c)
        x = c
    return mac + h * w * 9 * 16 * 4


def test_r18_unet_forward_flops():
    for h, w in ((256, 256), (3072, 4096)):
        assert flops.forward_flops(R18, 1, h, w) == 2 * r18_unet_macs(h, w)
    assert flops.forward_flops(R18, 4, 256, 256) == \
        4 * flops.forward_flops(R18, 1, 256, 256)


def test_heads_add_the_linears():
    extra = 512 * 4 + 512 * 128 + 128 * 1
    assert flops.forward_flops(R18, 1, 512, 512, heads=True) - \
        flops.forward_flops(R18, 1, 512, 512) == 2 * extra


def test_fpn_head_and_laterals():
    """FPN at 256²: the encoder's Bottleneck count by hand plus the
    laterals, segmentation blocks and the 1×1 head."""
    h = w = 256
    mac = (h // 2) * (w // 2) * 49 * 3 * 64
    cin = 64
    for i, n in enumerate((3, 4, 6, 3)):
        p, out = 64 * 2 ** i, 256 * 2 ** i
        hw_in, hw = (h // 4 >> max(i - 1, 0)) * (w // 4 >> max(i - 1, 0)), \
            (h // 4 >> i) * (w // 4 >> i)
        for j in range(n):
            first = j == 0
            mac += (hw_in if first else hw) * cin * p      # 1×1 reduce
            mac += hw * 9 * p * p + hw * p * out            # 3×3, expand
            if first:
                mac += hw * cin * out                       # projection
            cin = out
    for lvl, c in ((5, 2048), (4, 1024), (3, 512), (2, 256)):
        hw = (h >> lvl) * (w >> lvl)
        mac += hw * c * 256
        s, ch = lvl, 256
        for k in range(max(lvl - 2, 1)):
            mac += (h >> s) * (w >> s) * 9 * ch * 128
            ch = 128
            if k < lvl - 2:
                s -= 1
    mac += (h // 4) * (w // 4) * 128 * 4
    assert flops.forward_flops(R50, 1, h, w) == 2 * mac


def test_k1_bytes_by_hand():
    h, w = 3072, 4096
    ops, nbytes = roofline.stem_cost(h, w)
    c1 = 1536 * 2048 * 64 * 2
    assert nbytes == h * w * 3 + c1 + c1 // 4 + 147 * 64 * 2 + 256
    assert ops == 2 * 1536 * 2048 * 147 * 64
    t = roofline.bound_s(ops, nbytes, 989e12)
    assert abs(t - nbytes / 3.35e12) < 1e-12     # bytes bound it
    assert abs(t * 1e3 - 0.16148) < 1e-4


def test_peak_table():
    assert roofline.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert roofline.peak_flops("NVIDIA A100-SXM4-80GB") is None
