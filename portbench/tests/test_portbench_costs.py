"""The yardstick's operations and bytes against hand-worked shapes."""

import pytest

from portbench import core, roofline


def test_gemm_and_conv_costs_by_hand():
    # [4, 8] @ [8, 16], bf16 in and out, f32 scale and bias a column
    assert roofline.gemm_cost(4, 8, 16) == (2 * 32 + 2 * 128 + 8 * 16 + 2 * 64, 2.0 * 4 * 16 * 8)
    # 3x3 conv, 10 outputs of 16 channels from 40 inputs of 8 channels
    b, ops = roofline.conv3x3_cost(10, 8, 16, 40)
    assert ops == 2.0 * 10 * 9 * 8 * 16
    assert b == 2 * 40 * 8 + 2 * 9 * 8 * 16 + 8 * 16 + 2 * 10 * 16
    assert roofline.conv3x3_cost(10, 8, 16, 40, affine=False)[0] == b - 8 * 16


def test_bound_is_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert roofline.bound_s(0.0, 989e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)


def test_calib_bytes_epix10k2m_batch_32_uint16():
    p, h, w = 16, 352, 384
    nbytes, ops = roofline.calib_cost(32, (p, h, w), 2, 2)
    assert nbytes == 32 * p * h * w * 4 + p * h * w * 9
    assert ops == 7.0 * 32 * p * h * w
    # 0.0884 ms at 3.35 TB/s: bytes bound it
    bound_ms = roofline.bound_s(nbytes, ops, roofline.F32_OPS_PER_S) * 1e3
    assert bound_ms == pytest.approx(0.08844, rel=1e-3)


def test_unet_encoder_levels_of_one_sfx_batch(bench):
    c = core.Cell(bench, "sfx_b8")
    k4 = c.module.costs(c.config, c.traffic)["unet_conv"]
    assert len(k4) == 8  # levels 1 and 2: conv, conv, down; the bottleneck: conv, conv
    rows = 8 * 16
    by_hand = 0.0
    for cin, f, h, w, down in ((64, 128, 88, 96, True), (128, 256, 44, 48, True),
                               (256, 512, 22, 24, False)):
        by_hand += 2 * 9 * cin * f * rows * h * w + 2 * 9 * f * f * rows * h * w
        if down:
            by_hand += 2 * 9 * f * f * rows * (h // 2) * (w // 2)
    assert sum(o for _, o in k4) == by_hand
    assert roofline.bound_sum_s(k4) * 1e3 == pytest.approx(1.635, rel=1e-3)


def test_peaknet_tpu_flops_by_hand(bench):
    c = core.Cell(bench, "sfx_b8")
    per_panel = 0.0
    hw = [176 * 192 >> (2 * i) for i in range(4)]  # 176 x 192 after space-to-depth
    f = [64, 128, 256, 512]
    cin = 4
    for i in range(4):  # each level's two convs, and the downsample
        per_panel += 2 * 9 * hw[i] * (cin * f[i] + f[i] * f[i])
        if i < 3:
            per_panel += 2 * 9 * hw[i + 1] * f[i] * f[i]
        cin = f[i]
    for i in (2, 1, 0):  # up conv, merge_up, merge_skip, conv
        per_panel += 2 * 9 * hw[i] * (f[i + 1] * f[i] + 3 * f[i] * f[i])
    per_panel += 2 * hw[0] * 64 * 4  # the head
    assert c.module.flops_per_batch(c.config, c.traffic) == pytest.approx(8 * 16 * per_panel)
    assert c.module.flops_per_batch(c.config, c.traffic) / 8 == pytest.approx(0.8498e12, rel=1e-3)


def test_resnet50_flops_at_imagenet_shape_is_the_published_4_1_gmac(bench):
    c = core.Cell(bench, "resnet_b32")
    cfg = core.merged(c.config, {"in_channels": 3, "num_classes": 1000, "input_hw": [224, 224]})
    macs = c.module.flops_per_batch(cfg, {"batch": 1}) / 2
    assert macs == pytest.approx(4.1e9, rel=0.01)  # He et al. 2016, Table 1: 4.1 x 10^9


def test_resnet50_bottleneck_launches_of_one_batch(bench):
    c = core.Cell(bench, "resnet_b32")
    k23 = c.module.costs(c.config, c.traffic)["resnet_conv"]
    assert len(k23) == 3 * 16
    # the first block's front: [32 * 88 * 96, 64] @ [64, 64]
    assert k23[0] == roofline.gemm_cost(32 * 88 * 96, 64, 64)
    # K2 and K3 bound at 1.345 ms a batch (chip_smoke's bottleneck table)
    assert roofline.bound_sum_s(k23) * 1e3 == pytest.approx(1.3446, rel=1e-3)
