"""The shape gates of the wgmma kernels and the K-major weight packing, on
the CPU.

``back_kernel`` (K3) and ``conv3x3_sm90_kernel`` (K4) take channel counts
that are multiples of 64 (one 128-byte swizzle row of bf16) and output
widths that are multiples of 128; a CUDA tensor outside the gate raises
before any launch. The gates are pure functions of shapes, so they are
held here to the cases the kernels take and refuse. The packing tests
check that the K-major layouts the kernels read, put back through the
plain versions, give the HWIO / ``[K, N]`` results exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from psana_ray_tpu_torch.models import fused_resnet as fr  # noqa: E402
from psana_ray_tpu_torch.models import fused_unet as fu  # noqa: E402


@pytest.mark.parametrize(
    "x_shape,n,stride",
    [
        ((1, 8, 16, 64), 128, 1),       # one 128-pixel tile
        ((3, 10, 14, 64), 256, 2),      # ragged, stride 2 on even extents
        ((128, 22, 24, 256), 512, 1),   # the SFX bottleneck level
        ((128, 88, 96, 64), 128, 1),    # SFX level 1
        ((2, 22, 24, 512), 128, 1),     # K = 9 * 512 = 4608
    ],
)
def test_level_conv_gate_takes(x_shape, n, stride):
    fu.level_conv_gate(x_shape, n, stride)


@pytest.mark.parametrize(
    "x_shape,n,stride,match",
    [
        ((1, 8, 8, 32), 128, 1, "Cin % 64"),     # narrow input channels
        ((1, 8, 8, 96), 128, 1, "Cin % 64"),
        ((1, 8, 8, 64), 64, 1, "N % 128"),       # narrow output
        ((1, 8, 8, 64), 192, 1, "N % 128"),
        ((1, 7, 8, 64), 128, 2, "even"),         # odd extent at stride 2
        ((1, 8, 8, 64), 128, 3, "stride"),
        ((1, 8, 8), 128, 1, r"\[B, h, w, cin\]"),
        ((0, 8, 8, 64), 128, 1, "output pixels"),
    ],
)
def test_level_conv_gate_refuses(x_shape, n, stride, match):
    with pytest.raises(ValueError, match=match):
        fu.level_conv_gate(x_shape, n, stride)


@pytest.mark.parametrize(
    "y2_shape,n,res_shape,proj_shape,stride",
    [
        ((1, 8, 16, 64), 128, (1, 8, 16, 128), None, 1),     # one tile, identity
        ((32, 88, 96, 64), 256, (32, 88, 96, 256), None, 1),  # stage 1 identity
        ((32, 88, 96, 64), 256, None, (32, 88, 96, 64), 1),   # stage 1 projection
        ((32, 11, 12, 512), 2048, None, (32, 22, 24, 1024), 2),  # stage 4 projection
        ((2, 11, 12, 4608), 128, (2, 11, 12, 128), None, 1),  # K = 4608
    ],
)
def test_back_gate_takes(y2_shape, n, res_shape, proj_shape, stride):
    fr.back_gate(y2_shape, n, res_shape, proj_shape, stride)


@pytest.mark.parametrize(
    "y2_shape,n,res_shape,proj_shape,stride,match",
    [
        ((1, 8, 8, 32), 128, (1, 8, 8, 128), None, 1, "Cin % 64"),
        ((1, 8, 8, 64), 64, (1, 8, 8, 64), None, 1, "N % 128"),
        ((1, 8, 8, 64), 128, None, None, 1, "exactly one"),
        ((1, 8, 8, 64), 128, (1, 8, 8, 128), (1, 8, 8, 64), 1, "exactly one"),
        ((1, 8, 8, 64), 128, (1, 8, 8, 256), None, 1, "identity residual"),
        ((1, 8, 8, 64), 128, None, (1, 16, 16, 32), 2, "Cin % 64"),
        ((1, 8, 8, 64), 128, None, (1, 15, 16, 64), 2, "output grid"),
        ((1, 8, 8, 64), 128, None, (1, 24, 24, 64), 3, "stride"),
    ],
)
def test_back_gate_refuses(y2_shape, n, res_shape, proj_shape, stride, match):
    with pytest.raises(ValueError, match=match):
        fr.back_gate(y2_shape, n, res_shape, proj_shape, stride)


def test_pack_conv3x3_is_k_major_hwio():
    """``wt[n, (dy*3 + dx)*cin + c] == w[dy, dx, c, n]``."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(3, 3, 5, 7)).astype(np.float32))
    wt = fu.pack_conv3x3(w)
    assert wt.dtype == torch.bfloat16 and tuple(wt.shape) == (7, 45) and wt.is_contiguous()
    for dy, dx, c, n in ((0, 0, 0, 0), (2, 1, 4, 6), (1, 2, 3, 5)):
        assert wt[n, (dy * 3 + dx) * 5 + c] == w[dy, dx, c, n].to(torch.bfloat16)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("affine", [True, False])
def test_level_conv_plain_reads_packed_weights(stride, affine):
    """The plain version on K-major weights equals the HWIO plain versions."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 6, 8, 4)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=(3, 3, 4, 8)) / 6).astype(np.float32))
    s = torch.from_numpy(rng.uniform(0.5, 1.5, 8).astype(np.float32)) if affine else None
    b = torch.from_numpy(rng.normal(size=8).astype(np.float32)) if affine else None
    got = fu.level_conv_plain(x, fu.pack_conv3x3(w), s, b, stride)
    if affine:
        want = fr.conv3x3_plain(x, fu._gemm(w), s, b, stride)
    else:
        acc = fr._conv_f32(x, fu._gemm(w), 3, stride, fr._pads3x3(stride))
        want = acc.to(torch.bfloat16).permute(0, 2, 3, 1)
        if stride == 2:
            torch.testing.assert_close(want, fu.downsample_plain(x, w), rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_conv_block_on_packed_weights_matches_hwio_level():
    """:func:`conv_block` on :func:`pack_conv3x3` weights (the CPU path of
    ``peaknet_tpu_fused_infer``) equals the HWIO plain level."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 8, 8, 4)).astype(np.float32)).to(torch.bfloat16)
    ws = [torch.from_numpy((rng.normal(size=(3, 3, ci, 8)) / 6).astype(np.float32))
          for ci in (4, 8, 8)]
    a = [(torch.from_numpy(rng.uniform(0.5, 1.5, 8).astype(np.float32)),
          torch.from_numpy(rng.normal(size=8).astype(np.float32))) for _ in range(2)]
    lvl = fu.LevelWeights(fu.pack_conv3x3(ws[0]), a[0], fu.pack_conv3x3(ws[1]), a[1],
                          fu.pack_conv3x3(ws[2]))
    skip, dn = fu.conv_block(x, lvl)
    ref_skip, ref_dn = fu.fused_conv_block_plain(x, ws[0], a[0], ws[1], a[1], ws[2])
    torch.testing.assert_close(skip, ref_skip, rtol=0, atol=0)
    torch.testing.assert_close(dn, ref_dn, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["identity", "proj1", "proj2"])
def test_back_step_plain_reads_k_major_weights(mode):
    """``back_step_plain`` on K-major ``[N, K]`` weights equals
    ``conv1x1_plain`` on the ``[K, N]`` matrices."""
    rng = np.random.default_rng(3)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))

    y2 = t(2, 4, 6, 8).to(torch.bfloat16)
    w3 = t(16, 8, scale=0.3).to(torch.bfloat16)
    s3, b3 = 1.0 + 0.1 * t(16), 0.1 * t(16)
    kw, kw_ref = {}, {}
    if mode == "identity":
        kw["residual"] = kw_ref["residual"] = t(2, 4, 6, 16).to(torch.bfloat16)
    else:
        stride = int(mode[-1])
        x = t(2, 4 * stride, 6 * stride, 12).to(torch.bfloat16)
        wp, sp, bp = t(16, 12, scale=0.3).to(torch.bfloat16), 1.0 + 0.1 * t(16), 0.1 * t(16)
        kw["proj"] = (x, wp, sp, bp, stride)
        kw_ref["proj"] = (x, wp.t().contiguous(), sp, bp, stride)
    got = fr.back_step(y2, w3, s3, b3, **kw)  # a CPU tensor: the plain version
    want = fr.conv1x1_plain(y2, w3.t().contiguous(), s3, b3, **kw_ref)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
