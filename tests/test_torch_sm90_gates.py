"""The shape gates of the wgmma kernels, the K-major weight packing and the
channel padding, on the CPU.

``conv_sm90_kernel`` (K2's ``conv1x1_kernel`` and ``conv3x3_kernel``, K4)
and ``back_kernel`` (K3) take input and output channel counts that are
multiples of 64 (one 128-byte swizzle row of bf16, the narrowest N tile);
a CUDA tensor outside the gate raises before any launch. The gates are
pure functions of shapes, so they are held here to the cases the kernels
take and refuse. The packing tests check that the K-major layouts the
kernels read, put back through the plain versions, give the HWIO /
``[K, N]`` results exactly; that the packers zero-pad narrow models so
that every launch of the padded pack passes the gates; and that the
published widths take no padding. The ablation tools' text edits of the
kernel sources are held to the sources as they are.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from psana_ray_tpu_torch.models import fused_resnet as fr  # noqa: E402
from psana_ray_tpu_torch.models import fused_unet as fu  # noqa: E402
from psana_ray_tpu_torch.models.resnet import BottleneckBlock, ResNetClassifier  # noqa: E402
from psana_ray_tpu_torch.models.unet_tpu import PeakNetUNetTPU  # noqa: E402


@pytest.mark.parametrize(
    "x_shape,n,stride",
    [
        ((1, 8, 16, 64), 128, 1),       # one 128-pixel tile
        ((32, 88, 96, 64), 64, 1),      # ResNet stage 1's 3x3: N = 64
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
        ((1, 8, 8, 64), 32, 1, "N % 64"),        # narrow output
        ((1, 8, 8, 64), 160, 1, "N % 64"),
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
        ((2, 8, 8, 64), 64, None, (2, 16, 16, 64), 2),        # N = 64
    ],
)
def test_back_gate_takes(y2_shape, n, res_shape, proj_shape, stride):
    fr.back_gate(y2_shape, n, res_shape, proj_shape, stride)


@pytest.mark.parametrize(
    "y2_shape,n,res_shape,proj_shape,stride,match",
    [
        ((1, 8, 8, 32), 128, (1, 8, 8, 128), None, 1, "Cin % 64"),
        ((1, 8, 8, 64), 96, (1, 8, 8, 96), None, 1, "N % 64"),
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


def test_pack_block_is_k_major():
    """``w1 [F, Cin]``, ``w2 [F, 9*F]`` with ``w2[n, (dy*3 + dx)*F + c]``,
    ``w3 [N, F]`` and ``wp [N, Cin]``; the front and middle plain versions
    on them equal the GEMM-layout plain versions exactly."""
    blk = BottleneckBlock(128, 64, stride=2)
    with torch.no_grad():
        for p in blk.parameters():
            p.normal_(generator=torch.Generator().manual_seed(p.numel()))
    bw = fr.pack_block(blk)
    assert (bw.cin, bw.features, bw.cout) == (128, 64, 256)
    w1, w2 = blk.conv1.weight[:, :, 0, 0], blk.conv2.weight  # OIHW
    torch.testing.assert_close(bw.w1, w1.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(bw.w3, blk.conv3.weight[:, :, 0, 0].to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(bw.wp, blk.proj.weight[:, :, 0, 0].to(torch.bfloat16), rtol=0, atol=0)
    for dy, dx, c, n in ((0, 0, 0, 0), (2, 1, 63, 5), (1, 2, 7, 63)):
        assert bw.w2[n, (dy * 3 + dx) * 64 + c] == w2[n, c, dy, dx].to(torch.bfloat16)
    assert all(t.is_contiguous() and t.dtype == torch.bfloat16 for t in (bw.w1, bw.w2, bw.w3, bw.wp))
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 6, 8, 128)).astype(np.float32)).to(torch.bfloat16)
    y1 = fr.conv1x1(x, bw.w1, bw.s1, bw.b1)  # a CPU tensor: the plain version
    torch.testing.assert_close(y1, fr.conv1x1_plain(x, bw.w1.t().contiguous(), bw.s1, bw.b1),
                               rtol=0, atol=0)
    hwio = w2.permute(2, 3, 1, 0).to(torch.bfloat16).reshape(9 * 64, 64)
    torch.testing.assert_close(fr.conv3x3(y1, bw.w2, bw.s2, bw.b2, 2),
                               fr.conv3x3_plain(y1, hwio, bw.s2, bw.b2, 2), rtol=0, atol=0)


def _resnet_launch_shapes(packed, b, h, w):
    """Each kernel launch of ``resnet_fused_infer`` on ``[b, h, w]`` frames:
    (gate, arguments), at the padded widths."""
    h, w = -(-h // 4), -(-w // 4)  # after the stem and the max-pool
    out = []
    for blk in packed.blocks:
        cp, fp, np_ = blk.w1.shape[1], blk.w1.shape[0], blk.w3.shape[0]
        s = blk.stride
        out.append((fr.conv_gate, ("conv1x1_kernel", (b, h, w, cp), fp, 1)))
        out.append((fr.conv_gate, ("conv3x3_kernel", (b, h, w, fp), fp, s)))
        ho, wo = h // s, w // s
        if blk.wp is None:
            out.append((fr.back_gate, ((b, ho, wo, fp), np_, (b, ho, wo, np_), None, 1)))
        else:
            out.append((fr.back_gate, ((b, ho, wo, fp), np_, None, (b, h, w, cp), s)))
        h, w = ho, wo
    return out


def test_narrow_resnet_pack_is_padded_and_passes_the_gates():
    """Width 16 (the CPU parity tests' ResNet-50): every channel count is
    padded to a multiple of 64 with zeros, and every launch shape of the
    padded pack passes the card's gates."""
    model = ResNetClassifier((3, 4, 6, 3), in_channels=4, width=16)
    packed = fr.pack_fused(model)
    for bw in packed.blocks:
        f, cin, cout = bw.features, bw.cin, bw.cout
        assert bw.w1.shape == (fr.padded(f), fr.padded(cin))
        assert bw.w2.shape == (fr.padded(f), 9 * fr.padded(f))
        assert bw.w3.shape == (fr.padded(cout), fr.padded(f))
        assert not bw.w1[f:].any() and not bw.w1[:, cin:].any()
        assert not bw.w3[cout:].any() and not bw.w3[:, f:].any()
        assert not bw.w2.reshape(bw.w2.shape[0], 9, -1)[:, :, f:].any() and not bw.w2[f:].any()
        for t in (bw.s1, bw.b1, bw.s2, bw.b2):
            assert not t[f:].any()
        assert not bw.s3[cout:].any() and not bw.b3[cout:].any()
    assert packed.blocks[0].w1.shape == (64, 64)  # F = 16 and Cin = 16 padded
    for gate, args in _resnet_launch_shapes(packed, 2, 64, 64):
        gate(*args)


def test_full_width_packs_take_no_padding():
    """ResNet-50 at width 64 and PeakNet-TPU at (64, 128, 256, 512): every
    packed weight has the model's own shape."""
    model = ResNetClassifier((3, 4, 6, 3), in_channels=16, width=64)
    packed = fr.pack_fused(model)
    for bw, blk in zip(packed.blocks, model.blocks):
        f, cin = blk.conv1.weight.shape[:2]
        assert (bw.w1.shape, bw.w2.shape, bw.w3.shape) == ((f, cin), (f, 9 * f), (4 * f, f))
        assert bw.s1.shape == (f,) and bw.s3.shape == (4 * f,)
        assert bw.wp is None or bw.wp.shape == (4 * f, cin)
    for gate, args in _resnet_launch_shapes(packed, 32, 352, 384):
        gate(*args)
    unet = fu.pack_unet(PeakNetUNetTPU((64, 128, 256, 512)))
    for lvl, cin, f in zip(unet.levels, (64, 128, 256), (128, 256, 512)):
        assert lvl.w1.shape == (f, 9 * cin) and lvl.w2.shape == (f, 9 * f)
        assert lvl.a1[0].shape == (f,)


def test_narrow_unet_pack_is_padded_and_passes_the_gates():
    """PeakNet-TPU (32, 64, 128): level 1's 32 input channels are padded to
    64, and every K4 launch of the padded pack passes the gates."""
    unet = fu.pack_unet(PeakNetUNetTPU((32, 64, 128)))
    lvl1, bott = unet.levels
    assert lvl1.w1.shape == (64, 9 * 64) and lvl1.wd.shape == (64, 9 * 64)
    assert not lvl1.w1.reshape(64, 9, 64)[:, :, 32:].any()
    assert bott.w1.shape == (128, 9 * 64)
    b, h, w = 2, 16, 32  # level 1's extent for [2, 64, 128] frames at s2d 2
    for lvl in unet.levels:
        cin, f = lvl.w1.shape[1] // 9, lvl.w1.shape[0]
        fu.level_conv_gate((b, h, w, cin), f, 1)
        fu.level_conv_gate((b, h, w, f), f, 1)
        if lvl.wd is not None:
            fu.level_conv_gate((b, h, w, f), f, 2)
            h, w = h // 2, w // 2


def _ablation_edits():
    """(tool, variant, file, old) for every text edit of the three ablation
    tools: each builds its variants from copies of ``csrc/`` with these
    edits, and raises on the card if one no longer applies."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    cases = []
    for tool, default_file in (("conv_sm90_ablation", None), ("flash_ablation", "flash.cu"),
                               ("flash_bwd_ablation", "flash_bwd.cu")):
        spec = importlib.util.spec_from_file_location(tool, root / "tools" / f"{tool}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for variant, edits in mod.VARIANTS.items():
            for edit in edits:
                name, old = (edit[0], edit[1]) if default_file is None else (default_file, edit[0])
                cases.append((tool, variant, name, old))
    return root / "psana_ray_tpu_torch" / "csrc", cases


@pytest.mark.parametrize("tool", ["conv_sm90_ablation", "flash_ablation", "flash_bwd_ablation"])
def test_ablation_edits_apply_to_the_sources(tool):
    """Every variant of the tool edits text that the kernel sources hold,
    so a kernel edit that breaks a variant shows here and not on the card."""
    csrc, cases = _ablation_edits()
    mine = [c for c in cases if c[0] == tool]
    assert mine
    for _, variant, name, old in mine:
        assert old in (csrc / name).read_text(), (variant, name, old[:80])
