"""The hand-written Hopper kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. It imports no
JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Shapes are small and ragged (pixel counts that are not multiples of the
kernels' tiles) so that the edge masking runs; the wgmma kernels
(``conv_sm90_kernel`` for K2 and K4, ``back_kernel``) also run one exact
128-pixel tile first, the U-Net bottleneck's 22x24 extent, N from 64 to
2048 and K from 64 to 4608, and models narrower than the kernels'
64-channel quantum on zero-padded channels. The flash kernel runs one
128-row tile, causal Sq != Sk and the ViT serving shape; the flash backward
kernel also runs twice on the same inputs, and its dq rounding pass alone.
Tolerances: calibration
rtol 1e-5, atol 1e-4 in f32 (plus one bf16 ulp for bf16 output); the
bottleneck and U-Net level kernels ``rel_err < 0.05``, the JAX package's
bound for bf16 activations with f32 accumulation, as is the ViT with the
flash kernel; the flash kernel itself ``o`` atol 2e-2 and ``lse`` atol
1e-2, the bf16 tolerances of ``tests/test_ring_attention.py``, and each
within 1e-2 of its own scale on unit-scale inputs; the flash backward
kernel's dq, dk and dv within 1e-2 of their own scale
(``max|g - g_ref| / max|g_ref|``) on unit-scale inputs, where it rounds
p and ds to bf16 and the plain version keeps f32; two of its launches give
identical dk and dv and dq within one bf16 ulp of its largest value.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu_torch.models import fused_resnet as fr  # noqa: E402
from psana_ray_tpu_torch.models import fused_unet as fu  # noqa: E402
from psana_ray_tpu_torch.ops.fused_calib import fused_calibrate_plain  # noqa: E402

pytestmark = pytest.mark.gpu
REL_TOL = 0.05
BWD_TOL = 1e-2
NO_BWD = {"flash_bwd_kernel": 0, "flash_bwd_dq_convert": 0}  # serving paths launch no backward
NO_CONV = {"conv1x1_kernel": 0, "conv3x3_kernel": 0, "back_kernel": 0, "conv_block_kernel": 0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pt.reset_counters()
    return torch.device("cuda")


@pytest.fixture
def gen(cuda):
    return torch.Generator(device=cuda).manual_seed(0)


def rel_err(ref, got):
    ref, got = ref.float(), got.float()
    return float((ref - got).abs().max() / max(float(ref.abs().max()), 1e-3))


def _calib_inputs(cuda, b, p, h, w, seed=0):
    rng = np.random.default_rng(seed)
    ped = (100.0 + 3.0 * rng.standard_normal((p, h, w))).astype(np.float32)
    gain = (1.0 + 0.02 * rng.standard_normal((p, h, w))).astype(np.float32)
    mask = (rng.random((p, h, w)) > 0.01).astype(np.uint8)
    mask[0] = 0
    raw = ped + 35.0 * rng.poisson(0.1, (b, p, h, w)) + rng.normal(0, 2.5, (b, p, h, w))
    return [torch.from_numpy(np.asarray(a, np.float32) if a is not mask else a).to(cuda)
            for a in (raw, ped, gain, mask)]


@pytest.mark.parametrize("w", [96, 95])  # 95: the scalar path (pixels % 4 != 0)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_calib_kernel_matches_plain(cuda, w, out_dtype):
    raw, ped, gain, mask = _calib_inputs(cuda, 3, 4, 64, w)
    got = pt.fused_calibrate(raw, ped, gain, mask, out_dtype=out_dtype)
    ref = fused_calibrate_plain(raw, ped, gain, mask, out_dtype=out_dtype).float()
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and pt.counts()["calib_kernel"] == 1
    tol = 1e-4 + 1e-5 * ref.abs()
    if out_dtype == torch.bfloat16:
        tol = tol + torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
    assert bool(torch.all((got.float() - ref).abs() <= tol))
    assert bool(torch.all(got[:, 0] == 0))  # the all-masked panel


def test_calib_kernel_auto_batch_and_integer_raw(cuda):
    raw, ped, gain, mask = _calib_inputs(cuda, 2, 2, 32, 64)
    raw_int = raw.clamp(0, 65535).to(torch.int32)
    got = pt.fused_calibrate(raw_int[1], ped, gain, mask)
    ref = fused_calibrate_plain(raw_int[1], ped, gain, mask)
    assert got.shape == raw.shape[1:] and got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)


def test_calib_kernel_refuses_what_it_does_not_take(cuda):
    raw, ped, gain, mask = _calib_inputs(cuda, 1, 2, 8, 8)
    with pytest.raises(NotImplementedError):
        pt.fused_calibrate(raw.half(), ped, gain, mask)
    with pytest.raises(ValueError):
        pt.fused_calibrate(raw, ped[:1], gain, mask)
    with pytest.raises(ValueError):
        pt.fused_calibrate(raw, ped.cpu(), gain, mask)


def _operands(gen, cuda, b, h, w, cin, n):
    x = torch.randn((b, h, w, cin), generator=gen, device=cuda).bfloat16()
    wt = (torch.randn((cin, n), generator=gen, device=cuda) / cin**0.5).bfloat16()
    s = 1.0 + 0.1 * torch.randn(n, generator=gen, device=cuda)
    bias = 0.1 * torch.randn(n, generator=gen, device=cuda)
    return x, wt, s, bias


def _k_major(gen, cuda, k, n):
    return (torch.randn((n, k), generator=gen, device=cuda) / k**0.5).bfloat16()


# (B, Ho, Wo, F, N, mode): the first is one exact 128 x 128 x 64 tile
BACK_CASES = [
    (1, 8, 16, 64, 128, "identity"),
    (3, 10, 14, 64, 256, "identity"),     # 420 pixels: a ragged last tile
    (2, 11, 12, 512, 2048, "identity"),   # ResNet stage 4's widths
    (3, 10, 14, 64, 256, "proj1"),
    (3, 10, 14, 128, 512, "proj2"),
    (2, 22, 24, 256, 1024, "proj2"),
    (2, 11, 12, 4608, 128, "identity"),   # K = 4608
    (3, 10, 14, 64, 192, "identity"),     # N % 128 != 0: 64-wide N tiles
    (3, 10, 14, 64, 192, "proj2"),
]


@pytest.mark.parametrize("b,ho,wo,f,n,mode", BACK_CASES)
def test_back_kernel_matches_plain(cuda, gen, b, ho, wo, f, n, mode):
    y2 = torch.randn((b, ho, wo, f), generator=gen, device=cuda).bfloat16()
    w3 = _k_major(gen, cuda, f, n)
    s3 = 1.0 + 0.1 * torch.randn(n, generator=gen, device=cuda)
    b3 = 0.1 * torch.randn(n, generator=gen, device=cuda)
    kw = {}
    if mode == "identity":
        kw["residual"] = torch.randn((b, ho, wo, n), generator=gen, device=cuda).bfloat16()
    else:
        stride, cin = int(mode[-1]), 64 * (1 + (f // 64) % 3)
        x = torch.randn((b, ho * stride, wo * stride, cin), generator=gen, device=cuda).bfloat16()
        kw["proj"] = (x, _k_major(gen, cuda, cin, n), 1.0 + 0.1 * torch.randn(n, generator=gen, device=cuda),
                      0.1 * torch.randn(n, generator=gen, device=cuda), stride)
    got = fr.back_step(y2, w3, s3, b3, **kw)
    ref = fr.back_step_plain(y2, w3, s3, b3, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert pt.counts() == {"calib_kernel": 0, **NO_CONV, "back_kernel": 1, "flash_kernel": 0, **NO_BWD}
    assert bool(torch.isfinite(got.float()).all())
    assert rel_err(ref, got) < REL_TOL, rel_err(ref, got)


# ResNet-50 stage 1's front launches at batch 32 widths (N = F = 64, the
# m64n64k16 tile): the first block's Cin 64 (one k-step), then Cin 256
@pytest.mark.parametrize("cin", [64, 256])
def test_conv1x1_kernel_matches_plain(cuda, gen, cin):
    b, h, w, n = 3, 10, 14, 64  # 420 pixels: a ragged last tile
    x, _, s, bias = _operands(gen, cuda, b, h, w, cin, n)
    wt = _k_major(gen, cuda, cin, n)
    got = fr.conv1x1(x, wt, s, bias)
    ref = fr.front_plain(x, wt, s, bias)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert pt.counts() == {"calib_kernel": 0, **NO_CONV, "conv1x1_kernel": 1, "flash_kernel": 0,
                           **NO_BWD}
    assert rel_err(ref, got) < REL_TOL, rel_err(ref, got)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv3x3_kernel_matches_plain(cuda, gen, stride):
    b, h, w, c = 2, 12, 18, 64  # stage 1's F = 64: N = 64
    x, _, s, bias = _operands(gen, cuda, b, h, w, c, c)
    wt = _k_major(gen, cuda, 9 * c, c)
    got = fr.conv3x3(x, wt, s, bias, stride)
    ref = fr.middle_plain(x, wt, s, bias, stride)
    torch.cuda.synchronize()
    assert got.shape == (b, h // stride, w // stride, c)
    assert pt.counts() == {"calib_kernel": 0, **NO_CONV, "conv3x3_kernel": 1, "flash_kernel": 0,
                           **NO_BWD}
    assert rel_err(ref, got) < REL_TOL, rel_err(ref, got)


def test_bottleneck_kernels_refuse_bad_shapes(cuda, gen):
    x, _, s, bias = _operands(gen, cuda, 1, 4, 4, 48, 64)
    with pytest.raises(ValueError, match="Cin"):
        fr.conv1x1(x, _k_major(gen, cuda, 48, 64), s, bias)
    x, _, s, bias = _operands(gen, cuda, 1, 4, 4, 64, 128)
    w1 = _k_major(gen, cuda, 64, 128)
    with pytest.raises(ValueError, match="contiguous NHWC bf16"):
        fr.conv1x1(x.float(), w1, s, bias)
    with pytest.raises(ValueError, match="K-major"):
        fr.conv1x1(x, w1.t().contiguous(), s, bias)
    with pytest.raises(ValueError, match="N % 64"):
        fr.conv3x3(x, _k_major(gen, cuda, 9 * 64, 96), s[:96], bias[:96])
    with pytest.raises(ValueError, match="even"):
        fr.conv3x3(x[:, :3].contiguous(), _k_major(gen, cuda, 9 * 64, 64), s[:64], bias[:64], 2)
    w3 = _k_major(gen, cuda, 64, 128)
    with pytest.raises(ValueError, match="exactly one"):
        fr.back_step(x, w3, s, bias, residual=x, proj=(x, w3, s, bias, 1))
    narrow = _k_major(gen, cuda, 32, 128)
    with pytest.raises(ValueError, match="Cin"):
        fr.back_step(x[..., :32].contiguous(), narrow, s, bias, residual=x)
    with pytest.raises(ValueError, match="N % 64"):
        fr.back_step(x, _k_major(gen, cuda, 64, 96), s[:96], bias[:96], residual=x[..., :96])
    assert pt.counts() == {"calib_kernel": 0, **NO_CONV, "flash_kernel": 0, **NO_BWD}


def test_fused_network_matches_plain_model(cuda):
    stages = (1, 1, 1, 1)
    model = pt.resnet_from_flax(pt.init_resnet_params(in_channels=4, stage_sizes=stages, seed=1),
                                stages, device=cuda)
    x = torch.randn((2, 64, 64, 4), generator=torch.Generator(cuda).manual_seed(1), device=cuda)
    logits, feat = pt.resnet_fused_infer(pt.pack_fused(model), x, stages, return_features=True)
    ref_logits, ref_feat = model(x, return_features=True)
    assert pt.counts() == {"calib_kernel": 0, "conv1x1_kernel": 4, "conv3x3_kernel": 4,
                           "back_kernel": 4, "conv_block_kernel": 0, "flash_kernel": 0, **NO_BWD}
    assert float(ref_feat.abs().max()) >= 1e-2
    assert rel_err(ref_logits, logits) < REL_TOL
    assert rel_err(ref_feat, feat) < REL_TOL


def test_narrow_resnet_runs_through_the_kernels(cuda):
    """The CPU parity tests' ResNet-50 (width 16, stage widths 16..128 and
    a 16-channel stem) runs every block through the kernels on channels
    padded to 64, within tolerance of its plain model."""
    model = pt.resnet_from_flax(pt.init_resnet_params(in_channels=4, width=16, seed=2), device=cuda)
    x = torch.randn((2, 64, 64, 4), generator=torch.Generator(cuda).manual_seed(2), device=cuda)
    logits, feat = pt.resnet_fused_infer(pt.pack_fused(model), x, return_features=True)
    ref_logits, ref_feat = model(x, return_features=True)
    assert pt.counts() == {"calib_kernel": 0, "conv1x1_kernel": 16, "conv3x3_kernel": 16,
                           "back_kernel": 16, "conv_block_kernel": 0, "flash_kernel": 0, **NO_BWD}
    assert tuple(feat.shape) == (2, 512) and float(ref_feat.abs().max()) >= 1e-2
    assert rel_err(ref_logits, logits) < REL_TOL
    assert rel_err(ref_feat, feat) < REL_TOL


def test_entry_runs_on_the_card(cuda):
    assert pt.resolve_device().type == "cuda"
    fn, args = pt.entry()
    logits = fn(*args)
    torch.cuda.synchronize()
    assert tuple(logits.shape) == (4, 2) and bool(torch.isfinite(logits).all())
    # one ResNet-50 batch: K2's 16 + 16 launches and K3's 16
    assert pt.counts() == {"calib_kernel": 1, "conv1x1_kernel": 16, "conv3x3_kernel": 16,
                           "back_kernel": 16, "conv_block_kernel": 0, "flash_kernel": 0, **NO_BWD}


# (B, h, w, cin, n, stride): the first is one exact 128 x 128 x 64 tile
LEVEL_CONV_CASES = [
    (1, 8, 16, 64, 128, 1),
    (3, 10, 14, 64, 128, 1),      # 420 pixels: a ragged last tile
    (3, 10, 14, 64, 256, 2),      # stride 2, SAME (0, 1)
    (2, 22, 24, 256, 512, 1),     # the bottleneck level's extent
    (2, 22, 24, 512, 128, 1),     # K = 9 * 512 = 4608
    (2, 44, 48, 128, 256, 2),
    (3, 10, 14, 64, 64, 1),       # N = 64: the m64n64k16 tile
    (3, 10, 14, 128, 64, 2),
]


@pytest.mark.parametrize("b,h,w,cin,n,stride", LEVEL_CONV_CASES)
@pytest.mark.parametrize("epilogue", ["affine_silu", "none"])
def test_conv3x3_kernel_epilogues(cuda, gen, b, h, w, cin, n, stride, epilogue):
    x = torch.randn((b, h, w, cin), generator=gen, device=cuda).bfloat16()
    wt = _k_major(gen, cuda, 9 * cin, n)
    s = bias = None
    if epilogue == "affine_silu":
        s = 1.0 + 0.1 * torch.randn(n, generator=gen, device=cuda)
        bias = 0.1 * torch.randn(n, generator=gen, device=cuda)
    got = fu.launch_level_conv(x, wt, s, bias, stride)
    ref = fu.level_conv_plain(x, wt, s, bias, stride)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (b, h // stride, w // stride, n)
    assert pt.counts() == {"calib_kernel": 0, **NO_CONV, "conv_block_kernel": 1, "flash_kernel": 0,
                           **NO_BWD}
    assert bool(torch.isfinite(got.float()).all())
    assert rel_err(ref, got) < REL_TOL, rel_err(ref, got)


def _level(gen, cuda, cin, f, down):
    def w(i, o):
        return torch.randn((3, 3, i, o), generator=gen, device=cuda) / (9 * i) ** 0.5

    def a():
        return (1.0 + 0.1 * torch.randn(f, generator=gen, device=cuda),
                0.1 * torch.randn(f, generator=gen, device=cuda))

    return w(cin, f), a(), w(f, f), a(), (w(f, f) if down else None)


@pytest.mark.parametrize("down", [True, False])
def test_conv_block_kernel_matches_plain(cuda, gen, down):
    x = torch.randn((2, 12, 18, 64), generator=gen, device=cuda).bfloat16()
    w1, a1, w2, a2, wd = _level(gen, cuda, 64, 128, down)
    skip, dn = fu.fused_conv_block(x, w1, a1, w2, a2, wd)
    ref_skip, ref_dn = fu.fused_conv_block_plain(x, w1, a1, w2, a2, wd)
    torch.cuda.synchronize()
    assert pt.counts()["conv_block_kernel"] == (3 if down else 2)
    assert skip.dtype == torch.bfloat16 and rel_err(ref_skip, skip) < REL_TOL
    if down:
        assert tuple(dn.shape) == (2, 6, 9, 128) and rel_err(ref_dn, dn) < REL_TOL
    else:
        assert dn is None and ref_dn is None


@pytest.mark.parametrize("cin,f", [(32, 128), (64, 64), (32, 32)])
def test_conv_block_kernel_runs_narrow_channels(cuda, gen, cin, f):
    """A level narrower than the kernel's 64-channel quantum runs through
    the kernel on zero-padded channels and gives the true channels."""
    x = torch.randn((2, 8, 12, cin), generator=gen, device=cuda).bfloat16()
    w1, a1, w2, a2, wd = _level(gen, cuda, cin, f, True)
    skip, dn = fu.fused_conv_block(x, w1, a1, w2, a2, wd)
    ref_skip, ref_dn = fu.fused_conv_block_plain(x, w1, a1, w2, a2, wd)
    torch.cuda.synchronize()
    assert pt.counts()["conv_block_kernel"] == 3
    assert tuple(skip.shape) == (2, 8, 12, f) and tuple(dn.shape) == (2, 4, 6, f)
    assert rel_err(ref_skip, skip) < REL_TOL and rel_err(ref_dn, dn) < REL_TOL


def test_fused_unet_matches_plain_model(cuda):
    features = (64, 128, 256, 512)
    model = pt.unet_from_flax(pt.init_peaknet_tpu_params(features, seed=1), device=cuda)
    x = torch.randn((2, 64, 128, 1), generator=torch.Generator(cuda).manual_seed(1), device=cuda)
    got = pt.peaknet_tpu_fused_infer(pt.pack_unet(model), x)
    with torch.no_grad():
        ref = model(x)
    assert pt.counts()["conv_block_kernel"] == 3 + 3 + 2
    assert tuple(got.shape) == (2, 64, 128, 1) and bool(torch.isfinite(got).all())
    assert rel_err(ref, got) < REL_TOL


def test_narrow_unet_runs_through_the_kernels(cuda):
    """PeakNet-TPU (32, 64, 128): level 1 and the bottleneck run through the
    kernel on channels padded to 64, within tolerance of the plain model."""
    model = pt.unet_from_flax(pt.init_peaknet_tpu_params((32, 64, 128), seed=1), device=cuda)
    x = torch.randn((2, 64, 128, 1), generator=torch.Generator(cuda).manual_seed(1), device=cuda)
    got = pt.peaknet_tpu_fused_infer(pt.pack_unet(model), x)
    with torch.no_grad():
        ref = model(x)
    assert pt.counts()["conv_block_kernel"] == 3 + 2
    assert tuple(got.shape) == (2, 64, 128, 1) and bool(torch.isfinite(got).all())
    assert rel_err(ref, got) < REL_TOL


def test_sfx_pipeline_runs_on_the_card(cuda):
    class Sink:
        max_peaks = 64

        def __init__(self):
            self.sets = []

        def append(self, sets):
            self.sets.extend(sets)

    src = pt.SyntheticSource(num_events=6, detector_name="smoke_a", seed=5)
    ring = pt.RingBuffer(maxsize=8)
    pt.produce(src.iter_indexed_events("raw"), ring)
    calib = (src.pedestal(), src.spec.adu_gain * src.gain_map(), src.create_bad_pixel_mask())
    sink = Sink()
    pipe = pt.SfxPipeline(pt.init_peaknet_tpu_params((64, 128, 256, 512), seed=0), sink,
                          calib=calib, config=pt.SfxConfig(batch_size=4))
    assert pipe.device.type == "cuda"
    assert pipe.run(ring) == 6
    assert [s.event_idx for s in sink.sets] == list(range(6))
    # two SFX batches: +8 conv_block_kernel each
    assert pt.counts() == {"calib_kernel": 2, **NO_CONV, "conv_block_kernel": 16, "flash_kernel": 0,
                           **NO_BWD}


def _flat_lse(sq, sk, causal, device):
    """Row log-sum-exp of all-zero scores: the log of each row's key count."""
    i = torch.arange(sq, device=device)
    return torch.log((torch.clamp(i + 1, max=sk) if causal else torch.full_like(i, sk)).float())


@pytest.mark.parametrize(
    "bh,sq,sk,causal",
    [(1, 128, 128, False), (1, 128, 128, True),  # one tile
     (3, 256, 256, False), (3, 256, 256, True), (2, 256, 768, False), (2, 256, 768, True),
     (2, 384, 128, True), (2, 640, 384, True),   # causal, Sq != Sk
     (8, 8448, 8448, False)],                    # the ViT serving shape
)
def test_flash_kernel_matches_plain(cuda, gen, bh, sq, sk, causal):
    """Unit-scale q, k, v (scores of std 1, far from a flat softmax): o
    within 2e-2 and lse within 1e-2 of the plain version (bf16, the
    tolerances of tests/test_ring_attention.py:235-243), and each within
    1e-2 of its own scale: max |o_ref|, and max |lse_ref - log(keys)|."""
    from psana_ray_tpu_torch.parallel import flash as tf

    def mk(s):
        return torch.randn((1, bh, s, 128), generator=gen, device=cuda).bfloat16()

    q, k, v = mk(sq), mk(sk), mk(sk)
    o, lse = tf.attention_with_stats(q, k, v, causal=causal)
    o_ref, lse_ref = tf.attention_with_stats_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert pt.counts()["flash_kernel"] == 1
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    d_o = float((o.float() - o_ref.float()).abs().max())
    d_lse = float((lse - lse_ref).abs().max())
    assert d_o <= 2e-2 and d_lse <= 1e-2
    assert d_o <= 1e-2 * float(o_ref.float().abs().max())
    assert d_lse <= 1e-2 * float((lse_ref - _flat_lse(sq, sk, causal, cuda)).abs().max())


def test_flash_kernel_takes_the_repo_layout(cuda, gen):
    from psana_ray_tpu_torch.parallel import flash as tf

    q, k, v = (torch.randn((2, 128, 2, 128), generator=gen, device=cuda).bfloat16() for _ in range(3))
    got = tf.flash_attention(q, k, v)
    ref, _ = tf.attention_with_stats_plain(*(t.transpose(1, 2) for t in (q, k, v)))
    torch.cuda.synchronize()
    assert tuple(got.shape) == (2, 128, 2, 128) and pt.counts()["flash_kernel"] == 1
    assert float((got.float() - ref.transpose(1, 2).float()).abs().max()) <= 2e-2


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    from psana_ray_tpu_torch.parallel import flash as tf

    z = torch.zeros((1, 2, 128, 128), device=cuda)
    with pytest.raises(NotImplementedError, match="bf16"):
        tf.attention_with_stats(z, z, z)
    with pytest.raises(NotImplementedError, match="head dim"):
        tf.attention_with_stats(*(torch.zeros((1, 2, 128, 64), device=cuda).bfloat16(),) * 3)
    with pytest.raises(ValueError, match="multiples of 128"):
        tf.attention_with_stats(*(torch.zeros((1, 2, 192, 128), device=cuda).bfloat16(),) * 3)
    assert pt.counts()["flash_kernel"] == 0
    # the C entry point checks the 128-row tiles itself
    from psana_ray_tpu_torch.kernels import build

    z = torch.zeros((1, 64, 128), device=cuda).bfloat16()
    lib = build.library("flash")
    err = lib.flash_fwd_launch(z.data_ptr(), z.data_ptr(), z.data_ptr(), z.data_ptr(),
                               torch.zeros(64, device=cuda).data_ptr(), 1, 64, 64, 128, 0.1, 0,
                               torch.cuda.current_stream().cuda_stream)
    assert err != 0


def test_vit_matches_plain_attention_model(cuda):
    """The small ViT (patch 8, embed 256, 2 heads, depth 2, 256 tokens):
    flash_kernel in every block against the plain attention."""
    from psana_ray_tpu_torch.parallel import flash as tf

    params = pt.init_vit_params((2, 64, 128), patch=8, embed_dim=256, depth=2, seed=1)
    model = pt.vit_from_flax(params, num_heads=2, device=cuda)
    plain = pt.vit_from_flax(
        params, num_heads=2, device=cuda,
        attn_fn=lambda q, k, v: tf.attention_with_stats_plain(
            *(t.transpose(1, 2) for t in (q, k, v)))[0].transpose(1, 2))
    x = torch.randn((2, 2, 64, 128), generator=torch.Generator(cuda).manual_seed(1), device=cuda)
    with torch.no_grad():
        got, ref = model(x), plain(x)
    assert pt.counts()["flash_kernel"] == 2
    assert tuple(got.shape) == (2, 2) and bool(torch.isfinite(got).all())
    assert rel_err(ref, got) < REL_TOL


def test_vit_serve_step_runs_on_the_card(cuda):
    """The serving step at the reference's defaults on 2 RAW epix10k2M
    frames: one calib_kernel launch and one flash_kernel launch a block."""
    src = pt.SyntheticSource(num_events=2, detector_name="epix10k2M", seed=0)
    frames = torch.from_numpy(
        np.stack([src.event(i, pt.RetrievalMode.RAW)[0] for i in range(2)])).to(cuda)
    ped, gain, mask = (torch.from_numpy(a).to(cuda) for a in
                       (src.pedestal(), src.gain_map(), src.create_bad_pixel_mask()))
    model = pt.vit_from_flax(pt.init_vit_params(src.spec.frame_shape, seed=0), device=cuda)
    logits = pt.vit_serve_step(model, frames, ped, gain, mask)
    torch.cuda.synchronize()
    assert tuple(logits.shape) == (2, 2) and bool(torch.isfinite(logits).all())
    assert pt.counts() == {"calib_kernel": 1, **NO_CONV, "flash_kernel": 4, **NO_BWD}


def _bwd_inputs(gen, cuda, bh, sq, sk, dlse):
    def mk(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    q, k, v = mk(1, bh, sq, 128).bfloat16(), mk(1, bh, sk, 128).bfloat16(), mk(1, bh, sk, 128).bfloat16()
    do = mk(1, bh, sq, 128).bfloat16()
    return q, k, v, do, (mk(1, bh, sq) if dlse else None)


@pytest.mark.parametrize(
    "bh,sq,sk,causal,dlse",
    [(3, 256, 256, False, False), (3, 256, 256, True, False), (2, 128, 384, False, False),
     (2, 128, 384, True, False), (2, 384, 128, True, False), (2, 768, 768, False, True),
     (2, 512, 512, True, True)],
)
def test_flash_bwd_kernels_match_plain(cuda, gen, bh, sq, sk, causal, dlse):
    """``flash_bwd_kernel`` (K6 and K7 in one pass) against
    ``attention_bwd_plain`` on the same residuals, ``N(0, 1)`` inputs:
    causal, uneven lengths (a key tile no query sees when causal), with an
    lse cotangent."""
    from psana_ray_tpu_torch.parallel import flash as tf

    q, k, v, do, dl = _bwd_inputs(gen, cuda, bh, sq, sk, dlse)
    o, lse = tf.launch_flash(q, k, v, causal)
    got = tf.launch_flash_bwd(q, k, v, o, lse, do, causal, dl)
    ref = tf.attention_bwd_plain(q, k, v, o, lse, do, causal, dl)
    torch.cuda.synchronize()
    assert pt.counts()["flash_bwd_kernel"] == 1 and pt.counts()["flash_bwd_dq_convert"] == 1
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape, name
        assert bool(torch.isfinite(g.float()).all()), name
        assert rel_err(r, g) <= BWD_TOL, (name, rel_err(r, g))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_repeat_launches_agree(cuda, gen, causal):
    """Two launches on the same inputs: dk and dv identical (each CTA sums
    them in a fixed order), dq within one bf16 ulp of its largest value
    (its f32 sums across key tiles arrive in another order each run); a
    dq_acc left unzeroed or a lost reduction would differ by far more."""
    from psana_ray_tpu_torch.parallel import flash as tf

    q, k, v, do, _ = _bwd_inputs(gen, cuda, 3, 512, 512, False)
    o, lse = tf.launch_flash(q, k, v, causal)
    dq1, dk1, dv1 = tf.launch_flash_bwd(q, k, v, o, lse, do, causal)
    dq2, dk2, dv2 = tf.launch_flash_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    scale = float(dq1.float().abs().max())
    assert scale > 0.0
    assert float((dq1.float() - dq2.float()).abs().max()) <= 2.0 ** -8 * scale


def test_flash_bwd_dq_convert_rounds_once(cuda, gen):
    """``flash_bwd_dq_convert`` alone: the f32 sums rounded to bf16 as
    ``Tensor.to(torch.bfloat16)`` rounds them (nearest even), exactly, on
    values across many binades, signed zeros, ties, and 1,980 elements (the
    last block of 256 threads part-full)."""
    from psana_ray_tpu_torch.parallel import flash as tf

    acc = torch.randn((3, 5, 132), generator=gen, device=cuda) * torch.exp2(
        torch.randint(-20, 20, (3, 5, 132), generator=gen, device=cuda).float())
    acc[0, 0, :4] = torch.tensor([0.0, -0.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8], device=cuda)
    dq = tf.launch_flash_bwd_dq_convert(acc)
    torch.cuda.synchronize()
    assert dq.dtype == torch.bfloat16 and dq.shape == acc.shape
    assert torch.equal(dq.view(torch.int16), acc.to(torch.bfloat16).view(torch.int16))
    assert pt.counts()["flash_bwd_dq_convert"] == 1


def test_flash_bwd_kernels_refuse_what_they_do_not_take(cuda):
    from psana_ray_tpu_torch.parallel import flash as tf

    def call(shape, dtype=torch.bfloat16):
        z = torch.zeros(shape, device=cuda, dtype=dtype)
        return tf.launch_flash_bwd(z, z, z, z, torch.zeros(shape[:3], device=cuda), z)

    with pytest.raises(NotImplementedError, match="bf16"):
        call((1, 2, 128, 128), torch.float32)
    with pytest.raises(NotImplementedError, match="head dim"):
        call((1, 2, 128, 64))
    with pytest.raises(ValueError, match="multiples of 128"):
        call((1, 2, 192, 128))
    assert pt.counts()["flash_bwd_kernel"] == 0 and pt.counts()["flash_bwd_dq_convert"] == 0


def test_flash_backward_through_the_function(cuda, gen):
    """One backward through ``attention_with_stats`` with both outputs in
    the loss launches each backward kernel once and matches the plain
    backward with the lse cotangent."""
    from psana_ray_tpu_torch.parallel import flash as tf

    q, k, v, do, dl = _bwd_inputs(gen, cuda, 2, 256, 256, True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = tf.attention_with_stats(*leaves, causal=True)
    torch.autograd.backward((o, lse), (do, dl))
    torch.cuda.synchronize()
    assert {k_: pt.counts()[k_] for k_ in ("flash_kernel", "flash_bwd_kernel",
                                           "flash_bwd_dq_convert")} == {
        "flash_kernel": 1, "flash_bwd_kernel": 1, "flash_bwd_dq_convert": 1}
    ref = tf.attention_bwd_plain(q, k, v, o.detach(), lse.detach(), do, True, dl)
    for name, leaf, r in zip(("dq", "dk", "dv"), leaves, ref):
        assert rel_err(r, leaf.grad) <= BWD_TOL, name


def test_vit_train_step_on_the_card(cuda):
    """One train step of the small ViT (patch 8, embed 256, 2 heads, depth
    2, 256 tokens) on the card: each backward kernel launches once per
    block, and every gradient is finite."""
    params = pt.init_vit_params((2, 64, 128), patch=8, embed_dim=256, depth=2, seed=1)
    model = pt.vit_from_flax(params, num_heads=2, device=cuda)
    opt = pt.adamw(model.parameters(), pt.warmup_cosine_decay_schedule(0.0, 6e-4, 2, 10, 1e-5),
                   weight_decay=0.01)
    step = pt.make_train_step(model, opt, lambda lg, aux: pt.masked_softmax_xent(lg, *aux))
    x = torch.randn((4, 2, 64, 128), generator=torch.Generator(cuda).manual_seed(1), device=cuda)
    labels = torch.tensor([0, 1, 1, 0], device=cuda)
    valid = torch.tensor([1, 1, 1, 0], dtype=torch.uint8, device=cuda)
    loss = step(x, (labels, valid))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss))
    assert pt.counts() == {"calib_kernel": 0, **NO_CONV, "flash_kernel": 2,
                           "flash_bwd_kernel": 2, "flash_bwd_dq_convert": 2}
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
