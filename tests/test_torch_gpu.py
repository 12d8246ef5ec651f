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
Calibration runs its cluster route on ragged, unaligned, partly empty and
jungfrau4M-sized slices, with f32 and uint16 raw, twice on each input
(bit-identical), and its two-pass route. Tolerances: calibration
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
The other variants of K5-K7 (``flash_wide_kernel`` and
``flash_bwd_wide_kernel`` in bf16 at head dims 256-1024,
``flash_f32_kernel`` and ``flash_bwd_f32_kernel`` in f32 at 128-1024)
are held to the same plain versions, the bf16 ones at the tolerances
above and the f32 ones at the JAX package's f32 tolerances (``o`` atol
2e-5, ``lse`` atol 1e-4, dq, dk and dv within 1e-4 of their own scale);
each counts as its TPU function's counter and by variant; two launches
of the wide pair give the same o, lse, dk and dv bit for bit. The f32 ViT
and a one-head ViT of head dim 256 are served and trained through them.
f16 runs the bf16 kernels' f16 builds at the bf16 tolerances (their dq
rounding pass exactly as ``Tensor.to(torch.float16)``), and calibrates to
f16 with one f16 ulp beside the f32 tolerance; bf16 and f16 raw frames
calibrate on both routes, aligned and not, to all three output types, with
one ulp of the output at the narrower of the raw and output precisions
beside the f32 tolerance; shapes the reference's gate
sends to its XLA formulation (head dim 64, S 2112) launch no kernel and
count the route; more than 65535 batch x heads run in slices; an f16 call
whose library cannot load raises.
The infeed's pinned batch arenas: pinned, one H2D a batch straight from
the arena and no host copy beside the batcher's, and no arena rewritten
while its copy is in flight (a checksum of every staged row); the shm
ring feeding the pipeline from a producer process. ``GlobalStreamConsumer``
on a one-rank NCCL group, its logits equal to the plain step's. The two-detector
fan-in with its steps under a side stream (the consumer's stream waits
for each copy: every frame reads its producer's values), and the
classic ``PeakNetUNet`` on the card against the CPU (``rel_err <
0.05``).
"""

import os
import threading
import time

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


def _ulp_tol(ref, out_dtype):
    """One ulp of ``ref`` in a 16-bit output type (0 for f32)."""
    bits = {torch.bfloat16: 8, torch.float16: 11}.get(out_dtype)
    if bits is None:
        return torch.zeros_like(ref)
    return torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - bits)


@pytest.mark.parametrize("w", [96, 95])  # 95: the scalar path (pixels % 4 != 0)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_calib_kernel_matches_plain(cuda, w, out_dtype):
    raw, ped, gain, mask = _calib_inputs(cuda, 3, 4, 64, w)
    got = pt.fused_calibrate(raw, ped, gain, mask, out_dtype=out_dtype)
    ref = fused_calibrate_plain(raw, ped, gain, mask, out_dtype=out_dtype).float()
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and pt.counts()["calib_kernel"] == 1
    tol = 1e-4 + 1e-5 * ref.abs() + _ulp_tol(ref, out_dtype)
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
        pt.fused_calibrate(raw, ped, gain, mask, out_dtype=torch.float64)
    with pytest.raises(ValueError):
        pt.fused_calibrate(raw, ped[:1], gain, mask)
    with pytest.raises(ValueError):
        pt.fused_calibrate(raw, ped.cpu(), gain, mask)


# (B, P, H, W, cluster) for calib_kernel's cluster route; cluster None: the
# plan's own choice. Panel 0 is all masked in every case.
CALIB_CLUSTER_CASES = [
    (2, 3, 301, 384, None),   # 8 CTAs of 38 rows, H % 8 != 0: the last holds 35
    (3, 2, 64, 95, None),     # w = 95: scalar loads, one CTA a panel
    (3, 2, 64, 95, 4),        # scalar loads across a cluster of 4
    (2, 2, 9, 384, 8),        # 2 rows a CTA, the last three CTAs hold none
    (2, 3, 352, 384, 4),      # epix10k2M panels at the other cluster size
    (1, 2, 512, 1024, None),  # jungfrau4M panels: a cluster of 16, or the two-pass route
]


def _assert_calib_close(got, ref, out_dtype):
    ref = ref.float()
    tol = 1e-4 + 1e-5 * ref.abs() + _ulp_tol(ref, out_dtype)
    assert got.dtype == out_dtype
    assert bool(torch.all((got.float() - ref).abs() <= tol))


@pytest.mark.parametrize("b,p,h,w,cluster", CALIB_CLUSTER_CASES)
@pytest.mark.parametrize("raw_dtype", [torch.float32, torch.uint16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_calib_cluster_route_matches_plain(cuda, b, p, h, w, cluster, raw_dtype, out_dtype):
    from psana_ray_tpu_torch.ops import fused_calib as fc

    raw, ped, gain, mask = _calib_inputs(cuda, b, p, h, w)
    if raw_dtype == torch.uint16:
        raw = torch.from_numpy(
            np.clip(np.rint(raw.cpu().numpy()), 0, 65535).astype(np.uint16)).to(cuda)
    plan = None if cluster is None else fc.calib_plan(h, w, cluster=cluster)
    chosen, load, active = fc.runnable_plan(raw, ped, gain, mask, out_dtype, plan)
    print(f"plan {chosen} load {load} active clusters {active}")  # pytest -rP
    if (h, w) == (301, 384):
        assert chosen.route == "cluster" and chosen.cluster == 8 and h % 8 != 0
    got = pt.fused_calibrate(raw, ped, gain, mask, out_dtype=out_dtype, plan=plan)
    again = pt.fused_calibrate(raw, ped, gain, mask, out_dtype=out_dtype, plan=plan)
    ref = fused_calibrate_plain(raw, ped, gain, mask, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert pt.counts()["calib_kernel"] == 2
    _assert_calib_close(got, ref, out_dtype)
    assert bool(torch.all(got[:, 0] == 0))  # the all-masked panel
    assert torch.equal(got, again)  # the cluster's partials are summed in rank order


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_calib_cluster_route_single_frame_and_two_pass(cuda, out_dtype):
    from psana_ray_tpu_torch.ops import fused_calib as fc

    raw, ped, gain, mask = _calib_inputs(cuda, 2, 3, 301, 384)
    one = pt.fused_calibrate(raw[1], ped, gain, mask, out_dtype=out_dtype)
    assert one.shape == raw.shape[1:]
    _assert_calib_close(one, fused_calibrate_plain(raw[1], ped, gain, mask, out_dtype=out_dtype),
                        out_dtype)
    both = pt.fused_calibrate(raw, ped, gain, mask, out_dtype=out_dtype)
    assert torch.equal(one, both[1])
    two_pass = pt.fused_calibrate(raw, ped, gain, mask, out_dtype=out_dtype, plan=fc.TWO_PASS)
    _assert_calib_close(two_pass, both.float(), out_dtype)
    assert pt.counts()["calib_kernel"] == 3


# (B, P, H, W, plan) for 16-bit raw: "auto" is the plan's own choice
CALIB_RAW16_CASES = [
    (2, 3, 301, 384, "auto"),      # cluster of 8, ragged last slice, vector loads
    (3, 2, 64, 95, "auto"),        # w = 95: scalar loads, one CTA a panel
    (2, 3, 352, 384, 4),           # epix10k2M panels, a cluster of 4
    (2, 3, 301, 384, "two_pass"),  # the two-pass route, vector loads
    (3, 2, 64, 95, "two_pass"),    # the two-pass route, scalar loads
]


def _raw16(raw, raw_dtype, aligned):
    """``raw`` in ``raw_dtype``, contiguous; ``aligned`` False: at an
    address two bytes past a vector boundary (scalar loads)."""
    if aligned:
        return raw.to(raw_dtype)
    buf = torch.empty(raw.numel() + 1, dtype=raw_dtype, device=raw.device)
    out = buf[1:].view(raw.shape)
    out.copy_(raw)
    return out


@pytest.mark.parametrize("b,p,h,w,plan", CALIB_RAW16_CASES)
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("raw_dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_calib_kernel_takes_16_bit_raw(cuda, b, p, h, w, plan, aligned, raw_dtype, out_dtype):
    """bf16 and f16 raw against the plain version (each op in the raw
    dtype, the background sum and count in f32): f32 tolerance plus one ulp
    at the narrower of the raw and output precisions; two launches equal."""
    from psana_ray_tpu_torch.ops import fused_calib as fc

    raw, ped, gain, mask = _calib_inputs(cuda, b, p, h, w)
    raw = _raw16(raw, raw_dtype, aligned)
    ped, gain = ped.to(raw_dtype), gain.to(raw_dtype)
    plan = {"auto": None, "two_pass": fc.TWO_PASS}[plan] if isinstance(plan, str) else (
        fc.calib_plan(h, w, cluster=plan))
    chosen, load, _ = fc.runnable_plan(raw, ped, gain, mask, out_dtype, plan)
    assert (load == fc.LOAD_SCALAR) == (not aligned or w % 4 != 0)
    if plan is fc.TWO_PASS:
        assert chosen.route == "two_pass"
    got = pt.fused_calibrate(raw, ped, gain, mask, out_dtype=out_dtype, plan=plan)
    again = pt.fused_calibrate(raw, ped, gain, mask, out_dtype=out_dtype, plan=plan)
    ref = fused_calibrate_plain(raw, ped, gain, mask, out_dtype=out_dtype).float()
    torch.cuda.synchronize()
    assert pt.counts()["calib_kernel"] == 2 and got.dtype == out_dtype
    narrow = max(raw_dtype, out_dtype, key=lambda t: torch.finfo(t).eps)
    tol = 1e-4 + 1e-5 * ref.abs() + _ulp_tol(ref, narrow)
    assert bool(torch.isfinite(got.float()).all())
    assert bool(torch.all((got.float() - ref).abs() <= tol))
    assert bool(torch.all(got[:, 0] == 0))  # the all-masked panel
    assert torch.equal(got, again)


def test_calib_kernel_16_bit_raw_at_a_real_panel_count(cuda):
    """An epix10k2M panel in f16: a count past 65504, which the f32 sums
    take (the reference's f16 ones overflow); the output finite and equal
    to the plain version's within one f16 ulp."""
    raw, ped, gain, mask = _calib_inputs(cuda, 2, 2, 352, 384)
    raw, ped, gain = raw.half(), ped.half(), gain.half()
    got = pt.fused_calibrate(raw, ped, gain, mask)
    ref = fused_calibrate_plain(raw, ped, gain, mask).float()
    assert got.dtype == torch.float16 and bool(torch.isfinite(got).all())
    tol = 1e-4 + 1e-5 * ref.abs() + _ulp_tol(ref, torch.float16)
    assert bool(torch.all((got.float() - ref).abs() <= tol))


def test_calib_kernel_16_bit_raw_raises_when_its_library_fails(cuda, monkeypatch):
    """No fallback: a bf16 raw call whose library cannot load raises."""
    from psana_ray_tpu_torch.ops import fused_calib as fc

    raw, ped, gain, mask = _calib_inputs(cuda, 1, 2, 32, 64)

    def broken(name):
        raise RuntimeError(f"cannot load lib{name}.so")

    monkeypatch.setattr(fc.build, "library", broken)
    fc.active_clusters.cache_clear()
    with pytest.raises(RuntimeError, match="cannot load"):
        pt.fused_calibrate(raw.bfloat16(), ped, gain, mask)
    assert pt.counts()["calib_kernel"] == 0


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
    """f64 raises on the card; the direct launch raises on the shapes the
    gate sends to the XLA route (head dim 64, S 192)."""
    from psana_ray_tpu_torch.parallel import flash as tf

    z = torch.zeros((1, 2, 128, 128), device=cuda, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="f64"):
        tf.attention_with_stats(z, z, z)
    with pytest.raises(NotImplementedError, match="head dim"):
        tf.launch_flash(*(torch.zeros((1, 2, 128, 64), device=cuda).bfloat16(),) * 3)
    with pytest.raises(ValueError, match="multiples of 128"):
        tf.launch_flash(*(torch.zeros((1, 2, 192, 128), device=cuda).bfloat16(),) * 3)
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

    with pytest.raises(NotImplementedError, match="f64"):
        call((1, 2, 128, 128), torch.float64)
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


# -- the other variants of K5-K7: bf16 at head dims 256-1024, f32 ------------

F32_O_TOL, F32_LSE_TOL, F32_BWD_TOL = 2e-5, 1e-4, 1e-4
VARIANT_CASES = [  # (dtype, d, bh, sq, sk, causal)
    (torch.bfloat16, 256, 3, 256, 256, False), (torch.bfloat16, 256, 2, 384, 128, True),
    (torch.bfloat16, 384, 2, 256, 768, True), (torch.bfloat16, 512, 2, 256, 256, False),
    (torch.bfloat16, 1024, 2, 256, 384, False), (torch.bfloat16, 1024, 1, 256, 256, True),
    (torch.float32, 128, 3, 256, 256, False), (torch.float32, 128, 2, 640, 384, True),
    (torch.float32, 256, 2, 128, 384, True), (torch.float32, 640, 2, 256, 256, False),
    (torch.float32, 1024, 1, 256, 384, False), (torch.float32, 1024, 1, 256, 256, True),
    (torch.float32, 1024, 2, 384, 256, True),  # a cluster of 8, causal, Sq != Sk
]


def _variant_inputs(gen, cuda, dtype, d, bh, sq, sk):
    def mk(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    return mk(1, bh, sq, d), mk(1, bh, sk, d), mk(1, bh, sk, d), mk(1, bh, sq, d)


@pytest.mark.parametrize("dtype,d,bh,sq,sk,causal", VARIANT_CASES)
def test_flash_variants_match_plain(cuda, gen, dtype, d, bh, sq, sk, causal):
    """``flash_wide_kernel`` (bf16) and ``flash_f32_kernel`` against
    ``attention_with_stats_plain``: unit-scale inputs, causal and uneven
    lengths; one launch, counted as ``flash_kernel`` and by variant."""
    from psana_ray_tpu_torch.parallel import flash as tf

    q, k, v, _ = _variant_inputs(gen, cuda, dtype, d, bh, sq, sk)
    o, lse = tf.attention_with_stats(q, k, v, causal=causal)
    o_ref, lse_ref = tf.attention_with_stats_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    name = tf.forward_kernel(q)
    assert name == ("flash_f32_kernel" if dtype == torch.float32 else "flash_wide_kernel")
    assert pt.counts()["flash_kernel"] == 1
    assert pt.variant_counts() == {(name, tf.KERNEL_DTYPES[dtype], d): 1}
    assert o.dtype == dtype and lse.dtype == torch.float32
    d_o = float((o.float() - o_ref.float()).abs().max())
    d_lse = float((lse - lse_ref).abs().max())
    if dtype == torch.float32:
        assert d_o <= F32_O_TOL and d_lse <= F32_LSE_TOL, (d_o, d_lse)
    else:
        assert d_o <= 2e-2 and d_lse <= 1e-2, (d_o, d_lse)
        assert d_o <= 1e-2 * float(o_ref.float().abs().max())
        assert d_lse <= 1e-2 * float((lse_ref - _flat_lse(sq, sk, causal, cuda)).abs().max())


def test_flash_f32_at_the_serving_width(cuda, gen):
    """``flash_f32_kernel`` at the f32 ViT's serving shape (BH 8, S 8448,
    D 128: 132 query tiles a head) against ``attention_with_stats_plain``
    at the f32 tolerances."""
    from psana_ray_tpu_torch.parallel import flash as tf

    q, k, v, _ = _variant_inputs(gen, cuda, torch.float32, 128, 8, 8448, 8448)
    o, lse = tf.attention_with_stats(q, k, v)
    o_ref, lse_ref = tf.attention_with_stats_plain(q, k, v)
    torch.cuda.synchronize()
    assert pt.variant_counts() == {("flash_f32_kernel", "f32", 128): 1}
    d_o = float((o - o_ref).abs().max())
    d_lse = float((lse - lse_ref).abs().max())
    assert d_o <= F32_O_TOL and d_lse <= F32_LSE_TOL, (d_o, d_lse)


@pytest.mark.parametrize("dtype,d,bh,sq,sk,causal", VARIANT_CASES)
def test_flash_bwd_variants_match_plain(cuda, gen, dtype, d, bh, sq, sk, causal):
    """``flash_bwd_wide_kernel`` (bf16, then ``flash_bwd_dq_convert``) and
    ``flash_bwd_f32_kernel`` (dq summed in f32, no rounding launch) against
    ``attention_bwd_plain`` with an lse cotangent; two more launches of the
    kernel give identical dk and dv and f32 dq sums (dq_acc, before any
    rounding) within 2**-16 of their largest value: they arrive in
    another order."""
    from psana_ray_tpu_torch.parallel import flash as tf

    q, k, v, do = _variant_inputs(gen, cuda, dtype, d, bh, sq, sk)
    dl = torch.randn((1, bh, sq), generator=gen, device=cuda)
    o, lse = tf.launch_flash(q, k, v, causal)
    pt.reset_counters()
    got = tf.launch_flash_bwd(q, k, v, o, lse, do, causal, dl)
    ref = tf.attention_bwd_plain(q, k, v, o, lse, do, causal, dl)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    name = tf.backward_kernel(q)
    assert name == ("flash_bwd_f32_kernel" if f32 else "flash_bwd_wide_kernel")
    assert pt.counts()["flash_bwd_kernel"] == 1
    assert pt.counts()["flash_bwd_dq_convert"] == (0 if f32 else 1)
    assert pt.variant_counts().get((name, tf.KERNEL_DTYPES[dtype], d)) == 1
    for grad, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == dtype and g.shape == r.shape, grad
        assert bool(torch.isfinite(g.float()).all()), grad
        assert rel_err(r, g) <= (F32_BWD_TOL if f32 else BWD_TOL), (grad, rel_err(r, g))
    _assert_repeat_agrees(tf, q, k, v, o, lse, do, causal, dl, got)


def _assert_repeat_agrees(tf, q, k, v, o, lse, do, causal, dlse, got):
    """Two more launches of the backward kernel on the inputs that gave
    ``got``: dk and dv identical to it, their f32 dq sums within 2**-16 of
    the largest (an unzeroed dq_acc or a lost reduction differs by far
    more)."""
    delta = tf.flash_bwd_delta(o, do, dlse)
    (acc1, dk1, dv1), (acc2, dk2, dv2) = (
        tf.launch_flash_bwd_kernel(q, k, v, do, lse, delta, causal) for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(got[1], x) for x in (dk1, dk2))
    assert all(torch.equal(got[2], x) for x in (dv1, dv2))
    scale = float(acc1.abs().max())
    assert scale > 0.0
    assert float((acc1 - acc2).abs().max()) <= 2.0 ** -16 * scale


@pytest.mark.parametrize("d,causal", [(256, False), (256, True), (640, True), (1024, False)])
def test_wide_pair_repeat_launches_agree_bit_for_bit(cuda, gen, d, causal):
    """The wide pair forms each score tile once, its slices' partials summed
    in a fixed order (one CTA's two warpgroups at D 256, a cluster's CTAs
    above): two launches on the same inputs give the same o, lse, dk and
    dv bit for bit, and dq's f32 sums within 2**-16 of their largest value
    (they arrive in another order each run)."""
    from psana_ray_tpu_torch.parallel import flash as tf

    q, k, v, do = _variant_inputs(gen, cuda, torch.bfloat16, d, 2, 384, 256)
    o1, lse1 = tf.launch_flash(q, k, v, causal)
    o2, lse2 = tf.launch_flash(q, k, v, causal)
    got = tf.launch_flash_bwd(q, k, v, o1, lse1, do, causal)
    torch.cuda.synchronize()
    assert tf.forward_kernel(q) == "flash_wide_kernel"
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    _assert_repeat_agrees(tf, q, k, v, o1, lse1, do, causal, None, got)


def test_flash_variants_refuse_what_they_do_not_take(cuda):
    """f64 and, in the direct launches, head dim 1152 raise before any
    launch; the C entry points refuse what their kernel does not take (the
    wide pair head dim 128, the f32 pair head dim 64)."""
    from psana_ray_tpu_torch.kernels import build
    from psana_ray_tpu_torch.parallel import flash as tf

    for shape, dtype, match in (((1, 2, 128, 256), torch.float64, "f64"),
                                ((1, 2, 128, 1152), torch.float32, "head dim"),
                                ((1, 2, 128, 1152), torch.float16, "head dim"),
                                ((1, 2, 128, 1152), torch.bfloat16, "head dim")):
        z = torch.zeros(shape, device=cuda, dtype=dtype)
        with pytest.raises(NotImplementedError, match=match):
            tf.launch_flash(z, z, z)
        with pytest.raises(NotImplementedError, match=match):
            tf.launch_flash_bwd(z, z, z, z, torch.zeros(shape[:3], device=cuda), z)
    assert sum(pt.counts().values()) == 0 and pt.variant_counts() == {}
    stream = torch.cuda.current_stream().cuda_stream
    zb = torch.zeros((1, 128, 128), device=cuda).bfloat16()
    zf = torch.zeros((1, 128, 128), device=cuda)
    lse = torch.zeros(128, device=cuda)
    assert build.library("flash_wide").flash_wide_launch(
        *(zb.data_ptr(),) * 4, lse.data_ptr(), 1, 128, 128, 128, 0.1, 0, stream) != 0
    assert build.library("flash_bwd_wide").flash_bwd_wide_launch(
        *(zb.data_ptr(),) * 4, lse.data_ptr(), lse.data_ptr(), *(zb.data_ptr(),) * 2,
        zf.data_ptr(), 1, 128, 128, 128, 0.1, 0, stream) != 0
    assert build.library("flash_f32").flash_f32_launch(
        *(zf.data_ptr(),) * 4, lse.data_ptr(), 1, 128, 128, 64, 0.1, 0, stream) != 0
    assert build.library("flash_f32").flash_bwd_f32_launch(
        *(zf.data_ptr(),) * 4, lse.data_ptr(), lse.data_ptr(), *(zf.data_ptr(),) * 3,
        2, 128, 128, 64, 0.1, 0, stream) != 0


@pytest.mark.parametrize("dtype,num_heads", [(torch.float32, 2), (torch.bfloat16, 1)])
def test_f32_and_wide_vit_on_the_card(cuda, dtype, num_heads):
    """The small ViT (patch 8, embed 256, depth 2, 256 tokens) in f32 with
    2 heads of 128 and in bf16 with one head of 256: served against the
    plain attention (``rel_err`` 1e-4 in f32, 0.05 in bf16) and one train
    step, each block launching its variant's forward and backward once."""
    from psana_ray_tpu_torch.parallel import flash as tf

    params = pt.init_vit_params((2, 64, 128), patch=8, embed_dim=256, depth=2, seed=1)
    model = pt.vit_from_flax(params, num_heads=num_heads, dtype=dtype, device=cuda)
    plain = pt.vit_from_flax(
        params, num_heads=num_heads, dtype=dtype, device=cuda,
        attn_fn=lambda q, k, v: tf.attention_with_stats_plain(
            *(t.transpose(1, 2) for t in (q, k, v)))[0].transpose(1, 2))
    x = torch.randn((2, 2, 64, 128), generator=torch.Generator(cuda).manual_seed(1), device=cuda)
    with torch.no_grad():
        got, ref = model(x), plain(x)
    d = 256 // num_heads
    fwd = "flash_f32_kernel" if dtype == torch.float32 else "flash_wide_kernel"
    key = tf.KERNEL_DTYPES[dtype]
    assert pt.variant_counts() == {(fwd, key, d): 2}
    assert tuple(got.shape) == (2, 2) and bool(torch.isfinite(got).all())
    assert rel_err(ref, got) <= (1e-4 if dtype == torch.float32 else REL_TOL)
    pt.reset_counters()
    opt = pt.adamw(model.parameters(), pt.warmup_cosine_decay_schedule(0.0, 6e-4, 2, 10, 1e-5),
                   weight_decay=0.01)
    step = pt.make_train_step(model, opt, lambda lg, aux: pt.masked_softmax_xent(lg, *aux))
    loss = step(x, (torch.tensor([0, 1], device=cuda), torch.ones(2, dtype=torch.uint8, device=cuda)))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss))
    f32 = dtype == torch.float32
    assert pt.counts() == {"calib_kernel": 0, **NO_CONV, "flash_kernel": 2, "flash_bwd_kernel": 2,
                           "flash_bwd_dq_convert": 0 if f32 else 2}
    assert pt.variant_counts()[(fwd.replace("flash_", "flash_bwd_", 1), key, d)] == 2
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())


def test_vit_serve_step_calibrates_to_the_model_dtype(cuda):
    """An f32 ViT is served from f32 calibrated frames (``calib_kernel``
    with f32 output), a bf16 one from bf16 frames, an f16 one from f16
    frames: 2 RAW epix100 frames at patch 8 (8,448 tokens), against the
    same model on the plain calibration's output in its dtype."""
    src = pt.SyntheticSource(num_events=2, detector_name="epix100", seed=0)
    frames = torch.from_numpy(
        np.stack([src.event(i, pt.RetrievalMode.RAW)[0] for i in range(2)])).to(cuda)
    ped, gain, mask = (torch.from_numpy(a).to(cuda) for a in
                       (src.pedestal(), src.gain_map(), src.create_bad_pixel_mask()))
    tree = pt.init_vit_params(src.spec.frame_shape, patch=8, embed_dim=256, depth=2, seed=0)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        pt.reset_counters()
        model = pt.vit_from_flax(tree, num_heads=2, dtype=dtype, device=cuda)
        logits = pt.vit_serve_step(model, frames, ped, gain, mask)
        torch.cuda.synchronize()
        with torch.no_grad():
            ref = model(fused_calibrate_plain(frames, ped, gain, mask, threshold=10.0,
                                              out_dtype=dtype))
        assert tuple(logits.shape) == (2, 2) and bool(torch.isfinite(logits).all())
        assert pt.counts()["calib_kernel"] == 1 and pt.counts()["flash_kernel"] == 4
        assert rel_err(ref, logits) <= (1e-4 if dtype == torch.float32 else REL_TOL)


# -- the rest of K5-K7's domain: f16, the XLA route, any batch x heads ------

F16_CASES = [  # (d, bh, sq, sk, causal): every f16 library, causal and uneven lengths
    (128, 3, 256, 256, False), (128, 2, 640, 384, True), (256, 3, 256, 256, False),
    (256, 2, 384, 128, True), (384, 2, 256, 768, True), (512, 2, 256, 256, False),
    (1024, 2, 256, 384, False), (1024, 1, 256, 256, True),
]


@pytest.mark.parametrize("d,bh,sq,sk,causal", F16_CASES)
def test_flash_f16_kernels_match_plain(cuda, gen, d, bh, sq, sk, causal):
    """The f16 builds of ``flash_kernel`` and ``flash_wide_kernel`` against
    ``attention_with_stats_plain`` (p rounded to f16 for p.v) at the bf16
    tolerances; one launch, counted as ``flash_kernel`` and by variant."""
    from psana_ray_tpu_torch.parallel import flash as tf

    q, k, v, _ = _variant_inputs(gen, cuda, torch.float16, d, bh, sq, sk)
    o, lse = tf.attention_with_stats(q, k, v, causal=causal)
    o_ref, lse_ref = tf.attention_with_stats_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    name = tf.forward_kernel(q)
    assert name == ("flash_kernel" if d == 128 else "flash_wide_kernel")
    assert pt.counts()["flash_kernel"] == 1 and pt.variant_counts() == {(name, "f16", d): 1}
    assert o.dtype == torch.float16 and lse.dtype == torch.float32
    d_o = float((o.float() - o_ref.float()).abs().max())
    d_lse = float((lse - lse_ref).abs().max())
    assert d_o <= 2e-2 and d_lse <= 1e-2, (d_o, d_lse)
    assert d_o <= 1e-2 * float(o_ref.float().abs().max())
    assert d_lse <= 1e-2 * float((lse_ref - _flat_lse(sq, sk, causal, cuda)).abs().max())
    again = tf.launch_flash(q, k, v, causal)
    torch.cuda.synchronize()
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


@pytest.mark.parametrize("d,bh,sq,sk,causal", F16_CASES)
def test_flash_bwd_f16_kernels_match_plain(cuda, gen, d, bh, sq, sk, causal):
    """The f16 builds of ``flash_bwd_kernel`` and ``flash_bwd_wide_kernel``
    (then the f16 ``flash_bwd_dq_convert``) against ``attention_bwd_plain``
    with an lse cotangent (p and ds rounded to f16 in the kernels, f32 in
    the plain version), within 1e-2 of each gradient's scale; two more
    launches agree as the bf16 kernels' do."""
    from psana_ray_tpu_torch.parallel import flash as tf

    q, k, v, do = _variant_inputs(gen, cuda, torch.float16, d, bh, sq, sk)
    dl = torch.randn((1, bh, sq), generator=gen, device=cuda)
    o, lse = tf.launch_flash(q, k, v, causal)
    pt.reset_counters()
    got = tf.launch_flash_bwd(q, k, v, o, lse, do, causal, dl)
    ref = tf.attention_bwd_plain(q, k, v, o, lse, do, causal, dl)
    torch.cuda.synchronize()
    name = tf.backward_kernel(q)
    assert name == ("flash_bwd_kernel" if d == 128 else "flash_bwd_wide_kernel")
    assert pt.counts()["flash_bwd_kernel"] == 1 and pt.counts()["flash_bwd_dq_convert"] == 1
    assert pt.variant_counts() == {(name, "f16", d): 1, ("flash_bwd_dq_convert", "f16", d): 1}
    for grad, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.float16 and g.shape == r.shape, grad
        assert bool(torch.isfinite(g.float()).all()), grad
        assert rel_err(r, g) <= BWD_TOL, (grad, rel_err(r, g))
    _assert_repeat_agrees(tf, q, k, v, o, lse, do, causal, dl, got)


def test_flash_bwd_dq_convert_rounds_to_f16_once(cuda, gen):
    """The f16 build's ``flash_bwd_dq_convert``: the f32 sums rounded as
    ``Tensor.to(torch.float16)`` rounds them (nearest even; overflow to
    inf past 65504, as the reference's cast), exactly."""
    from psana_ray_tpu_torch.parallel import flash as tf

    acc = torch.randn((3, 5, 132), generator=gen, device=cuda) * torch.exp2(
        torch.randint(-30, 18, (3, 5, 132), generator=gen, device=cuda).float())
    acc[0, 0, :4] = torch.tensor([0.0, -0.0, 1.0 + 2.0 ** -11, 70000.0], device=cuda)
    dq = tf.launch_flash_bwd_dq_convert(acc, torch.float16)
    torch.cuda.synchronize()
    assert dq.dtype == torch.float16 and dq.shape == acc.shape
    assert torch.equal(dq.view(torch.int16), acc.to(torch.float16).view(torch.int16))
    assert pt.variant_counts() == {("flash_bwd_dq_convert", "f16", 132): 1}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("d,s", [(64, 256), (128, 2112)])
def test_xla_route_runs_the_plain_formulation_and_no_kernel(cuda, gen, dtype, d, s):
    """Head dim 64 and S 2112 (not multiples of 128: the reference's
    ``_kernel_shapes_ok`` refuses them): forward and backward through
    ``attention_with_stats`` are the plain versions' results, no kernel
    launches, and each direction counts one XLA-route call."""
    from psana_ray_tpu_torch.parallel import flash as tf

    q, k, v, do = _variant_inputs(gen, cuda, dtype, d, 2, s, s)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = tf.attention_with_stats(*leaves, causal=True)
    o.backward(do)
    o_ref, lse_ref = tf.attention_with_stats_plain(q, k, v, causal=True)
    ref = tf.attention_bwd_plain(q, k, v, o_ref, lse_ref, do, causal=True)
    torch.cuda.synchronize()
    assert sum(pt.counts().values()) == 0
    assert pt.route_counts() == {"attention_xla_route": 1, "attention_bwd_xla_route": 1}
    key = tf.KERNEL_DTYPES[dtype]
    assert pt.variant_counts() == {("attention_xla_route", key, d): 1,
                                   ("attention_bwd_xla_route", key, d): 1}
    assert torch.equal(o.detach(), o_ref) and torch.equal(lse.detach(), lse_ref)
    for t, r in zip(leaves, ref):
        assert torch.equal(t.grad, r)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_more_than_65535_batch_by_heads_run_in_slices(cuda, gen, dtype):
    """BH 65664 at S 128, D 128: two launches of each kernel (65535 rows,
    then 129), the rows on both sides of the seam and the last ones against
    the plain versions on those rows."""
    from psana_ray_tpu_torch.parallel import flash as tf

    bh = 65536 + 128
    q, k, v, do = _variant_inputs(gen, cuda, dtype, 128, bh, 128, 128)
    o, lse = tf.launch_flash(q, k, v)
    got = tf.launch_flash_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    slices = 2
    f32 = dtype == torch.float32
    assert pt.counts()["flash_kernel"] == slices and pt.counts()["flash_bwd_kernel"] == slices
    assert pt.counts()["flash_bwd_dq_convert"] == (0 if f32 else 1)
    for rows in (slice(0, 4), slice(65535 - 4, 65535 + 4), slice(bh - 4, bh)):
        part = [t[:, rows] for t in (q, k, v, do)]
        o_ref, lse_ref = tf.attention_with_stats_plain(*part[:3])
        ref = tf.attention_bwd_plain(*part[:3], o[:, rows], lse[:, rows], part[3])
        d_o = float((o[:, rows].float() - o_ref.float()).abs().max())
        d_lse = float((lse[:, rows] - lse_ref).abs().max())
        assert d_o <= (F32_O_TOL if f32 else 2e-2) and d_lse <= (F32_LSE_TOL if f32 else 1e-2)
        for grad, g, r in zip(("dq", "dk", "dv"), got, ref):
            assert rel_err(r, g[:, rows]) <= (F32_BWD_TOL if f32 else BWD_TOL), (grad, rows)


def test_an_in_domain_f16_call_raises_when_its_library_fails(cuda, monkeypatch):
    """Nothing falls back: an f16 shape the gate takes, whose f16 library
    cannot load, raises from the forward and from the backward, and takes
    no XLA route."""
    from psana_ray_tpu_torch.kernels import build
    from psana_ray_tpu_torch.parallel import flash as tf

    load = build.library

    def broken(name):
        if name.endswith("_f16"):
            raise RuntimeError(f"cannot load kernel library lib{name}.so")
        return load(name)

    monkeypatch.setattr(build, "library", broken)
    z = torch.zeros((1, 2, 128, 128), device=cuda, dtype=torch.float16)
    with pytest.raises(RuntimeError, match="libflash_f16"):
        tf.attention_with_stats(z, z, z)
    with pytest.raises(RuntimeError, match="libflash_bwd_f16"):
        tf.FlashAttention.backward(
            type("Ctx", (), {"saved_tensors": (z, z, z, z, torch.zeros((1, 2, 128), device=cuda)),
                             "causal": False})(), z, None)
    assert sum(pt.counts().values()) == 0
    assert pt.route_counts() == {"attention_xla_route": 0, "attention_bwd_xla_route": 0}


@pytest.mark.parametrize("dtype,num_heads", [(torch.float16, 2), (torch.bfloat16, 4)])
def test_f16_and_head_dim_64_vit_on_the_card(cuda, dtype, num_heads):
    """The small ViT (patch 8, embed 256, depth 2, 256 tokens) in f16 with 2
    heads of 128 (the f16 kernels) and in bf16 with 4 heads of 64 (the XLA
    route): served against the same weights in f32 (``rel_err < 0.05``) and
    one train step with its launches or route calls counted."""
    from psana_ray_tpu_torch.parallel import flash as tf

    params = pt.init_vit_params((2, 64, 128), patch=8, embed_dim=256, depth=2, seed=1)
    model = pt.vit_from_flax(params, num_heads=num_heads, dtype=dtype, device=cuda)
    f32 = pt.vit_from_flax(params, num_heads=num_heads, dtype=torch.float32, device=cuda)
    x = torch.randn((2, 2, 64, 128), generator=torch.Generator(cuda).manual_seed(1), device=cuda)
    with torch.no_grad():
        got = model(x)
        pt.reset_counters()
        ref = f32(x)
    d = 256 // num_heads
    xla = d == 64
    assert tuple(got.shape) == (2, 2) and bool(torch.isfinite(got).all())
    assert rel_err(ref, got) < REL_TOL
    pt.reset_counters()
    opt = pt.adamw(model.parameters(), pt.warmup_cosine_decay_schedule(0.0, 6e-4, 2, 10, 1e-5),
                   weight_decay=0.01)
    step = pt.make_train_step(model, opt, lambda lg, aux: pt.masked_softmax_xent(lg, *aux))
    loss = step(x, (torch.tensor([0, 1], device=cuda), torch.ones(2, dtype=torch.uint8, device=cuda)))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss))
    key = tf.KERNEL_DTYPES[dtype]
    if xla:
        assert sum(pt.counts().values()) == 0
        assert pt.route_counts() == {"attention_xla_route": 2, "attention_bwd_xla_route": 2}
    else:
        assert pt.counts() == {"calib_kernel": 0, **NO_CONV, "flash_kernel": 2,
                               "flash_bwd_kernel": 2, "flash_bwd_dq_convert": 2}
        assert pt.variant_counts() == {("flash_kernel", key, d): 2, ("flash_bwd_kernel", key, d): 2,
                                       ("flash_bwd_dq_convert", key, d): 2}
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())


# -- the infeed: pinned batch arenas, one host copy a frame ------------------


def _index_frames(n, shape):
    """Events whose every pixel is the event's index."""
    return ((i, np.full(shape, float(i), np.float32), 1.0) for i in range(n))


def _rows_hold_their_index(batch):
    """Per valid row: are all its pixels its event index (a checksum that
    a rewritten arena breaks)?"""
    rows = batch.frames.flatten(1)
    idx = torch.as_tensor(batch.event_idx, device=rows.device).float()[:, None]
    ok = (rows == idx).all(1)
    valid = torch.as_tensor(batch.valid, device=rows.device).bool()
    return ok[valid]


def test_pinned_arenas_one_h2d_a_batch_and_no_host_copy(cuda, monkeypatch):
    from psana_ray_tpu_torch.infeed.pipeline import DevicePrefetcher

    def no_host_copy(self, arrays):
        raise AssertionError("a batch from a pinned arena went through the pinned-slot copy")

    monkeypatch.setattr(DevicePrefetcher, "_stage_arrays", no_host_copy)
    shape, n, b = (2, 64, 96), 27, 4
    ring = pt.RingBuffer(maxsize=3 * b)
    thread = threading.Thread(target=pt.produce, args=(_index_frames(n, shape), ring), daemon=True)
    thread.start()
    pipe = pt.InfeedPipeline(ring, batch_size=b, device=cuda, prefetch_depth=2, batcher_buffers=6)
    checks = []
    assert pipe.run(lambda batch: _rows_hold_their_index(batch),
                    on_result=lambda ok, batch: checks.append(ok)) == n
    thread.join(timeout=10)
    assert bool(torch.cat(checks).all()) and sum(len(c) for c in checks) == n
    pool = pipe.batcher.pool
    assert len(pool) == 6 and all(t.is_pinned() for a in pool for t in a.tensors)
    s = pipe.metrics.summary()
    assert s["arena_copies"] == s["batches"] == 7
    assert s["host_frame_bytes_per_frame"] == 4 * np.prod(shape)  # the batcher's copy, only


def test_global_stream_consumer_on_a_one_rank_nccl_group(cuda):
    """Config 4's chain (K1 to bf16, the fused ResNet) through
    ``GlobalStreamConsumer`` on a one-rank NCCL group: three rounds of
    rows (the last one padded), each round's logits a DTensor whose rows
    equal the plain step's on the same frames, and the valid count through
    NCCL once a round and once more at the end."""
    import torch.distributed as dist

    from psana_ray_tpu_torch.parallel import compat
    from psana_ray_tpu_torch.parallel import mesh as pm

    shape, n, b = (4, 64, 64), 10, 4
    rng = np.random.default_rng(5)
    ped, gain = np.full(shape, 100.0, np.float32), np.ones(shape, np.float32)
    consts = [torch.from_numpy(a).to(cuda) for a in (ped, gain, np.ones(shape, np.uint8))]
    packed = pt.pack_fused(pt.resnet_from_flax(pt.init_resnet_params(in_channels=4, width=16,
                                                                      seed=3), device=cuda))

    def serve(frames):
        cal = pt.fused_calibrate(frames, *consts, threshold=10.0, out_dtype=torch.bfloat16)
        return pt.resnet_fused_infer(packed, pt.panels_to_nhwc(cal))

    ring = pt.RingBuffer(maxsize=n + 1)
    pt.produce(((i, (100.0 + 30.0 * rng.random(shape)).astype(np.float32), 9.5)
                for i in range(n)), ring)
    pm.init_process_group(0, 1, pm.free_port(), device=cuda)
    try:
        mesh = pt.create_mesh(("data",), (1,), device_type="cuda")
        infer = pt.make_infer_step(serve, mesh)
        seen = []
        compat.reset_collectives()
        consumer = pt.GlobalStreamConsumer(ring, local_batch_size=b, mesh=mesh, frame_shape=shape)
        assert consumer.run(lambda batch: infer(batch.frames),
                            on_result=lambda out, g: seen.append((out, g))) == n
        assert compat.collective_counts() == {"all_reduce/nccl": 4}
    finally:
        dist.destroy_process_group()
    assert [g.num_valid for _, g in seen] == [4, 4, 2]
    for out, g in seen:
        assert isinstance(out, compat.DTensor) and out.to_local().is_cuda
        assert torch.equal(out.to_local(), serve(g.frames.to_local()))
    assert pt.counts()["calib_kernel"] == 3 + 3


def test_an_arena_is_not_rewritten_while_its_copy_is_in_flight(cuda):
    """Two arenas (below the pipeline's floor, so the fence alone guards
    them) and every H2D copy held back ~25 ms on the copy stream: a
    batcher that did not wait on the fence would overwrite an arena before
    its copy ran. A slow consumer on top."""
    from psana_ray_tpu_torch.infeed.batcher import FrameBatcher
    from psana_ray_tpu_torch.infeed.pipeline import DevicePrefetcher, pinned_arena

    class HeldCopies(DevicePrefetcher):
        def _to_device(self, tensors):
            with torch.cuda.stream(self._copy_stream):
                torch.cuda._sleep(50_000_000)
            return super()._to_device(tensors)

    shape, n, b = (4, 256, 256), 40, 8
    ring = pt.RingBuffer(maxsize=n + 1)
    pt.produce(_index_frames(n, shape), ring)
    batcher = FrameBatcher(b, n_buffers=2, new_arena=pinned_arena)
    batches = pt.batches_from_queue(ring, b, batcher=batcher)
    checks = []
    with HeldCopies(batches, device=cuda, prefetch_depth=1) as pf:
        for batch in pf:
            time.sleep(0.005)  # a slow consumer
            checks.append(_rows_hold_their_index(batch))
    assert len(checks) == n // b and bool(torch.cat(checks).all())
    assert pf.metrics.arena_copies == n // b


def test_shm_ring_feeds_the_pipeline_on_the_card(cuda):
    import multiprocessing as mp

    name, n, b = f"gpu_shm_{os.getpid()}", 10, 4
    owner = pt.ShmRingBuffer.create(name, maxsize=8, slot_bytes=1 << 20)
    try:
        proc = mp.get_context("spawn").Process(target=pt.produce_synthetic,
                                               args=(name, "smoke_a", n, 3))
        proc.start()
        pipe = pt.InfeedPipeline(owner, batch_size=b, device=cuda, batcher_buffers=6,
                                 max_wait_s=60.0)
        frames = []
        assert pipe.run(lambda batch: batch.frames.clone(),
                        on_result=lambda out, batch: frames.append(out[:batch.num_valid])) == n
        proc.join(timeout=60)
        assert proc.exitcode == 0 and owner.stats()["bytes_copied_out"] == 0
    finally:
        owner.destroy()
    src = pt.SyntheticSource(num_events=3, detector_name="smoke_a", seed=0)
    want = np.stack([src.event(i % 3, "raw")[0] for i in range(n)])
    np.testing.assert_array_equal(torch.cat(frames).cpu().numpy(), want)
    assert pipe.metrics.summary()["arena_copies"] == 3


# -- train -> fold -> serve ------------------------------------------------------


def test_batchnorm_train_step_on_the_card_matches_the_cpu(cuda):
    """One ``make_peaknet_step`` of a ``norm="batch"`` PeakNet-TPU (8, 16)
    from the same init on the card (bf16 library convolutions, one
    ``calib_kernel`` launch) and on the CPU (the plain versions): loss,
    gradients (one whole-tree ``rel_err``) and running statistics within
    the bf16 bound."""
    from psana_ray_tpu_torch.convert import flatten, flax_array, flax_names

    src = pt.SyntheticSource(num_events=1, detector_name="smoke_a", seed=5)
    calib = (src.pedestal(), src.spec.adu_gain * src.gain_map(), src.create_bad_pixel_mask())
    frames = np.stack([src.event(i, "raw")[0] for i in range(4)])
    tree = pt.init_peaknet_tpu_params((8, 16), seed=3, norm="batch")
    out = {}
    for dev in (torch.device("cpu"), cuda):
        model = pt.unet_from_flax(tree, norm="batch", device=dev)
        loss = pt.make_peaknet_step(model, *calib, device=dev)(frames)
        names = flax_names(model)
        grads = np.concatenate([flax_array(names[n], p.grad).ravel()
                                for n, p in sorted(model.named_parameters())])
        out[dev.type] = (float(loss), grads, flatten(pt.unet_to_flax(model)["batch_stats"]))
    assert pt.counts() == {"calib_kernel": 1, **NO_CONV, "flash_kernel": 0, **NO_BWD}
    (loss_c, g_c, s_c), (loss_g, g_g, s_g) = out["cpu"], out["cuda"]
    assert abs(loss_g - loss_c) <= REL_TOL * abs(loss_c)
    assert rel_err(torch.from_numpy(g_c), torch.from_numpy(g_g)) < REL_TOL
    assert max(rel_err(torch.from_numpy(s_c[k]), torch.from_numpy(s_g[k])) for k in s_c) < REL_TOL


def test_folded_tree_through_the_kernels_matches_batch_eval(cuda):
    """A ``norm="batch"`` PeakNet-TPU (64, 128, 256) whose running
    statistics moved, folded and served through the kernels, against the
    ``norm="batch_eval"`` model with the same weights."""
    gen = torch.Generator(cuda).manual_seed(2)
    model = pt.unet_from_flax(pt.init_peaknet_tpu_params((64, 128, 256), seed=2, norm="batch"),
                              norm="batch", device=cuda)
    x = torch.randn((2, 64, 128, 1), generator=gen, device=cuda)
    with torch.no_grad():
        for _ in range(3):
            model(x + 0.3 * torch.randn(x.shape, generator=gen, device=cuda))
    variables = pt.unet_to_flax(model)
    serving = pt.unet_from_flax(pt.fold_batchnorm(variables), device=cuda)
    pt.reset_counters()
    got = pt.peaknet_tpu_fused_infer(pt.pack_unet(serving), x)
    assert pt.counts()["conv_block_kernel"] == 3 + 2
    with torch.no_grad():
        ref = pt.unet_from_flax(variables, norm="batch_eval", device=cuda)(x)
    assert bool(torch.isfinite(got).all()) and float(ref.abs().max()) >= 1e-2
    assert rel_err(ref, got) < REL_TOL


# -- the fan-in and the classic U-Net ----------------------------------------------


def test_fanin_step_under_a_side_stream_reads_the_copied_frames(cuda):
    """The consumer of a two-detector fan-in runs its steps under
    ``torch.cuda.stream(side)``; each batch's copy to the card was made on
    a leg's staging stream and waited for on the consumer's stream, so
    every step reads the frames the producer sent (frame i is all-i) and
    ``calib_kernel`` runs once a batch."""
    shapes = {"epix": (2, 64, 96), "jungfrau": (1, 128, 64)}
    n = {"epix": 40, "jungfrau": 48}
    rings = {k: pt.RingBuffer(maxsize=8) for k in shapes}

    def produce(name):
        events = ((i, np.full(shapes[name], float(i), np.float32), 9.5) for i in range(n[name]))
        pt.produce(events, rings[name], timeout=60.0)

    producers = [threading.Thread(target=produce, args=(k,), daemon=True) for k in shapes]
    for t in producers:
        t.start()
    consts = {k: (torch.zeros(s, device=cuda), torch.ones(s, device=cuda),
                  torch.ones(s, dtype=torch.uint8, device=cuda)) for k, s in shapes.items()}
    fan = pt.FanInPipeline([pt.DetectorStream(k, rings[k], batch_size=4, batcher_buffers=12)
                            for k in shapes])
    side = torch.cuda.Stream(cuda)
    sums, bad = {k: 0.0 for k in shapes}, []

    def step_for(name):
        def step(batch):
            # no pixel lies under a threshold of 0, so no common mode: x = raw
            x = pt.fused_calibrate(batch.frames, *consts[name], threshold=0.0)
            want = batch.event_idx.to(torch.float32).reshape(-1, 1, 1, 1).expand_as(x)
            keep = batch.valid.bool().reshape(-1, 1, 1, 1).expand_as(x)
            return (torch.where(keep, x - want, 0).abs().max(), torch.where(keep, x, 0).sum())

        return step

    def on_result(name, out, batch):
        err, total = out
        if float(err) != 0.0:
            bad.append((name, float(err)))
        sums[name] += float(total)

    pt.reset_counters()
    with torch.cuda.stream(side):
        counts = fan.run({k: step_for(k) for k in shapes}, on_result=on_result,
                         block_until_ready=True)
    for t in producers:
        t.join(timeout=30)
    assert counts == n and not bad
    for k, s in shapes.items():
        assert sums[k] == sum(range(n[k])) * np.prod(s)
    assert pt.counts()["calib_kernel"] == sum(-(-v // 4) for v in n.values())
    assert all(t.is_pinned() for pipe in fan.pipes.values() for a in pipe.batcher.pool
               for t in a.tensors)


def test_classic_unet_on_the_card_matches_the_cpu(cuda):
    """The classic PeakNetUNet (library convolutions in both packages) on
    the card against the same model on the CPU, frozen bf16."""
    tree = pt.init_peaknet_params((16, 32, 64), seed=4)
    x = torch.randn((2, 64, 96, 1), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = pt.peaknet_from_flax(tree)(x)
        got = pt.peaknet_from_flax(tree, device=cuda)(x.to(cuda))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 64, 96, 1)
    assert bool(torch.isfinite(got).all()) and float(ref.abs().max()) >= 1e-2
    assert rel_err(ref, got.cpu()) < REL_TOL
