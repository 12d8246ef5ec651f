#!/usr/bin/env python3
"""Drive the port's three serving paths and its training path on one
NVIDIA H100: the calibrated ResNet-50 classifier, the SFX Bragg-peak
pipeline (PeakNet-TPU U-Net), the ViT hit classifier with the
flash-attention trunk, and the ViT's training recipe with the flash
backward kernels.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and imports nothing of JAX. Phases, each printing
one JSON line (``{"phase": ...}``):

1. ``device``: the card's name and count, and ``nvidia-smi``'s name and
   power limit (also printed alone on a line of their own).
2. ``build``: compiles ``psana_ray_tpu_torch/csrc/*.cu`` with ``nvcc``
   (one process per source, all at once) and reports the seconds and each
   kernel's registers and spills from ``-Xptxas -v``, and for each kernel
   whether ``ptxas`` advised that its ``wgmma.mma_async`` instructions
   are serialized or that its ``setmaxnreg`` was ignored. A
   ``build_sm90`` line sums that up for the ``wgmma`` kernels of
   ``conv_sm90.cu``, ``flash.cu`` and ``flash_bwd.cu``; a spill, a
   serialization or an ignored ``setmaxnreg`` there fails the run, and so
   does a launch register count other than 168 in the two that move
   registers with ``setmaxnreg``.
3. ``calib_kernel``: K1 against its plain version on ``[32, 16, 352, 384]``
   f32 RAW frames from ``SyntheticSource``, with f32 and bf16 output
   (f32: rtol 1e-5, atol 1e-4; bf16: that plus one bf16 ulp).
4. ``bottleneck``: each of the 8 bottleneck block classes of ResNet-50 at
   batch 32 and full width, every kernel launch against its plain version
   on the same inputs (``rel_err < 0.05``), and the whole block against
   the chain of plain versions. A ``bottleneck_by_tpu_kernel`` line sums
   them per TPU kernel over one batch: K2 is the front ``conv1x1_kernel``
   and the ``conv3x3_kernel`` launches, K3 the ``back_kernel`` launches
   (all three on the ``wgmma`` kernel of ``conv_sm90.cu``), with the GB/s
   and TFLOP/s they reach, and for K2 the time y1's round trip through
   HBM takes at the card's memory rate (what fusing its two launches
   could save at most).
5. ``end_to_end``: a producer thread feeds RAW events into the port's
   ``RingBuffer``; ``InfeedPipeline(batch_size=32, prefetch_depth=2)`` ->
   ``fused_calibrate(bf16)`` -> ``panels_to_nhwc`` -> ``resnet_fused_infer``
   for 6 batches. Launch counts must be +1 ``calib_kernel``, +16
   ``conv1x1_kernel``, +16 ``conv3x3_kernel`` and +16 ``back_kernel``
   per batch; the last
   batch's logits and pooled features are checked against the plain path
   on the card.
6. ``profile``: the same pipeline for 4 more batches under
   ``torch.profiler``: device time by kernel, the device's idle share and
   the busiest host ops.
7. ``conv_block``: the three K4 encoder levels of PeakNet-TPU at full width
   (features 64-128-256-512, s2d 2) and batch 128 (8 epix10k2M frames x
   16 panels): level 1 88x96 64->128, level 2 44x48 128->256, bottleneck
   22x24 256->512 with no downsample. Every 3x3 ``conv_sm90_kernel``
   launch against its plain version and each level against the chain of
   plain versions (``rel_err < 0.05``), with kernel, plain and library
   (bf16 channels-last ``F.conv2d``) times, the TFLOP/s each launch and
   level reaches, the fused level's bound and the bound of the three
   launches (y1 and skip through HBM).
8. ``sfx_end_to_end``: a producer thread feeds RAW events into a
   ``RingBuffer``; ``SfxPipeline(SfxConfig(batch_size=8)).run`` drains
   them (``calib_kernel`` -> ``peaknet_tpu_fused_infer`` -> ``find_peaks``
   -> an in-memory writer) for 6 batches. Launch counts must be +1
   ``calib_kernel`` and +8 ``conv_block_kernel`` per batch; the last
   batch's logits are checked against the plain path on the card, and
   the peaks written for it against a recomputation.
9. ``sfx_profile``: the same pipeline for 4 more batches under
   ``torch.profiler``.

10. ``flash_kernel``: K5 against its plain version on ``[B, H, S, 128]``
   bf16 inputs ``N(0, 1)`` (scores of std 1, so the softmax is far from
   flat): the ViT serving shape (B 2, H 4, S 8448, non-causal), the
   forward of a training step (B 4), causal at Sq = Sk = 1024, Sq = 256
   against Sk = 768, and causal Sq = 640 against Sk = 384. ``o`` within
   2e-2 and ``lse`` within 1e-2 (max abs), and each within 1e-2 of its own
   scale (``max|o_ref|``; ``max|lse_ref - log(keys)|``, the distance from
   a flat softmax). Two controls must fail that check in every case:
   zeros, and attention that ignores the scores (the mean of the allowed
   values, ``lse = log(keys)``). With kernel, plain and library
   (``F.scaled_dot_product_attention``) times and the bound of the work
   each case needs.
11. ``vit_end_to_end``: a producer thread feeds RAW events into a
   ``RingBuffer``; ``InfeedPipeline(batch_size=2, prefetch_depth=2)`` ->
   ``vit_serve_step`` (``calib_kernel`` to bf16 -> ``ViTHitClassifier`` at
   the reference's defaults: patch 16, embed 512, depth 4, 4 heads, 8448
   tokens a frame) for 6 batches. Launch counts must be +1
   ``calib_kernel`` and +4 ``flash_kernel`` per batch and nothing else;
   the last batch's logits are checked against the plain path on the
   card (``fused_calibrate_plain`` and the model with the plain
   attention). The same model with score-blind attention (the flat
   control above) gives the logits' sensitivity to attention.
12. ``vit_profile``: the same pipeline for 4 more batches under
   ``torch.profiler``.
13. ``flash_bwd``: ``flash_bwd_kernel`` (K6 and K7 in one pass) and its
   dq rounding ``flash_bwd_dq_convert`` against ``attention_bwd_plain`` on the same
   residuals (``o``, ``lse`` from ``flash_kernel``), q, k, v and dO
   ``N(0, 1)`` bf16: the ViT training shape (B 4, H 4, S 8448,
   non-causal), causal Sq = Sk = 1024, Sq 128 against Sk 384 causal and
   not, and one case with an ``N(0, 1)`` lse cotangent. Each of dq, dk, dv
   within ``max|g - g_ref| / max|g_ref| <= 1e-2``, all finite; two
   controls must fail that check in every case: zeros, and the backward
   of score-blind attention (p = 1/keys: dq = dk = 0). The errors of a
   backward that drops delta, and of one that ignores dlse, are printed.
   A second launch on the same inputs must give identical dk and dv and
   dq within one bf16 ulp of its largest value (dq's f32 sums across key
   tiles arrive in another order each run). Times: the pair as the
   backward launches it (dq_acc zeroed, the kernel, the dq rounding;
   ``ms`` and ``ms_cold``), the kernel alone and the rounding alone, the
   plain version's (one call for dq, dk and dv), the library's (the
   backward of ``F.scaled_dot_product_attention`` from a saved forward,
   one call for the three), and the bound of the five products the
   function needs, with that of the seven of a two-kernel design beside
   it.
14. ``vit_train``: the training recipe of the JAX package's
   ``bench.py:_train_hit_classifier`` at the ViT's full defaults: 80 RAW
   epix10k2M events of ``SyntheticSource(hit_fraction=0.5, seed=7)``,
   ``train_hit_classifier`` at batch 4 for 300 steps. First, parity from
   the same init on the first chunk: one forward and backward with the
   kernels against one with the plain attention (forward and backward),
   loss within 0.05 relative; and against one with the kernel forward and
   the plain backward (the same activations, so only the backward kernel differs),
   every parameter's gradient ``rel_err < 0.05``. The worst leaf of each
   comparison is named, and printed beside them are the plain path
   against the kernel forward with the plain backward (the forward's
   rounding, which the max-pool head's ties amplify) and the gradients of
   a backward that drops delta. Launch counts must be +1
   ``calib_kernel`` per 4-frame chunk, +4 ``flash_kernel``, +4
   ``flash_bwd_kernel`` and +4 ``flash_bwd_dq_convert`` per step, and
   nothing else. p50/p99 step ms (synchronised after each step),
   training frames/s, peak memory, the first and last 20-step mean
   loss, and accuracy on 16 held-out events through ``vit_serve_step``.
15. ``vit_train_profile``: 4 more train steps under ``torch.profiler``.
16. ``narrow``: models narrower than the kernels' 64-channel quantum run
   through the kernels on zero-padded channels: ResNet-50 at width 16
   on ``[2, 64, 64, 4]`` (+16 ``conv1x1_kernel``, +16 ``conv3x3_kernel``,
   +16 ``back_kernel``) and PeakNet-TPU (32, 64, 128) on
   ``[2, 64, 128, 1]`` (+5 ``conv_block_kernel``), each within
   ``rel_err < 0.05`` of its plain model.

Then a ``{"kernels": [...]}`` line and, last, the device line. Any failure
raises and exits non-zero before the device line is printed. The
``calib_kernel`` launches in the kernels line are those of the three
serving runs and the training run (phases 5, 8, 11 and 14), the
``flash_kernel`` launches those of the ViT's serving and training runs;
every other kernel runs on one path only.

Times are CUDA-event times of one launch with the 50 MB L2 flushed before
it, after warm-up, with the card kept busy (a spin of about a
millisecond, ``torch.cuda._sleep``) between the flush and the start
event, so that the host prepares the launch (tensor maps, ctypes) while
the card works and the time is the card's alone. ``ms_cold`` (K2-K7)
is the earlier timer's: no spin, so a call's host time shows whenever it
outlasts the flush. For ``conv1x1_kernel``, ``conv3x3_kernel`` and
``back_kernel`` the kernels line gives the sum over one batch of the main
path (each block class's time times the number of blocks of that class);
for ``conv_block_kernel`` the 8 launches of one SFX batch; for
``flash_kernel`` one batch is 4 launches at the serving shape, and for
``flash_bwd_kernel``, which both K6's and K7's rows name, one train step
is 4 launches of the pair (kernel and dq rounding) at the training shape
(``plain_ms`` is the plain version's one call for dq, dk and dv;
``library_ms``, the SDPA backward's one call for the three, is given
once, with K6). ``bound_ms`` is
the larger of bytes / 3.35 TB/s and operations / peak (989 TFLOP/s bf16
tensor cores; 67 TFLOP/s f32 for the calibration arithmetic), counting
each input byte read once and each output byte written once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
BATCH = 32
E2E_BATCHES = 6
POOL_EVENTS = 64
REL_TOL = 0.05
SFX_BATCH = 8  # frames; 128 panel-rows of epix10k2M
SFX_FEATURES = (64, 128, 256, 512)
SFX_BATCHES = 6
VIT_BATCH = 2  # frames; each one 8448-token sequence
VIT_BATCHES = 6
VIT_DEPTH = 4  # flash_kernel launches per batch
FLASH_TOL = {"o": 2e-2, "lse": 1e-2, "o_rel": 1e-2, "lse_rel": 1e-2}
BWD_TOL = 1e-2  # max|g - g_ref| / max|g_ref| for each of dq, dk, dv
NO_BWD = {"flash_bwd_kernel": 0, "flash_bwd_dq_convert": 0}  # serving paths launch none
NO_RESNET = {"conv1x1_kernel": 0, "conv3x3_kernel": 0, "back_kernel": 0}  # other paths
# (case, B, H, Sq, Sk, causal, with an lse cotangent); the first is the ViT training shape
BWD_CASES = (("training", 4, 4, 8448, 8448, False, False),
             ("causal", 2, 4, 1024, 1024, True, False),
             ("uneven", 2, 4, 128, 384, False, False),
             ("uneven_causal", 2, 4, 128, 384, True, False),
             ("dlse", 2, 4, 1024, 1024, False, True))
TRAIN_DETECTOR = "epix10k2M"
TRAIN_BATCH = 4  # frames a step (bench.py:_train_hit_classifier)
TRAIN_STEPS = 300  # the recipe's
TRAIN_EVENTS = 80  # 10 batches of 8 (bench.py:_bench_classifier_quality)
EVAL_START, EVAL_EVENTS = 5000, 16
PROFILE_STEPS = 4
# (case, B, H, Sq, Sk, causal); the first is the ViT serving shape, the second
# the forward of a training step
FLASH_CASES = (("serving", 2, 4, 8448, 8448, False), ("training", 4, 4, 8448, 8448, False),
               ("causal", 2, 4, 1024, 1024, True), ("uneven", 2, 4, 256, 768, False),
               ("uneven_causal", 2, 4, 640, 384, True))
# (level, index into FusedUNet.levels, h, w) at s2d 2 on 352x384 panels
UNET_LEVELS = (("level1", 0, 88, 96), ("level2", 1, 44, 48), ("bottleneck", 2, 22, 24))

# (class name, block index in ResNet-50, blocks of that class in the network)
BLOCK_CLASSES = (
    ("stage1_proj", 0, 1),
    ("stage1_identity", 1, 2),
    ("stage2_proj_s2", 3, 1),
    ("stage2_identity", 4, 3),
    ("stage3_proj_s2", 7, 1),
    ("stage3_identity", 8, 5),
    ("stage4_proj_s2", 13, 1),
    ("stage4_identity", 14, 2),
)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound_ms(nbytes: float, ops: float, ops_per_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(ref, got) -> float:
    """Max error over the reference's scale (the JAX package's measure)."""
    ref, got = ref.float(), got.float()
    return float((ref - got).abs().max() / max(float(ref.abs().max()), 1e-3))


class Timer:
    """CUDA-event time of one call, L2 flushed before each timed call.

    :meth:`ms` keeps the card busy between the flush and the start event
    (``torch.cuda._sleep``, about a millisecond), so that the host's
    preparation of the call overlaps device work and the time is the
    device's alone; :meth:`ms_cold` does not, so a call's host time shows
    whenever it outlasts the flush (the earlier timer)."""

    SPIN_CYCLES = 2_000_000

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, iters: int = 10, warmup: int = 2) -> float:
        return self._time(fn, iters, warmup, spin=True)

    def ms_cold(self, fn, iters: int = 10, warmup: int = 2) -> float:
        return self._time(fn, iters, warmup, spin=False)

    def _time(self, fn, iters: int, warmup: int, spin: bool) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            if spin:
                torch.cuda._sleep(self.SPIN_CYCLES)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- phase 3 ---------------------------------------------------------------


def phase_calib(torch, pt, timer, src, raw, device):
    from psana_ray_tpu_torch.ops.fused_calib import fused_calibrate, fused_calibrate_plain

    ped = torch.from_numpy(src.pedestal()).to(device)
    gain = torch.from_numpy(src.gain_map()).to(device)
    mask = torch.from_numpy(src.create_bad_pixel_mask()).to(device)
    b, p, h, w = raw.shape
    npix = b * p * h * w
    result = {"shape": list(raw.shape)}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        got = fused_calibrate(raw, ped, gain, mask, out_dtype=dt)
        ref = fused_calibrate_plain(raw, ped, gain, mask, out_dtype=dt).float()
        torch.cuda.synchronize()
        diff = (got.float() - ref).abs()
        tol = 1e-4 + 1e-5 * ref.abs()
        if dt == torch.bfloat16:
            # f32 values that differ by the f32 tolerance can round to
            # neighbouring bf16 values: allow one bf16 ulp (8 significant
            # bits) of the plain version's value on top
            tol = tol + torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
        ok = bool(torch.all(diff <= tol))
        if not ok or not torch.isfinite(got.float()).all():
            raise AssertionError(f"calib_kernel ({name} out) disagrees with its plain version: "
                                 f"max abs err {float(diff.max())}")
        nbytes = raw.numel() * 4 + npix * got.element_size() + p * h * w * (4 + 4 + 1)
        bms, by = bound_ms(nbytes, 7.0 * npix, F32_OPS_PER_S)
        result[name] = {
            "max_abs_err": float(diff.max()),
            "ms": timer.ms(lambda: fused_calibrate(raw, ped, gain, mask, out_dtype=dt), iters=20),
            "plain_ms": timer.ms(
                lambda: fused_calibrate_plain(raw, ped, gain, mask, out_dtype=dt), iters=5),
            "bound_ms": bms,
            "bound_by": by,
            "bytes": nbytes,
        }
    emit("calib_kernel", **result)
    return result, (ped, gain, mask)


# -- phase 4 ---------------------------------------------------------------


def _gemm_cost(m, k, n, in_bytes_extra=0):
    """(bytes, ops) of a bf16 [m,k]@[k,n] with f32 affines and bf16 output."""
    return 2 * m * k + 2 * k * n + 8 * n + 2 * m * n + in_bytes_extra, 2.0 * m * n * k


def phase_bottleneck(torch, F, fr, timer, params, frame_hw, device):
    """Each block class, each launch against its plain version."""
    gen = torch.Generator(device=device).manual_seed(0)
    h0, w0 = frame_hw[0] // 4, frame_hw[1] // 4  # after the stem and pool
    strides = [blk.stride for blk in params.blocks]
    times = ("ms", "ms_cold", "plain_ms", "bound_ms", "library_ms")
    per_kernel = {
        k: {**dict.fromkeys(times, 0.0), "max_abs_err": 0.0, "launches_per_batch": 0,
            "bound_by": {"bytes": 0.0, "operations": 0.0}, "gbytes": 0.0, "gflop": 0.0}
        for k in ("conv1x1_kernel", "conv3x3_kernel", "back_kernel")
    }
    # the same launches summed per TPU kernel: K2 = front + middle, K3 = back
    per_tpu = {
        k: {**dict.fromkeys(times, 0.0), "max_abs_err": 0.0, "launches_per_batch": 0,
            "gbytes": 0.0, "gflop": 0.0}
        for k in ("K2", "K3")
    }
    # what fusing K2's two launches could save at most: y1 written and read
    # back through HBM in bf16, over one batch
    per_tpu["K2"]["y1_round_trip_ms"] = 0.0
    classes = []
    for name, idx, mult in BLOCK_CLASSES:
        blk = params.blocks[idx]
        div = 1
        for s in strides[:idx]:
            div *= s
        h, w = h0 // div, w0 // div
        f, cin = blk.w1.shape  # K-major [F, Cin]
        cout = blk.w3.shape[0]  # K-major [N, F]
        s = blk.stride
        ho, wo = h // s, w // s
        x = torch.randn((BATCH, h, w, cin), generator=gen, device=device).to(torch.bfloat16)
        y1 = fr.conv1x1(x, blk.w1, blk.s1, blk.b1)
        y2 = fr.conv3x3(y1, blk.w2, blk.s2, blk.b2, s)
        proj = None if blk.wp is None else (x, blk.wp, blk.sp, blk.bp, s)
        res = x if blk.wp is None else None
        out = fr.back_step(y2, blk.w3, blk.s3, blk.b3, residual=res, proj=proj)
        # each launch against its plain version on the same inputs
        checks = {
            "front": (y1, fr.front_plain(x, blk.w1, blk.s1, blk.b1)),
            "middle": (y2, fr.middle_plain(y1, blk.w2, blk.s2, blk.b2, s)),
            "back": (out, fr.back_step_plain(y2, blk.w3, blk.s3, blk.b3, residual=res, proj=proj)),
        }
        # the whole block against the chain of plain versions
        p1 = fr.front_plain(x, blk.w1, blk.s1, blk.b1)
        p2 = fr.middle_plain(p1, blk.w2, blk.s2, blk.b2, s)
        p3 = fr.back_step_plain(p2, blk.w3, blk.s3, blk.b3, residual=res, proj=proj)
        torch.cuda.synchronize()
        errs = {k: {"max_abs_err": float((a.float() - b.float()).abs().max()), "rel_err": rel_err(b, a)}
                for k, (a, b) in checks.items()}
        block_rel = rel_err(p3, out)
        bad = [k for k, e in errs.items() if not e["rel_err"] < REL_TOL]
        if bad or not block_rel < REL_TOL or not torch.isfinite(out.float()).all():
            raise AssertionError(f"{name}: kernels disagree with their plain versions: {errs}, "
                                 f"block rel_err {block_rel}")

        m_in, m_out = BATCH * h * w, BATCH * ho * wo
        per_tpu["K2"]["y1_round_trip_ms"] += mult * 2 * 2 * m_in * f / HBM_BYTES_PER_S * 1e3
        cost = {
            "front": _gemm_cost(m_in, cin, f),
            "middle": (2 * m_in * f + 2 * 9 * f * f + 8 * f + 2 * m_out * f, 2.0 * m_out * f * 9 * f),
        }
        if blk.wp is None:
            cost["back"] = _gemm_cost(m_out, f, cout, in_bytes_extra=2 * m_out * cout)
        else:
            b_, o_ = _gemm_cost(m_out, f, cout)
            cost["back"] = (b_ + 2 * m_out * cin + 2 * cin * cout + 8 * cout,
                            o_ + 2.0 * m_out * cout * cin)

        # library yardsticks, never called by the port: one bf16 matmul of
        # the same GEMM, one bf16 F.conv2d of the same convolution
        xa = x.reshape(m_in, cin)
        y1n = y1.permute(0, 3, 1, 2)  # NCHW view of NHWC memory (channels_last)
        pads = (1, 1, 1, 1) if s == 1 else (0, 1, 0, 1)
        y1p = F.pad(y1n, pads).contiguous(memory_format=torch.channels_last)
        w2_oihw = blk.w2.reshape(f, 3, 3, f).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        w1_kn = blk.w1.t().contiguous()
        if blk.wp is None:
            back_a, back_w = y2.reshape(m_out, f), blk.w3.t().contiguous()
        else:
            xs = x[:, ::s, ::s].reshape(m_out, cin)
            back_a = torch.cat([y2.reshape(m_out, f), xs], dim=1)
            back_w = torch.cat([blk.w3.t(), blk.wp.t()], dim=0).contiguous()
        launches = {
            "front": ("conv1x1_kernel",
                      lambda: fr.conv1x1(x, blk.w1, blk.s1, blk.b1),
                      lambda: fr.front_plain(x, blk.w1, blk.s1, blk.b1),
                      lambda: torch.matmul(xa, w1_kn)),
            "middle": ("conv3x3_kernel",
                       lambda: fr.conv3x3(y1, blk.w2, blk.s2, blk.b2, s),
                       lambda: fr.middle_plain(y1, blk.w2, blk.s2, blk.b2, s),
                       lambda: F.conv2d(y1p, w2_oihw, stride=s)),
            "back": ("back_kernel",
                     lambda: fr.back_step(y2, blk.w3, blk.s3, blk.b3, residual=res, proj=proj),
                     lambda: fr.back_step_plain(y2, blk.w3, blk.s3, blk.b3, residual=res, proj=proj),
                     lambda: torch.matmul(back_a, back_w)),
        }
        row = {"class": name, "blocks": mult, "x": [BATCH, h, w, cin], "stride": s,
               "block_rel_err": block_rel, "launches": {}}
        for step, (kname, kfn, pfn, lfn) in launches.items():
            nbytes, ops = cost[step]
            bms, by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
            t = {
                "kernel": kname,
                "ms": timer.ms(kfn, iters=10),
                "ms_cold": timer.ms_cold(kfn, iters=10),
                "plain_ms": timer.ms(pfn, iters=3, warmup=1),
                "library_ms": timer.ms(lfn, iters=10),
                "bound_ms": bms,
                "bound_by": by,
                "gflop": ops / 1e9,
                "mbytes": nbytes / 1e6,
                **errs[step],
            }
            t["gbytes_per_s"] = nbytes / t["ms"] / 1e6
            t["tflops"] = ops / t["ms"] / 1e9
            row["launches"][step] = t
            agg = per_kernel[kname]
            for key in times:
                agg[key] += mult * t[key]
            agg["gbytes"] += mult * nbytes / 1e9
            agg["gflop"] += mult * ops / 1e9
            agg["bound_by"][by] += mult * bms
            agg["launches_per_batch"] += mult
            agg["max_abs_err"] = max(agg["max_abs_err"], t["max_abs_err"])
            tpu = per_tpu["K3" if step == "back" else "K2"]
            for key in times:
                tpu[key] += mult * t[key]
            tpu["gbytes"] += mult * nbytes / 1e9
            tpu["gflop"] += mult * ops / 1e9
            tpu["launches_per_batch"] += mult
            tpu["max_abs_err"] = max(tpu["max_abs_err"], t["max_abs_err"])
        emit("bottleneck", **row)
        classes.append(row)
        del x, y1, y2, out, checks, p1, p2, p3, y1p, back_a, w1_kn
    for agg in list(per_kernel.values()) + list(per_tpu.values()):
        if isinstance(agg.get("bound_by"), dict):
            agg["bound_by"] = max(agg["bound_by"], key=agg["bound_by"].get)
        agg["gbytes_per_s"] = agg["gbytes"] / agg["ms"] * 1e3
        agg["tflops"] = agg["gflop"] / agg["ms"]
        agg["share_of_bound"] = agg["bound_ms"] / agg["ms"]
    per_tpu["K3"]["kernel"] = "back_kernel"
    per_tpu["K2"]["kernel"] = "conv1x1_kernel + conv3x3_kernel"
    emit("bottleneck_by_tpu_kernel", **per_tpu)
    return per_kernel, classes


# -- phases 5 and 6 ----------------------------------------------------------


def make_step(torch, pt, consts, params):
    """The serving step: calibrate to bf16, panels as channels, ResNet-50."""
    ped, gain, mask = consts

    def step(batch):
        cal = pt.fused_calibrate(batch.frames, ped, gain, mask, threshold=10.0,
                                 out_dtype=torch.bfloat16)
        return pt.resnet_fused_infer(params, pt.panels_to_nhwc(cal), return_features=True)

    return step


def run_pipeline(torch, pt, pool, step, device, n_batches, on_result=None, batch=BATCH):
    """A producer thread puts ``n_batches * batch`` RAW events (the pool,
    cycled) and one EOS into a ``RingBuffer``; ``InfeedPipeline`` drives
    ``step`` over them. Returns the pipeline and the wall seconds."""
    n_events = n_batches * batch
    ring = pt.RingBuffer(maxsize=3 * batch)
    events = ((i, pool[i % len(pool)], 10.0) for i in range(n_events))
    produced = {}

    def producer():
        produced["n"] = pt.produce(events, ring, timeout=120.0)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    pipe = pt.InfeedPipeline(ring, batch_size=batch, device=device, prefetch_depth=2)
    t0 = time.monotonic()
    try:
        seen = pipe.run(step, on_result=on_result, block_until_ready=True)
    finally:
        wall = time.monotonic() - t0
        ring.close()
        thread.join(timeout=60)
    if produced.get("n") != n_events or seen != n_events or pipe.metrics.batches != n_batches:
        raise AssertionError(f"produced {produced.get('n')}, consumed {seen} in "
                             f"{pipe.metrics.batches} batches, expected {n_events}")
    return pipe, wall


def phase_end_to_end(torch, pt, pool, consts, model, params, device):
    import numpy as np

    from psana_ray_tpu_torch.ops.fused_calib import fused_calibrate_plain

    ped, gain, mask = consts
    step = make_step(torch, pt, consts, params)
    # warm-up outside the counted run (cuDNN picks the stem's algorithm)
    warm = torch.from_numpy(np.stack(pool[:BATCH])).to(device)
    step(pt.Batch(warm, *(torch.zeros(BATCH, device=device) for _ in range(4)), num_valid=BATCH))
    torch.cuda.synchronize()
    del warm

    last = {}

    def on_result(out, batch):
        last["out"], last["frames"] = out, batch.frames

    torch.cuda.reset_peak_memory_stats(device)
    pt.reset_counters()
    pipe, wall = run_pipeline(torch, pt, pool, step, device, E2E_BATCHES, on_result)
    counts = pt.counts()
    nb = pipe.metrics.batches
    want = {"calib_kernel": nb, "conv1x1_kernel": 16 * nb, "conv3x3_kernel": 16 * nb,
            "back_kernel": 16 * nb, "conv_block_kernel": 0, "flash_kernel": 0, **NO_BWD}
    if counts != want:
        raise AssertionError(f"launch counts {counts} over {nb} batches, expected {want}")

    logits, feat = last["out"]
    if tuple(logits.shape) != (BATCH, 2) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    cal = fused_calibrate_plain(last["frames"], ped, gain, mask, out_dtype=torch.bfloat16)
    with torch.no_grad():
        ref_logits, ref_feat = model(pt.panels_to_nhwc(cal), return_features=True)
    torch.cuda.synchronize()
    errs = {"logits_rel_err": rel_err(ref_logits, logits), "features_rel_err": rel_err(ref_feat, feat),
            "features_max_abs": float(ref_feat.abs().max())}
    if not (errs["logits_rel_err"] < REL_TOL and errs["features_rel_err"] < REL_TOL
            and errs["features_max_abs"] >= 1e-2):
        raise AssertionError(f"end-to-end result disagrees with the plain path: {errs}")
    summary = pipe.metrics.summary()
    result = {
        "batches": nb, "frames": summary["frames"], "wall_s": wall, "fps": summary["fps"],
        "p50_batch_ms": summary["p50_ms"], "p99_batch_ms": summary["p99_ms"],
        "host_batch_ms": summary["host_batch_ms"], "host_stage_ms": summary["host_stage_ms"],
        "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30,
        "launches": counts, **errs,
    }
    emit("end_to_end", **result)
    return counts


def profile_summary(torch, prof, wall, n_batches, top=16) -> dict:
    """Device time by kernel per batch, the device's idle share of the wall
    time and the host ops that take the most time, from a profiler run."""
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side rows only (kernels and copies): the CPU op that launched
    # a kernel carries the same device time again
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted((e for e in events if e.device_type == cuda and dev_us(e) > 0),
                     key=dev_us, reverse=True)
    copies = sum(dev_us(e) for e in kernels if "memcpy" in e.key.lower())
    compute = sum(dev_us(e) for e in kernels) - copies
    host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)
    per = 1e3 * n_batches
    return {
        "batches": n_batches,
        "wall_ms_per_batch": wall * 1e3 / n_batches,
        "device_compute_ms_per_batch": compute / per,
        "device_copy_ms_per_batch": copies / per,
        "device_idle_share": max(0.0, 1.0 - compute / 1e3 / (wall * 1e3)),
        "top_device": [{"name": e.key[:160], "ms_per_batch": dev_us(e) / per,
                        "calls_per_batch": e.count / n_batches} for e in kernels[:top]],
        "top_host": [{"name": e.key[:80], "self_ms_per_batch": e.self_cpu_time_total / per,
                      "calls_per_batch": e.count / n_batches} for e in host[:top]],
    }


def phase_profile(torch, pt, pool, consts, params, device, n_batches=4):
    """The ResNet pipeline under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    step = make_step(torch, pt, consts, params)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run_pipeline(torch, pt, pool, step, device, n_batches)
    emit("profile", **profile_summary(torch, prof, wall, n_batches))


# -- phase 7 ---------------------------------------------------------------


def _conv3x3_cost(m_out, cin, n, m_in, affine=True):
    """(bytes, ops) of one bf16 3x3 convolution: input, weight, affines,
    output, each once."""
    return (2 * m_in * cin + 2 * 9 * cin * n + (8 * n if affine else 0) + 2 * m_out * n,
            2.0 * m_out * 9 * cin * n)


def phase_conv_block(torch, F, fu, timer, uparams, device):
    """Each K4 level at batch 128, every launch against its plain version."""
    gen = torch.Generator(device=device).manual_seed(0)
    b = SFX_BATCH * 16
    agg = {"ms": 0.0, "ms_cold": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "three_launch_bound_ms": 0.0, "max_abs_err": 0.0, "launches_per_batch": 0, "gflop": 0.0}
    levels = []
    for name, idx, h, w in UNET_LEVELS:
        lvl = uparams.levels[idx]
        f, cin = lvl.w1.shape[0], lvl.w1.shape[1] // 9  # K-major [f, 9*cin]
        down = lvl.wd is not None
        x = torch.randn((b, h, w, cin), generator=gen, device=device).to(torch.bfloat16)
        conv, plain = fu.launch_level_conv, fu.level_conv_plain
        y1 = conv(x, lvl.w1, *lvl.a1, 1)
        skip = conv(y1, lvl.w2, *lvl.a2, 1)
        dn = conv(skip, lvl.wd, None, None, 2) if down else None
        checks = {"conv1": (y1, plain(x, lvl.w1, *lvl.a1, 1)),
                  "conv2": (skip, plain(y1, lvl.w2, *lvl.a2, 1))}
        if down:
            checks["down"] = (dn, plain(skip, lvl.wd, None, None, 2))
        # the whole level (its wrapper, on HWIO weights) against the chain of plain versions
        hwio = [None if wt is None else wt.reshape(wt.shape[0], 3, 3, -1).permute(1, 2, 3, 0)
                for wt in (lvl.w1, lvl.w2, lvl.wd)]
        got = fu.fused_conv_block(x, hwio[0], lvl.a1, hwio[1], lvl.a2, hwio[2])
        ref = fu.fused_conv_block_plain(x, hwio[0], lvl.a1, hwio[1], lvl.a2, hwio[2])
        torch.cuda.synchronize()
        errs = {k: {"max_abs_err": float((a.float() - r.float()).abs().max()), "rel_err": rel_err(r, a)}
                for k, (a, r) in checks.items()}
        level_rel = max(rel_err(r, a) for a, r in zip(got, ref) if a is not None)
        bad = [k for k, e in errs.items() if not e["rel_err"] < REL_TOL]
        if bad or not level_rel < REL_TOL or not torch.isfinite(got[0].float()).all():
            raise AssertionError(f"{name}: kernels disagree with their plain versions: {errs}, "
                                 f"level rel_err {level_rel}")

        m, m2 = b * h * w, b * (h // 2) * (w // 2)
        cost = {"conv1": _conv3x3_cost(m, cin, f, m), "conv2": _conv3x3_cost(m, f, f, m)}
        if down:
            cost["down"] = _conv3x3_cost(m2, f, f, m, affine=False)
        ops = sum(o for _, o in cost.values())
        fused_bytes = (2 * m * cin + 2 * 9 * (cin * f + f * f) + 16 * f + 2 * m * f
                       + ((2 * 9 * f * f + 2 * m2 * f) if down else 0))
        bms, by = bound_ms(fused_bytes, ops, BF16_OPS_PER_S)
        three = sum(bound_ms(nb, o, BF16_OPS_PER_S)[0] for nb, o in cost.values())

        # library yardsticks, never called by the port: bf16 channels-last
        # F.conv2d of the same convolutions (no affine)
        def oihw(wt):
            return wt.reshape(wt.shape[0], 3, 3, -1).permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)

        xn, y1n, skn = (t.permute(0, 3, 1, 2) for t in (x, y1, skip))
        w1o, w2o = oihw(lvl.w1), oihw(lvl.w2)
        launches = {
            "conv1": (lambda: conv(x, lvl.w1, *lvl.a1, 1),
                      lambda: plain(x, lvl.w1, *lvl.a1, 1),
                      lambda: F.conv2d(xn, w1o, padding=1)),
            "conv2": (lambda: conv(y1, lvl.w2, *lvl.a2, 1),
                      lambda: plain(y1, lvl.w2, *lvl.a2, 1),
                      lambda: F.conv2d(y1n, w2o, padding=1)),
        }
        if down:
            skp = F.pad(skn, (0, 1, 0, 1)).contiguous(memory_format=torch.channels_last)
            wdo = oihw(lvl.wd)
            launches["down"] = (lambda: conv(skip, lvl.wd, None, None, 2),
                                lambda: plain(skip, lvl.wd, None, None, 2),
                                lambda: F.conv2d(skp, wdo, stride=2))
        row = {"level": name, "x": [b, h, w, cin], "features": f, "down": down,
               "gflop": ops / 1e9, "fused_mbytes": fused_bytes / 1e6, "bound_ms": bms,
               "bound_by": by, "three_launch_bound_ms": three, "level_rel_err": level_rel,
               "launches": {}}
        for step, (kfn, pfn, lfn) in launches.items():
            nb, o = cost[step]
            t = {"ms": timer.ms(kfn, iters=10), "ms_cold": timer.ms_cold(kfn, iters=10),
                 "plain_ms": timer.ms(pfn, iters=3, warmup=1),
                 "library_ms": timer.ms(lfn, iters=10),
                 "bound_ms": bound_ms(nb, o, BF16_OPS_PER_S)[0], "gflop": o / 1e9, **errs[step]}
            t["tflops"] = o / t["ms"] / 1e9
            t["library_tflops"] = o / t["library_ms"] / 1e9
            row["launches"][step] = t
            for key in ("ms", "ms_cold", "plain_ms", "library_ms"):
                agg[key] += t[key]
            agg["max_abs_err"] = max(agg["max_abs_err"], t["max_abs_err"])
            agg["launches_per_batch"] += 1
        row["ms"] = sum(t["ms"] for t in row["launches"].values())
        row["tflops"] = ops / row["ms"] / 1e9
        agg["bound_ms"] += bms
        agg["three_launch_bound_ms"] += three
        agg["gflop"] += ops / 1e9
        emit("conv_block", **row)
        levels.append(row)
        del x, y1, skip, dn, checks, got, ref, launches
    agg["bound_by"] = "operations"
    agg["tflops"] = agg["gflop"] / agg["ms"]
    agg["share_of_bound"] = agg["bound_ms"] / agg["ms"]
    emit("conv_block_per_batch", **agg)
    return agg, levels


# -- phases 8 and 9 ----------------------------------------------------------


class PeakSink:
    """An in-memory writer: keeps every appended peak set."""

    max_peaks = 128

    def __init__(self):
        self.sets = []

    def append(self, sets):
        self.sets.extend(sets)


def run_sfx(torch, pt, pool, pipe, n_batches):
    """A producer thread puts ``n_batches * SFX_BATCH`` RAW events and one
    EOS into a ``RingBuffer``; ``pipe.run`` drains them. Returns the wall
    seconds."""
    n_events = n_batches * SFX_BATCH
    ring = pt.RingBuffer(maxsize=3 * SFX_BATCH)
    events = ((i, pool[i % len(pool)], 10.0) for i in range(n_events))
    produced = {}

    def producer():
        produced["n"] = pt.produce(events, ring, timeout=120.0)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    before = pipe.n_events
    t0 = time.monotonic()
    try:
        written = pipe.run(ring)
    finally:
        wall = time.monotonic() - t0
        ring.close()
        thread.join(timeout=60)
    if produced.get("n") != n_events or written != n_events or pipe.n_events - before != n_events:
        raise AssertionError(f"produced {produced.get('n')}, wrote {written}, expected {n_events}")
    return wall


def _peak_agreement(a, b):
    """Share of the peaks of two find_peaks results that match one-to-one
    at the same pixel, over the larger of the two counts."""
    (ya, _, na), (yb, _, nb) = a, b
    ya, na, yb, nb = ya.cpu().numpy(), na.cpu().numpy(), yb.cpu().numpy(), nb.cpu().numpy()
    hits = total = 0
    for r in range(len(na)):
        pa = {tuple(p) for p in ya[r, :na[r]]}
        pb = {tuple(p) for p in yb[r, :nb[r]]}
        hits += len(pa & pb)
        total += max(len(pa), len(pb))
    return hits / max(total, 1)


def phase_sfx(torch, pt, pool, calib_np, device):
    import numpy as np

    from psana_ray_tpu_torch.ops.fused_calib import fused_calibrate_plain

    params = pt.init_peaknet_tpu_params(SFX_FEATURES, seed=0)
    sink = PeakSink()
    pipe = pt.SfxPipeline(params, sink, calib=calib_np, config=pt.SfxConfig(batch_size=SFX_BATCH))
    if pipe.device != device:
        raise AssertionError(f"SfxPipeline chose {pipe.device}, not the card {device}")
    # warm-up outside the counted run (cuDNN picks the library convs' algorithms)
    warm = torch.from_numpy(np.stack(pool[:SFX_BATCH])).to(device)
    pipe.device_step(warm)
    torch.cuda.synchronize()
    del warm

    torch.cuda.reset_peak_memory_stats(device)
    pt.reset_counters()
    wall = run_sfx(torch, pt, pool, pipe, SFX_BATCHES)
    counts = pt.counts()
    nb = pipe.metrics.batches
    want = {"calib_kernel": nb, **NO_RESNET, "conv_block_kernel": 8 * nb, "flash_kernel": 0,
            **NO_BWD}
    if nb != SFX_BATCHES or counts != want:
        raise AssertionError(f"launch counts {counts} over {nb} batches, expected {want}")
    peak_mem = torch.cuda.max_memory_allocated(device) / 2**30

    # the last batch again: kernel-path logits against the plain path, and
    # the peaks the pipeline wrote against find_peaks of those logits
    n_events = SFX_BATCHES * SFX_BATCH
    last = list(range(n_events - SFX_BATCH, n_events))
    frames = torch.from_numpy(np.stack([pool[i % len(pool)] for i in last])).to(device)
    ped, gain, mask = (torch.from_numpy(a).to(device) for a in calib_np)
    cfg = pipe.cfg
    with torch.no_grad():
        cal = pt.fused_calibrate(frames, ped, gain, mask, threshold=cfg.calib_threshold,
                                 out_dtype=torch.bfloat16)
        logits = pt.peaknet_tpu_fused_infer(pipe.params, pt.panels_to_nhwc(cal, mode="batch"))
        cal_ref = fused_calibrate_plain(frames, ped, gain, mask, threshold=cfg.calib_threshold,
                                        out_dtype=torch.bfloat16)
        ref = pipe.model(pt.panels_to_nhwc(cal_ref, mode="batch"))
    kw = dict(max_peaks=cfg.max_peaks, threshold=cfg.peak_threshold, min_distance=cfg.min_distance)
    peaks, ref_peaks = pt.find_peaks(logits, **kw), pt.find_peaks(ref, **kw)
    torch.cuda.synchronize()
    err = rel_err(ref, logits)
    p, h = frames.shape[1], frames.shape[2]
    yx, score, n = (a.cpu().numpy() for a in peaks)
    rewritten = []
    for i in range(SFX_BATCH):
        rows = range(i * p, (i + 1) * p)
        rewritten.append(sorted(
            (float(yx[r, k, 0] + (r - i * p) * h), float(yx[r, k, 1])) for r in rows for k in range(n[r])))
    # the writer keeps an event's max_peaks brightest peaks: each written
    # peak must be one of the recomputed batch's
    written = {s.event_idx: list(zip(s.y.tolist(), s.x.tolist())) for s in sink.sets}
    hits = sum(len(set(written[e]) & set(rewritten[j])) for j, e in enumerate(last))
    recomputed = hits / max(sum(len(written[e]) for e in last), 1)
    if (tuple(logits.shape) != (SFX_BATCH * p, h, frames.shape[3], 1)
            or not torch.isfinite(logits).all()
            or not err < REL_TOL or recomputed < 0.99 or len(sink.sets) != n_events):
        raise AssertionError(f"SFX result wrong: logits {tuple(logits.shape)} rel_err {err}, "
                             f"share of written peaks found again {recomputed}, "
                             f"{len(sink.sets)} events written")
    summary = pipe.metrics.summary()
    emit("sfx_end_to_end", batches=nb, frames=summary["frames"], wall_s=wall, fps=summary["fps"],
         p50_batch_ms=summary["p50_ms"], p99_batch_ms=summary["p99_ms"],
         host_batch_ms=summary["host_batch_ms"], host_stage_ms=summary["host_stage_ms"],
         peak_mem_gib=peak_mem, peaks_written=pipe.n_peaks, launches=counts,
         logits_rel_err=err, logits_max_abs=float(ref.abs().max()),
         peak_agreement_kernel_vs_plain=_peak_agreement(peaks, ref_peaks),
         written_peaks_found_again=recomputed,
         peaks_last_batch=int(n.sum()))
    return pipe, counts


def _flash_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs a flash call computes: all of them, or with the
    top-left causal mask those with k <= q."""
    if not causal:
        return sq * sk
    n = min(sq, sk)
    return n * (n + 1) // 2 + (sq - n) * sk


def flash_cost(bh: int, sq: int, sk: int, d: int = 128, causal: bool = False):
    """(bytes, ops) of K5: q, k, v read once and o (bf16) and lse (f32)
    written once; two products of 2*d operations per (query, key) pair."""
    nbytes = bh * (2 * sq * d + 2 * 2 * sk * d + 2 * sq * d + 4 * sq)
    return nbytes, 2.0 * 2 * d * bh * _flash_pairs(sq, sk, causal)


# -- phases 10-12 ----------------------------------------------------------


def flat_attention(torch, v, sq, causal):
    """Attention that ignores the scores: each query row averages the
    values of the keys it may see, and its lse is the log of their count
    (the lse of all-zero scores). ``v`` is ``[B, H, Sk, D]``."""
    b, h, sk, _ = v.shape
    i = torch.arange(sq, device=v.device)
    n = (torch.clamp(i + 1, max=sk) if causal else torch.full_like(i, sk)).float()
    if causal:
        o = v.float().cumsum(2)[:, :, torch.clamp(i, max=sk - 1)] / n[:, None]
    else:
        o = v.float().mean(2, keepdim=True).expand(b, h, sq, -1)
    return o, torch.log(n).expand(b, h, sq)


def flash_errors(o, lse, o_ref, lse_ref, lse_flat) -> dict:
    """Max abs errors of ``o`` and ``lse``, and each over its own scale:
    ``max|o_ref|`` and ``max|lse_ref - lse_flat|``."""
    d_o = float((o.float() - o_ref.float()).abs().max())
    d_lse = float((lse - lse_ref).abs().max())
    return {"o": d_o, "lse": d_lse, "o_rel": d_o / float(o_ref.float().abs().max()),
            "lse_rel": d_lse / float((lse_ref - lse_flat).abs().max())}


def flash_ok(errs) -> bool:
    return all(errs[key] <= FLASH_TOL[key] for key in FLASH_TOL)


def phase_flash(torch, F, tf, timer, device):
    """K5 against its plain version in each case of ``FLASH_CASES``, and
    two controls that the same check must reject."""
    gen = torch.Generator(device=device).manual_seed(0)
    results = {}
    for name, b, h, sq, sk, causal in FLASH_CASES:
        def mk(s):
            return torch.randn((b, h, s, 128), generator=gen, device=device).bfloat16()

        q, k, v = mk(sq), mk(sk), mk(sk)
        o, lse = tf.launch_flash(q, k, v, causal)
        o_ref, lse_ref = tf.attention_with_stats_plain(q, k, v, causal)
        o_flat, lse_flat = flat_attention(torch, v, sq, causal)
        torch.cuda.synchronize()
        errs = flash_errors(o, lse, o_ref, lse_ref, lse_flat)
        if (not flash_ok(errs) or not torch.isfinite(o.float()).all()
                or not torch.isfinite(lse).all()):
            raise AssertionError(f"flash_kernel ({name}) disagrees with its plain version: {errs}")
        controls = {"zeros": flash_errors(torch.zeros_like(o), torch.zeros_like(lse), o_ref,
                                          lse_ref, lse_flat),
                    "flat": flash_errors(o_flat, lse_flat, o_ref, lse_ref, lse_flat)}
        passed = [c for c, e in controls.items() if flash_ok(e)]
        if passed:
            raise AssertionError(f"flash_kernel ({name}): the check passes the {passed} "
                                 f"control(s): {controls}")
        del o, o_ref, lse, lse_ref, o_flat, lse_flat
        nbytes, ops = flash_cost(b * h, sq, sk, causal=causal)
        bms, by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
        row = {
            "case": name, "shape_q": [b, h, sq, 128], "sk": sk, "causal": causal,
            "max_abs_err_o": errs["o"], "max_abs_err_lse": errs["lse"],
            "rel_err_o": errs["o_rel"], "rel_err_lse": errs["lse_rel"], "controls": controls,
            "ms": timer.ms(lambda: tf.launch_flash(q, k, v, causal), iters=10),
            "ms_cold": timer.ms_cold(lambda: tf.launch_flash(q, k, v, causal), iters=10),
            "plain_ms": timer.ms(lambda: tf.attention_with_stats_plain(q, k, v, causal),
                                 iters=3, warmup=1),
            "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
                                   iters=10),
            "bound_ms": bms, "bound_by": by, "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
        }
        row["tflops"] = ops / row["ms"] / 1e9
        emit("flash_kernel", **row)
        results[name] = row
        del q, k, v
    return results


def make_vit_step(torch, pt, consts, model):
    """The ViT serving step: calibrate to bf16, then the ViT."""
    ped, gain, mask = consts

    def step(batch):
        return pt.vit_serve_step(model, batch.frames, ped, gain, mask, threshold=10.0)

    return step


def phase_vit(torch, pt, tf, pool, consts, frame_shape, device):
    """The ViT serving path through the infeed, 6 batches of 2 frames."""
    import numpy as np

    from psana_ray_tpu_torch.ops.fused_calib import fused_calibrate_plain

    ped, gain, mask = consts
    params = pt.init_vit_params(frame_shape, seed=0)
    model = pt.vit_from_flax(params, device=device)

    def plain_attn(q, k, v):
        return tf.attention_with_stats_plain(*(t.transpose(1, 2) for t in (q, k, v)))[0].transpose(1, 2)

    def flat_attn(q, k, v):
        return flat_attention(torch, v.transpose(1, 2), q.shape[1], False)[0].to(v.dtype).transpose(1, 2)

    plain = pt.vit_from_flax(params, attn_fn=plain_attn, device=device)
    flat = pt.vit_from_flax(params, attn_fn=flat_attn, device=device)
    step = make_vit_step(torch, pt, consts, model)
    # warm-up outside the counted run (cuBLAS handles, the kernel library)
    warm = torch.from_numpy(np.stack(pool[:VIT_BATCH])).to(device)
    step(pt.Batch(warm, *(torch.zeros(VIT_BATCH, device=device) for _ in range(4)),
                  num_valid=VIT_BATCH))
    torch.cuda.synchronize()
    del warm

    last = {}

    def on_result(out, batch):
        last["out"], last["frames"] = out, batch.frames

    torch.cuda.reset_peak_memory_stats(device)
    pt.reset_counters()
    pipe, wall = run_pipeline(torch, pt, pool, step, device, VIT_BATCHES, on_result, batch=VIT_BATCH)
    counts = pt.counts()
    peak_mem = torch.cuda.max_memory_allocated(device) / 2**30
    nb = pipe.metrics.batches
    want = {"calib_kernel": nb, **NO_RESNET, "conv_block_kernel": 0,
            "flash_kernel": VIT_DEPTH * nb, **NO_BWD}
    if nb != VIT_BATCHES or counts != want:
        raise AssertionError(f"launch counts {counts} over {nb} batches, expected {want}")

    logits = last["out"]
    if tuple(logits.shape) != (VIT_BATCH, 2) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    with torch.no_grad():
        cal = fused_calibrate_plain(last["frames"], ped, gain, mask, threshold=10.0,
                                    out_dtype=torch.bfloat16)
        ref = plain(cal)
        ref_flat = flat(cal)
    torch.cuda.synchronize()
    err = rel_err(ref, logits)
    if not err < REL_TOL:
        raise AssertionError(f"ViT logits disagree with the plain path: rel_err {err}")
    summary = pipe.metrics.summary()
    emit("vit_end_to_end", batches=nb, frames=summary["frames"], wall_s=wall, fps=summary["fps"],
         p50_batch_ms=summary["p50_ms"], p99_batch_ms=summary["p99_ms"],
         host_batch_ms=summary["host_batch_ms"], host_stage_ms=summary["host_stage_ms"],
         peak_mem_gib=peak_mem, launches=counts, logits_rel_err=err,
         logits_max_abs=float(ref.abs().max()),
         logits_rel_err_flat_attention=rel_err(ref, ref_flat), tokens_per_frame=model.embed.pos_embed.shape[1])
    return model, counts


def phase_vit_profile(torch, pt, pool, consts, model, device, n_batches=4):
    """The ViT pipeline under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    step = make_vit_step(torch, pt, consts, model)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run_pipeline(torch, pt, pool, step, device, n_batches, batch=VIT_BATCH)
    emit("vit_profile", **profile_summary(torch, prof, wall, n_batches))


def phase_sfx_profile(torch, pt, pool, pipe, n_batches=4):
    """The SFX pipeline under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run_sfx(torch, pt, pool, pipe, n_batches)
    emit("sfx_profile", **profile_summary(torch, prof, wall, n_batches))


# -- phases 13-15 ----------------------------------------------------------


def flash_bwd_cost(bh: int, sq: int, sk: int, d: int = 128, causal: bool = False):
    """(bytes, ops, ops_7) of the backward: q, k, v and do (bf16) and lse
    and delta (f32) read once, dq, dk and dv (bf16) written once; five
    products of 2*d operations per (query, key) pair (s, dp, dv, dk, dq),
    what the function needs and ``flash_bwd_kernel`` does, and ``ops_7``
    for the seven of a two-kernel design that computes s and dp twice (the
    TPU kernels' split, ``flash.py:284-287``)."""
    t_q, t_k = 2 * bh * sq * d, 2 * bh * sk * d
    nbytes = 2 * t_q + 2 * t_k + 2 * 4 * bh * sq + t_q + 2 * t_k
    ops = 2.0 * d * bh * _flash_pairs(sq, sk, causal)
    return nbytes, 5 * ops, 7 * ops


def bwd_errors(got, ref) -> dict:
    """``max|g - g_ref| / max|g_ref|`` of each of dq, dk, dv."""
    return {n: rel_err(r, g) for n, g, r in zip(("dq", "dk", "dv"), got, ref)}


def bwd_ok(errs) -> bool:
    return all(errs[n] <= BWD_TOL for n in ("dq", "dk", "dv"))


def flat_attention_bwd(torch, do, sk, causal):
    """The backward of score-blind attention (p = 1/keys over the keys a
    query may see): p does not depend on q or k, so dq = dk = 0, and
    dv[key] sums do[q] / keys(q) over the queries that see the key."""
    b, h, sq, d = do.shape
    i = torch.arange(sq, device=do.device)
    n = (torch.clamp(i + 1, max=sk) if causal else torch.full_like(i, sk)).float()
    w = do.float() / n[:, None]
    dv = torch.zeros((b, h, sk, d), device=do.device)
    if causal:
        m = min(sq, sk)
        dv[:, :, :m] = w.flip(2).cumsum(2).flip(2)[:, :, :m]  # sum over q >= key
    else:
        dv += w.sum(2, keepdim=True)
    return torch.zeros_like(do), torch.zeros_like(dv), dv


def phase_flash_bwd(torch, F, tf, timer, device):
    """``flash_bwd_kernel`` (K6 and K7 in one pass) against
    ``attention_bwd_plain`` in each case of ``BWD_CASES``, two controls
    that the same check must reject, a repeat launch, and the errors of a
    backward that drops delta or ignores dlse (printed)."""
    gen = torch.Generator(device=device).manual_seed(1)
    results = {}
    for name, b, h, sq, sk, causal, with_dlse in BWD_CASES:
        def mk(*shape):
            return torch.randn(shape, generator=gen, device=device)

        q, k, v, do = (mk(b, h, s_, 128).bfloat16() for s_ in (sq, sk, sk, sq))
        dlse = mk(b, h, sq) if with_dlse else None
        o, lse = tf.launch_flash(q, k, v, causal)
        got = tf.launch_flash_bwd(q, k, v, o, lse, do, causal, dlse)
        ref = tf.attention_bwd_plain(q, k, v, o, lse, do, causal, dlse)
        torch.cuda.synchronize()
        errs = bwd_errors(got, ref)
        abs_err = {n: float((g.float() - r.float()).abs().max())
                   for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
        if not bwd_ok(errs) or not all(bool(torch.isfinite(g.float()).all()) for g in got):
            raise AssertionError(f"flash backward ({name}) disagrees with its plain version: {errs}")
        controls = {"zeros": bwd_errors([torch.zeros_like(g) for g in got], ref),
                    "flat": bwd_errors(flat_attention_bwd(torch, do, sk, causal), ref)}
        passed = [c for c, e in controls.items() if bwd_ok(e)]
        if passed:
            raise AssertionError(f"flash backward ({name}): the check passes the {passed} "
                                 f"control(s): {controls}")
        sens = {"drop_delta": tf.attention_bwd_plain(q, k, v, torch.zeros_like(o), lse, do, causal)}
        if with_dlse:
            sens["ignore_dlse"] = tf.attention_bwd_plain(q, k, v, o, lse, do, causal)
        sens = {c: bwd_errors(g, ref) for c, g in sens.items()}
        for e in sens.values():
            e["rejected"] = not bwd_ok(e)
        # the repeat check: dk and dv identical, dq within one bf16 ulp of
        # its largest value (its f32 sums arrive in another order each run)
        again = tf.launch_flash_bwd(q, k, v, o, lse, do, causal, dlse)
        torch.cuda.synchronize()
        repeat = {"dk_equal": bool(torch.equal(got[1], again[1])),
                  "dv_equal": bool(torch.equal(got[2], again[2])),
                  "dq_max_diff": float((got[0].float() - again[0].float()).abs().max()),
                  "dq_ulp": 2.0 ** -8 * float(ref[0].float().abs().max())}
        if not (repeat["dk_equal"] and repeat["dv_equal"]
                and repeat["dq_max_diff"] <= repeat["dq_ulp"]):
            raise AssertionError(f"flash backward ({name}): two launches disagree: {repeat}")
        del got, ref, again
        delta = tf.flash_bwd_delta(o, do, dlse)
        # the library yardstick, never called by the port: the backward of
        # F.scaled_dot_product_attention from a saved forward (dq, dk, dv)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        nbytes, ops, ops7 = flash_bwd_cost(b * h, sq, sk, causal=causal)
        bms, by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
        dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=device)

        def pair():  # what the backward launches: dq_acc zeroed, the kernel, the dq rounding
            return tf.launch_flash_bwd_dq_convert(
                tf.launch_flash_bwd_kernel(q, k, v, do, lse, delta, causal)[0])

        ms = timer.ms(pair, iters=10)
        row = {"case": name, "shape_q": [b, h, sq, 128], "sk": sk, "causal": causal,
               "dlse": with_dlse, "rel_err": errs, "max_abs_err": abs_err, "controls": controls,
               "sensitivity": sens, "repeat": repeat,
               "ms": ms, "ms_cold": timer.ms_cold(pair, iters=10),
               # the kernel alone (adding into a dq_acc that is not re-zeroed) and the rounding alone
               "kernel_ms": timer.ms(
                   lambda: tf.launch_flash_bwd_kernel(q, k, v, do, lse, delta, causal, dq_acc),
                   iters=10),
               "convert_ms": timer.ms(lambda: tf.launch_flash_bwd_dq_convert(dq_acc), iters=10),
               "bound_ms": bms, "bound_by": by, "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
               "tflops": ops / ms / 1e9,
               "bound_ms_7_products": bound_ms(nbytes, ops7, BF16_OPS_PER_S)[0]}
        # the plain version computes dq, dk and dv in one call
        row["plain_ms"] = timer.ms(lambda: tf.attention_bwd_plain(q, k, v, o, lse, do, causal, dlse),
                                   iters=3, warmup=1)
        row["library_ms"] = timer.ms(
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), iters=10)
        emit("flash_bwd", **row)
        results[name] = row
        del q, k, v, do, o, lse, delta, leaves, out, dq_acc
    return results


def reference_attention(torch, tf, kernel_forward=False, drop_delta=False):
    """A ``[B, S, H, D]`` ``attn_fn`` whose backward is the plain one
    (``attention_bwd_plain``) and whose forward is the plain one
    (``attention_with_stats_plain``) or, with ``kernel_forward``,
    ``flash_kernel``; with ``drop_delta`` the backward drops the delta
    term (``o`` taken as 0)."""
    forward = tf.launch_flash if kernel_forward else tf.attention_with_stats_plain

    class Reference(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            o, lse = forward(q, k, v)
            ctx.save_for_backward(q, k, v, o, lse)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            return tf.attention_bwd_plain(q, k, v, torch.zeros_like(o) if drop_delta else o, lse, do)

    def attn(q, k, v):
        return Reference.apply(*(t.transpose(1, 2) for t in (q, k, v))).transpose(1, 2)

    return attn


def phase_vit_train(torch, pt, tf, consts, frame_shape, device):
    """The ViT training recipe on the card: parity of one step against the
    plain attention, then ``train_hit_classifier`` for ``TRAIN_STEPS``
    steps, then accuracy on held-out events through ``vit_serve_step``."""
    import numpy as np

    ped, gain, mask = consts
    t0 = time.monotonic()
    src = pt.SyntheticSource(num_events=1, detector_name=TRAIN_DETECTOR, seed=7, hit_fraction=0.5)
    batches = [pt.raw_hit_batch(src, 8 * i, 8) for i in range(TRAIN_EVENTS // 8)]
    eval_frames, eval_labels = pt.raw_hit_batch(src, EVAL_START, EVAL_EVENTS)
    gen_s = time.monotonic() - t0
    params = pt.init_vit_params(frame_shape, seed=0)

    # parity: one forward and backward from the same init on the first
    # chunk. The kernel path (K5 forward, the K6/K7 kernel backward) against the plain
    # path (plain forward and backward), and, to tell the backward kernels
    # from the forward's rounding, against the kernel forward with the
    # plain backward (the same activations: only the backward kernel differs)
    with torch.no_grad():
        x = pt.fused_calibrate(torch.from_numpy(batches[0][0][:TRAIN_BATCH]).to(device), ped, gain,
                               mask, threshold=10.0, out_dtype=torch.bfloat16)
    labels = torch.from_numpy(batches[0][1][:TRAIN_BATCH]).to(device)
    valid = torch.ones(TRAIN_BATCH, dtype=torch.uint8, device=device)

    def grads(attn_fn):
        m = pt.vit_from_flax(params, attn_fn=attn_fn, device=device)
        loss = pt.masked_softmax_xent(m(x), labels, valid)
        loss.backward()
        return float(loss.detach()), {n: p.grad for n, p in m.named_parameters()}

    def compare(ref, got):
        err = {n: rel_err(ref[n], got[n]) for n in ref}
        worst = max(err, key=err.get)
        whole = rel_err(torch.cat([ref[n].flatten() for n in ref]),
                        torch.cat([got[n].flatten() for n in ref]))
        return {"worst_leaf": worst, "worst_rel_err": err[worst],
                "median_rel_err": float(np.median(list(err.values()))), "whole_rel_err": whole}

    loss_k, g_k = grads(None)
    loss_p, g_p = grads(reference_attention(torch, tf))
    loss_f, g_f = grads(reference_attention(torch, tf, kernel_forward=True))
    _, g_d = grads(reference_attention(torch, tf, kernel_forward=True, drop_delta=True))
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(g).all()) for g in g_k.values())
    parity = {"loss_kernel": loss_k, "loss_plain": loss_p, "loss_kernel_forward": loss_f,
              "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
              "backward_kernels": compare(g_f, g_k),   # flash_bwd_kernel vs plain, same forward
              "kernel_vs_plain_path": compare(g_p, g_k),
              "forward_rounding": compare(g_p, g_f),   # kernel vs plain forward, plain backward
              "drop_delta": compare(g_f, g_d)}
    parity["drop_delta"]["rejected"] = not parity["drop_delta"]["worst_rel_err"] < REL_TOL
    if not (parity["loss_rel_err"] <= REL_TOL and finite
            and parity["backward_kernels"]["worst_rel_err"] < REL_TOL):
        raise AssertionError(f"ViT train step disagrees with the plain attention: {parity}")
    emit("vit_train_parity", **parity)
    del g_k, g_p, g_f, g_d

    # the recipe, from the same init
    model = pt.vit_from_flax(params, device=device)
    stamps = []

    def on_step(n, loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    pt.reset_counters()
    t0 = time.perf_counter()
    model, losses = pt.train_hit_classifier(model, batches, ped, gain, mask, TRAIN_STEPS,
                                            device=device, on_step=on_step)
    counts = pt.counts()
    peak_mem = torch.cuda.max_memory_allocated(device) / 2**30
    chunks = sum(-(-len(lb) // TRAIN_BATCH) for _, lb in batches)
    n = VIT_DEPTH * TRAIN_STEPS
    want = {"calib_kernel": chunks, **NO_RESNET, "conv_block_kernel": 0,
            "flash_kernel": n, "flash_bwd_kernel": n, "flash_bwd_dq_convert": n}
    if counts != want:
        raise AssertionError(f"launch counts {counts} over {TRAIN_STEPS} steps, expected {want}")
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)) or not all(
            bool(torch.isfinite(p).all()) for p in model.parameters()):
        raise AssertionError(f"training diverged: losses {losses[:3]} ... {losses[-3:]}")
    step_ms = np.diff(stamps) * 1e3  # steps 1.. (step 0 also calibrates the chunks)

    preds = []
    for i in range(0, EVAL_EVENTS, TRAIN_BATCH):
        f = torch.from_numpy(eval_frames[i:i + TRAIN_BATCH]).to(device)
        preds.append(pt.vit_serve_step(model, f, ped, gain, mask).argmax(-1).cpu().numpy())
    acc = float((np.concatenate(preds) == eval_labels).mean())
    emit("vit_train", steps=TRAIN_STEPS, batch=TRAIN_BATCH, events=TRAIN_EVENTS,
         train_hits=int(sum(int(lb.sum()) for _, lb in batches)), event_gen_s=gen_s,
         first_step_ms=(stamps[0] - t0) * 1e3, p50_step_ms=float(np.percentile(step_ms, 50)),
         p99_step_ms=float(np.percentile(step_ms, 99)), mean_step_ms=float(step_ms.mean()),
         frames_per_s=TRAIN_BATCH / (float(step_ms.mean()) / 1e3), peak_mem_gib=peak_mem,
         loss_first20=float(np.mean(losses[:20])), loss_last20=float(np.mean(losses[-20:])),
         eval_events=EVAL_EVENTS, eval_hits=int(eval_labels.sum()), accuracy=acc,
         launches=counts)
    return {"model": model, "x": x, "labels": labels, "valid": valid}, counts


def phase_vit_train_profile(torch, pt, train):
    """``PROFILE_STEPS`` train steps of the trained model on one chunk
    under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    model = train["model"]
    schedule = pt.warmup_cosine_decay_schedule(0.0, 6e-4, 20, TRAIN_STEPS, 1e-5)
    step = pt.make_train_step(model, pt.adamw(model.parameters(), schedule, 0.01),
                              lambda lg, aux: pt.masked_softmax_xent(lg, *aux))
    aux = (train["labels"], train["valid"])
    step(train["x"], aux)  # warm-up: the optimizer's state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(PROFILE_STEPS):
            step(train["x"], aux)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    emit("vit_train_profile", **profile_summary(torch, prof, wall, PROFILE_STEPS))


# -- phase 16 ------------------------------------------------------------


def phase_narrow(torch, pt, device):
    """ResNet-50 at width 16 and PeakNet-TPU (32, 64, 128): narrower than
    the kernels' 64-channel quantum, so they run on zero-padded channels;
    each against its plain model, with exact launch counts."""
    gen = torch.Generator(device=device).manual_seed(3)
    model = pt.resnet_from_flax(pt.init_resnet_params(in_channels=4, width=16, seed=2),
                                device=device)
    x = torch.randn((2, 64, 64, 4), generator=gen, device=device)
    pt.reset_counters()
    logits, feat = pt.resnet_fused_infer(pt.pack_fused(model), x, return_features=True)
    resnet_counts = pt.counts()
    with torch.no_grad():
        ref_logits, ref_feat = model(x, return_features=True)
    unet = pt.unet_from_flax(pt.init_peaknet_tpu_params((32, 64, 128), seed=1), device=device)
    xu = torch.randn((2, 64, 128, 1), generator=gen, device=device)
    pt.reset_counters()
    got = pt.peaknet_tpu_fused_infer(pt.pack_unet(unet), xu)
    unet_counts = pt.counts()
    with torch.no_grad():
        ref = unet(xu)
    torch.cuda.synchronize()
    quiet = dict.fromkeys(resnet_counts, 0)
    errs = {"resnet_logits_rel_err": rel_err(ref_logits, logits),
            "resnet_features_rel_err": rel_err(ref_feat, feat),
            "unet_logits_rel_err": rel_err(ref, got)}
    want_resnet = {**quiet, "conv1x1_kernel": 16, "conv3x3_kernel": 16, "back_kernel": 16}
    want_unet = {**quiet, "conv_block_kernel": 3 + 2}
    if (resnet_counts != want_resnet or unet_counts != want_unet
            or not all(e < REL_TOL for e in errs.values())
            or not torch.isfinite(got).all() or float(ref_feat.abs().max()) < 1e-2):
        raise AssertionError(f"narrow models: counts {resnet_counts}, {unet_counts}; {errs}")
    emit("narrow", resnet_width=16, unet_features=[32, 64, 128], resnet_launches=resnet_counts,
         unet_launches=unet_counts, **errs)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "psana_ray_tpu_torch")):
        print("chip_smoke: run it from a checkout that holds psana_ray_tpu_torch/", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    import numpy as np
    import torch.nn.functional as F

    import psana_ray_tpu_torch as pt
    from psana_ray_tpu_torch.kernels import build
    from psana_ray_tpu_torch.models import fused_resnet as fr
    from psana_ray_tpu_torch.models import fused_unet as fu
    from psana_ray_tpu_torch.parallel import flash as tf

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit("device", kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    info = build.build()
    emit("build", seconds=info["seconds"], dir=info["dir"], ptxas=info["ptxas"])
    # the wgmma kernels: none may spill or serialize its wgmma; those of
    # conv_sm90.cu and flash.cu move 384 threads' 168 registers to their
    # consumers with setmaxnreg, so each must launch with exactly 168
    # (flash_bwd_kernel runs 256 threads without setmaxnreg, and the dq
    # rounding pass of flash_bwd.cu is no wgmma kernel)
    wgmma_libs = ("conv_sm90", "flash", "flash_bwd")
    sm90 = [r for r in info["ptxas"] if r["lib"] in wgmma_libs
            and (r["lib"] != "flash_bwd" or "flash_bwd_kernel" in r["function"])]
    emit("build_sm90", libraries={lib: sum(r["lib"] == lib for r in sm90) for lib in wgmma_libs},
         registers={lib: sorted({r.get("registers") for r in sm90 if r["lib"] == lib})
                    for lib in wgmma_libs},
         spills=sum(r["spill_stores"] + r["spill_loads"] for r in sm90),
         wgmma_serialized=[r["function"] for r in sm90 if r["wgmma_serialized"]],
         setmaxnreg_ignored=[r["function"] for r in sm90 if r["setmaxnreg_ignored"]])
    if ({r["lib"] for r in sm90} != set(wgmma_libs)
            or any(r["spill_stores"] + r["spill_loads"] or r["wgmma_serialized"]
                   or r["setmaxnreg_ignored"]
                   or (r["lib"] != "flash_bwd" and r.get("registers") != 168) for r in sm90)):
        raise AssertionError(f"the wgmma kernels spill, serialize or lose setmaxnreg: {sm90}")

    t0 = time.monotonic()
    src = pt.SyntheticSource(num_events=POOL_EVENTS, detector_name="epix10k2M", seed=0)
    pool = [src.event(i, pt.RetrievalMode.RAW)[0] for i in range(POOL_EVENTS)]
    emit("events", n=len(pool), shape=list(pool[0].shape), seconds=time.monotonic() - t0)

    timer = Timer(torch, device)
    raw = torch.from_numpy(np.stack(pool[:BATCH])).to(device)
    calib, consts = phase_calib(torch, pt, timer, src, raw, device)
    del raw

    model = pt.resnet_from_flax(
        pt.init_resnet_params(in_channels=src.spec.panels, seed=0), device=device)
    params = pt.pack_fused(model)
    per_kernel, _ = phase_bottleneck(
        torch, F, fr, timer, params, (src.spec.height, src.spec.width), device)

    counts = phase_end_to_end(torch, pt, pool, consts, model, params, device)
    phase_profile(torch, pt, pool, consts, params, device)
    del model, params

    calib_np = (src.pedestal(), src.spec.adu_gain * src.gain_map(), src.create_bad_pixel_mask())
    uparams = pt.pack_unet(pt.unet_from_flax(pt.init_peaknet_tpu_params(SFX_FEATURES, seed=0),
                                             device=device))
    conv_block, _ = phase_conv_block(torch, F, fu, timer, uparams, device)
    del uparams
    pipe, sfx_counts = phase_sfx(torch, pt, pool, calib_np, device)
    phase_sfx_profile(torch, pt, pool, pipe)
    del pipe

    flash = phase_flash(torch, F, tf, timer, device)
    vit, vit_counts = phase_vit(torch, pt, tf, pool, consts, src.spec.frame_shape, device)
    phase_vit_profile(torch, pt, pool, consts, vit, device)
    flash_bwd = phase_flash_bwd(torch, F, tf, timer, device)
    train, train_counts = phase_vit_train(torch, pt, tf, consts, src.spec.frame_shape, device)
    phase_vit_train_profile(torch, pt, train)
    phase_narrow(torch, pt, device)

    csrc = "psana_ray_tpu_torch/csrc"
    c = calib["bf16"]
    kernels = [{
        "name": "calib_kernel", "route": "cuda", "source": f"{csrc}/calib.cu",
        "replaces": "psana_ray_tpu/ops/pallas_calib.py:60",
        "launches": (counts["calib_kernel"] + sfx_counts["calib_kernel"] + vit_counts["calib_kernel"]
                     + train_counts["calib_kernel"]),
        "max_abs_err": max(calib["f32"]["max_abs_err"], c["max_abs_err"]),
        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"], "library_ms": None,
    }]
    replaces = {
        "conv1x1_kernel": "psana_ray_tpu/models/pallas_resnet.py:95",
        "conv3x3_kernel": "psana_ray_tpu/models/pallas_resnet.py:95",
        "back_kernel": "psana_ray_tpu/models/pallas_resnet.py:251",
    }
    for name, agg in per_kernel.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{csrc}/conv_sm90.cu",
            "replaces": replaces[name], "launches": counts[name],
            "max_abs_err": agg["max_abs_err"], "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"], "bound_by": agg["bound_by"],
            "library_ms": agg["library_ms"],
        })
    kernels.append({
        "name": "conv_block_kernel", "route": "cuda", "source": f"{csrc}/conv_sm90.cu",
        "replaces": "psana_ray_tpu/models/pallas_unet.py:55",
        "launches": sfx_counts["conv_block_kernel"], "max_abs_err": conv_block["max_abs_err"],
        "ms": conv_block["ms"], "plain_ms": conv_block["plain_ms"],
        "bound_ms": conv_block["bound_ms"], "bound_by": conv_block["bound_by"],
        "library_ms": conv_block["library_ms"],
    })
    f = flash["serving"]  # one batch of the main path: VIT_DEPTH launches at this shape
    kernels.append({
        "name": "flash_kernel", "route": "cuda", "source": f"{csrc}/flash.cu",
        "replaces": "psana_ray_tpu/parallel/flash.py:155",
        "launches": vit_counts["flash_kernel"] + train_counts["flash_kernel"],
        "max_abs_err": max(r["max_abs_err_o"] for r in flash.values()),
        "ms": VIT_DEPTH * f["ms"], "plain_ms": VIT_DEPTH * f["plain_ms"],
        "bound_ms": VIT_DEPTH * f["bound_ms"], "bound_by": f["bound_by"],
        "library_ms": VIT_DEPTH * f["library_ms"],
    })
    tb = flash_bwd["training"]  # one train step: VIT_DEPTH launches at this shape
    # K6 and K7 are one kernel: both rows give the pair's numbers, and the
    # SDPA backward (dq, dk and dv in one call) is given once, with K6
    for line, grads in ((314, ("dk", "dv")), (354, ("dq",))):
        kernels.append({
            "name": "flash_bwd_kernel", "route": "cuda", "source": f"{csrc}/flash_bwd.cu",
            "replaces": f"psana_ray_tpu/parallel/flash.py:{line}",
            "launches": train_counts["flash_bwd_kernel"],
            "max_abs_err": max(r["max_abs_err"][g] for r in flash_bwd.values() for g in grads),
            "ms": VIT_DEPTH * tb["ms"], "plain_ms": VIT_DEPTH * tb["plain_ms"],
            "bound_ms": VIT_DEPTH * tb["bound_ms"], "bound_by": tb["bound_by"],
            "library_ms": VIT_DEPTH * tb["library_ms"] if line == 314 else None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
