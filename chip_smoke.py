#!/usr/bin/env python3
"""Drive the port's three serving paths and its training paths on one
NVIDIA H100: the calibrated ResNet-50 classifier (also fed by a producer
process through the shared-memory ring), the SFX Bragg-peak pipeline
(PeakNet-TPU U-Net), the ViT hit classifier with the flash-attention
trunk, the ViT's training recipe with the flash backward kernels,
train -> fold -> serve: PeakNet-TPU and ResNet-50 trained with BatchNorm,
folded into frozen affines and served through the kernels, the
two-detector fan-in (BASELINE config 5), the SFX operator CLI over
``shm://``, BASELINE config 1 through the producer and consumer CLIs,
the stage ranges on the profiler's timeline, and the producer CLI
feeding the SFX CLI.

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
   f32 RAW frames from ``SyntheticSource`` with f32 and bf16 output, the
   same frames as uint16 ADUs with bf16 output, and ``[8, 8, 512, 1024]``
   jungfrau4M frames drawn on the card from a seeded generator with bf16
   output (f32: rtol 1e-5, atol 1e-4; bf16: that plus one bf16 ulp; two
   launches on one input bit-identical). Each case gives the plan it ran
   (route, cluster size, rows and shared memory a CTA, the card's
   ``cudaOccupancyMaxActiveClusters``, the load mode), both timers and
   GB/s on the bound's bytes; the epix10k2M cases also time the two-pass
   route on the same input, checked too (``two_pass_ms``; other cluster
   sizes are ``tools/calib_ablation.py``'s). A ``build_calib`` line after the
   build gives K1's registers, spills and static shared memory from
   ``-Xptxas -v`` and fails the run on a spill.
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
5. ``end_to_end``: a producer thread fills the port's ``RingBuffer`` with
   RAW events; ``InfeedPipeline(batch_size=32, prefetch_depth=2,
   batcher_buffers=6)`` (six pinned batch arenas, allocated at the first
   record) -> ``fused_calibrate(bf16)`` -> ``panels_to_nhwc`` ->
   ``resnet_fused_infer`` for 6 warm-up and 24 timed batches (the times,
   fps and p50/p99 are the timed ones'). Launch counts must be +1
   ``calib_kernel``, +16 ``conv1x1_kernel``, +16 ``conv3x3_kernel`` and
   +16 ``back_kernel`` per batch; every batch must go to the card in one
   H2D copy straight from its pinned arena with no host copy beside the
   batcher's (host bytes copied a frame = one frame); the last batch's
   logits and pooled features are checked against the plain path on the
   card.
6. ``profile``: the same pipeline for 4 timed batches after the warm-up
   under ``torch.profiler``: device time by kernel, the device's idle
   share and the busiest host ops.
6b. ``shm_end_to_end``: the same serving path fed by another process: a
   ``spawn`` producer process (``produce_synthetic``, which loads no
   torch) draws the same pool from the same seed and writes it into a
   ``ShmRingBuffer`` of 64 slots (``/dev/shm`` is checked for room
   first); this process attaches and drains it with ``get_batch_view`` ->
   ``push_view`` into the pinned arenas, 6 + 24 batches. Held as
   ``end_to_end`` is, plus: produced = consumed, every arena pinned, no
   byte copied out of a slot (``bytes_copied_out`` 0), and the last
   batch's frames equal to the pool's. Prints ``/dev/shm``'s size.
6c. ``passthrough_cli``: BASELINE config 1, producer -> queue -> consumer
   no-op, through the programs a user runs. 128 epix10k2M f32 RAW events
   of ``SyntheticSource(seed=0)`` with their photon energies go into an
   uncompressed ``.npz`` under ``build/chip_smoke/`` (1.1 GB, deleted
   after ``stage_trace``); a fresh 32-slot shm ring (``/dev/shm`` checked
   for room first); two ``python -m psana_ray_tpu_torch.consumer --quiet
   --status_interval 1`` processes start on it, and 1.5 s later ``python
   -m psana_ray_tpu_torch.producer --exp replay:<npz> --num_shards 2
   --num_consumers 2 --queue_size 32``. Every process runs with ``-X
   importtime``: all three must exit 0 and import neither torch nor JAX,
   and the consumers' "end of stream after k frames" must sum to 128.
   Prints the aggregate frames/s and GB/s (every frame over the longest
   consumer's first-to-last span, from their status lines), each
   consumer's, the producer's, the ring's puts, gets and rejected puts;
   then the same with ``--wire_dtype uint16`` on the producer, and the
   bytes a frame of both. Then, on one thread of this process, the mean
   ms a frame to copy it out of the mapped file, to put it into a fresh
   and a used ring, and to get it back out.
6d. ``stage_trace``: the ResNet pipeline of phase 5 for 4 batches
   without, then with ``utils.trace.trace``: the exported Chrome trace
   must hold 4 ``stage.device_put`` and 4 ``stage.dispatch`` ranges and
   the device events of K1 (``calib_*_kernel``), K2 (``conv_sm90_kernel<N,
   0>``, 128) and K3 (``conv_sm90_kernel<N, 2|3>``, 64), under the names
   the profiler gives them; launches exact. Then phase 6c's consumer 0
   alone with ``--profile_dir``, whose trace file must exist. Prints the
   trace's size and the p50 batch ms without and with the capture.
7. ``conv_block``: the three K4 encoder levels of PeakNet-TPU at full width
   (features 64-128-256-512, s2d 2) and batch 128 (8 epix10k2M frames x
   16 panels): level 1 88x96 64->128, level 2 44x48 128->256, bottleneck
   22x24 256->512 with no downsample. Every 3x3 ``conv_sm90_kernel``
   launch against its plain version and each level against the chain of
   plain versions (``rel_err < 0.05``), with kernel, plain and library
   (bf16 channels-last ``F.conv2d``) times, the TFLOP/s each launch and
   level reaches, the fused level's bound and the bound of the three
   launches (y1 and skip through HBM).
8. ``sfx_end_to_end``: a producer thread fills a ``RingBuffer`` with RAW
   events; ``SfxPipeline(SfxConfig(batch_size=8)).run`` drains them
   through its six pinned arenas (``calib_kernel`` ->
   ``peaknet_tpu_fused_infer`` -> ``find_peaks`` -> an in-memory writer)
   for 6 warm-up and 24 timed batches. Launch counts must be +1
   ``calib_kernel`` and +8 ``conv_block_kernel`` per batch, each batch one
   H2D from its arena; the last batch's logits are checked against the
   plain path on the card, and the peaks written for it against a
   recomputation.
9. ``sfx_profile``: the same pipeline for 4 timed batches under
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
11. ``vit_end_to_end``: a producer thread fills a ``RingBuffer`` with RAW
   events; ``InfeedPipeline(batch_size=2, prefetch_depth=2,
   batcher_buffers=6)`` -> ``vit_serve_step`` (``calib_kernel`` to bf16 ->
   ``ViTHitClassifier`` at the reference's defaults: patch 16, embed 512,
   depth 4, 4 heads, 8448 tokens a frame) for 6 warm-up and 24 timed
   batches. Launch counts must be +1 ``calib_kernel`` and +4
   ``flash_kernel`` per batch and nothing else, each batch one H2D from
   its pinned arena; the last batch's logits are checked against the
   plain path on the card (``fused_calibrate_plain`` and the model with
   the plain attention). The same model with score-blind attention (the
   flat control above) gives the logits' sensitivity to attention.
12. ``vit_profile``: the same pipeline for 4 timed batches under
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
17. ``peaknet_train``: train -> fold -> serve at PeakNet-TPU's full width
   (64, 128, 256, 512), s2d 2: ``train_peaknet`` with ``norm="batch"``
   (the recipe of ``examples/train_peaknet.py``: ``calib_kernel`` to f32,
   labels ``x > 50`` photons, focal loss alpha 0.95, AdamW 3e-3) at batch
   2 for 300 steps, the batches cycling over the 64-event RAW pool;
   exactly one ``calib_kernel`` launch a step and nothing else, and the
   mean loss of the last 20 steps below that of the first 20. Then, with
   no JAX: ``unet_to_flax`` -> ``fold_batchnorm`` -> ``save_params`` /
   ``load_params`` (bit-exact) -> ``SfxPipeline`` over 16 held-out RAW
   events of run 2 (+1 ``calib_kernel`` and +8 ``conv_block_kernel`` a
   batch, exactly), the folded fused logits of the first held-out batch
   against the ``norm="batch_eval"`` model with the trained weights
   (``rel_err < 0.05``). Prints p50/p99 step ms (synchronised after each
   step), training frames/s, peak memory, the first and last losses, and
   the written peaks' recall and precision against the planted truth
   (recorded, not gated).
17b. ``peaknet_train_profile``: 4 more steps of the trained model under
   ``torch.profiler``.
17c. ``fanin``: BASELINE config 5's device leg at full detector geometry.
   Two ``spawn`` producer processes (``produce_synthetic``) stream
   epix10k2M and jungfrau4M f32 RAW frames into their own shm rings of 32
   slots; one ``FanInPipeline`` (epix10k2M at batch 16, jungfrau4M at
   batch 8, merge depth 2, pinned arenas at the fan-in floor of 10 a leg)
   runs ``fused_calibrate`` (``calib_kernel``, f32) on each detector's
   batches with its own constants, 30 batches a leg. Each detector's
   count must equal its producer's events, ``calib_kernel`` must launch
   exactly once a batch and nothing else, each leg's last batch must be
   within K1's f32 tolerance of ``fused_calibrate_plain`` on the card, and
   the consumer must see the legs interleaved. Prints each leg's frames/s
   and its staging thread's host ms to assemble and to stage a batch after
   its first 6 batches, the aggregate frames/s over the window where both
   legs are past theirs, and the pinned bytes.
17d. ``sfx_cli``: the operator CLI (``sfx.run(sfx.parse_args(...),
   writer=<in-memory>)``) over ``shm://``, fed by a ``spawn`` producer,
   serving ``peaknet_train``'s parameter file with ``--mode quality``,
   ``--calib_npz`` and ``--cursor_path`` in a temporary directory under
   ``build/chip_smoke/``. First the 16 held-out events ``peaknet_train``
   served in-process: the peak sets must equal its, with exactly +1
   ``calib_kernel`` and +8 ``conv_block_kernel`` a batch and a cursor
   at 16. Then 240 events cut by ``--max_events 200``: 26 batches
   written (the one in flight drained), their launches exact, the cursor
   at 208; prints frames/s and p50/p99 batch ms after 6 warm-up batches.
17e. ``producer_cli_sfx``: config 3 through the two normal entry
   points: ``peaknet_train``'s 16 held-out RAW events written to a replay
   ``.npz``, replayed by the producer CLI (a process) over ``shm://`` into
   the SFX CLI (in-process: the card's machine has no h5py). The peak
   sets must equal ``peaknet_train``'s bit for bit, with exactly 2
   ``calib_kernel`` and 16 ``conv_block_kernel`` launches; prints the
   wall seconds.
18. ``resnet_fold``: config 4's ResNet-50 (width 64, (3, 4, 6, 3)) with
   ``norm="batch"`` trained 3 steps (``masked_softmax_xent``, full
   batches of 8, +1 ``calib_kernel`` a step), then ``resnet_to_flax`` ->
   ``fold_batchnorm`` -> ``resnet_from_flax`` -> ``pack_fused`` ->
   ``resnet_fused_infer`` on 32 frames calibrated by K1 (+1
   ``calib_kernel``, +16 ``conv1x1_kernel``, +16 ``conv3x3_kernel``, +16
   ``back_kernel``, exactly), logits and pooled features against the
   ``norm="batch_eval"`` model (``rel_err < 0.05``).

Then a ``{"kernels": [...]}`` line and, last, the device line. Any failure
raises and exits non-zero before the device line is printed. The
``calib_kernel`` launches in the kernels line are those of the three
serving runs, the shm-fed run, the traced runs, the training runs, the
fan-in, the CLIs and the fold runs (phases 5, 6b, 6d, 8, 11, 14, 17, 17c,
17d, 17e and 18), those of ``conv1x1_kernel``, ``conv3x3_kernel`` and
``back_kernel`` the ResNet runs' (5, 6b, 6d and 18), those of
``conv_block_kernel`` the SFX runs' (8, 17, 17d and 17e), the
``flash_kernel`` launches those of the ViT's serving and training runs;
every other kernel runs on one path only. Each run sets the counts to 0
just before it and reads them just after.

Times are CUDA-event times of one launch with the 50 MB L2 flushed before
it, after warm-up, with the card kept busy (a spin of about a
millisecond, ``torch.cuda._sleep``) between the flush and the start
event, so that the host prepares the launch (tensor maps, ctypes) while
the card works and the time is the card's alone. ``ms_cold``
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
DETECTOR = "epix10k2M"  # the serving paths' frames: [16, 352, 384]
BATCH = 32
E2E_BATCHES = 24  # timed batches of each serving run, after the warm-up
PREFETCH_DEPTH = 2
BUFFERS = PREFETCH_DEPTH + 4  # pinned batch arenas of each serving run
WARMUP_BATCHES = BUFFERS  # untimed: every arena written once, the ring filled before them
PROFILE_BATCHES = 4
POOL_EVENTS = 64
REL_TOL = 0.05
JUNGFRAU_BATCH = 8  # frames of K1's jungfrau4M case
SFX_BATCH = 8  # frames; 128 panel-rows of epix10k2M
SFX_FEATURES = (64, 128, 256, 512)
SFX_BATCHES = 24
VIT_BATCH = 2  # frames; each one 8448-token sequence
VIT_BATCHES = 24
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
# train -> fold -> serve: PeakNet-TPU at full width trained with norm="batch"
# (examples/train_peaknet.py's recipe at its batch 2 for its convergence scale,
# 300 steps), served over held-out events of another run; ResNet-50 at
# config 4's width trained 3 steps at batch 8, folded and served at batch 32
PEAKNET_STEPS = 300
PEAKNET_BATCH = 2
PEAKNET_EVAL_RUN = 2
PEAKNET_EVAL_EVENTS = 16  # two SFX batches
# config 5 (bench.py:4858-4925): each detector's RAW frames, its batch, its
# ring's slots and its producer's pool of events
FANIN_LEGS = (("epix10k2M", 16, 32, 16), ("jungfrau4M", 8, 32, 8))
FANIN_BATCHES = 30  # a leg
FANIN_WARMUP = 6  # batches of each leg left out of the rates
FANIN_MERGE_DEPTH = 2
CLI_BATCHES = 26  # batches the bounded CLI run writes: --max_events 8 * 25 + the one in flight
UNET_LAUNCHES = 8  # conv_block_kernel launches a batch of SFX_FEATURES: 3 + 3 + 2
FOLD_STEPS = 3
FOLD_BATCH = 8
FOLD_LR = 1e-3
# (level, index into FusedUNet.levels, h, w) at s2d 2 on 352x384 panels
UNET_LEVELS = (("level1", 0, 88, 96), ("level2", 1, 44, 48), ("bottleneck", 2, 22, 24))
CFG1_EVENTS = 128  # passthrough_cli: epix10k2M f32 RAW events in the replay file (1.1 GB)
CFG1_SLOTS = 32  # the CLIs' shm ring: 32 slots of ShmRingBuffer.DEFAULT_SLOT_BYTES
CONSUMER_LEAD_S = 1.5  # the consumers start and attach this long before the producer
TRACE_BATCHES = 4  # stage_trace: ResNet-50 batches under the capture

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


def calib_err(torch, got, ref, what: str) -> float:
    """Max abs error of ``got`` against the plain version ``ref``; raises
    outside rtol 1e-5 / atol 1e-4 (bf16 output: plus one bf16 ulp) or on a
    non-finite value."""
    ref = ref.float()
    diff = (got.float() - ref).abs()
    tol = 1e-4 + 1e-5 * ref.abs()
    if got.dtype == torch.bfloat16:
        # f32 values that differ by the f32 tolerance can round to
        # neighbouring bf16 values: allow one bf16 ulp (8 significant
        # bits) of the plain version's value on top
        tol = tol + torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
    if not bool(torch.all(diff <= tol)) or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"calib_kernel ({what}) disagrees with its plain version: "
                             f"max abs err {float(diff.max())}")
    return float(diff.max())


def calib_case(torch, fc, timer, raw, ped, gain, mask, out_dtype, what, routes=True):
    """One K1 case: the wrapper's plan against its plain version, both
    timers, GB/s on the bound's bytes; with ``routes``, the two-pass route
    on the same input, checked too."""
    b, p, h, w = raw.shape
    npix = b * p * h * w

    def call(plan=None):
        return fc.fused_calibrate(raw, ped, gain, mask, out_dtype=out_dtype, plan=plan)

    got = call()
    err = calib_err(torch, got, fc.fused_calibrate_plain(raw, ped, gain, mask, out_dtype=out_dtype),
                    what)
    if not torch.equal(got, call()):
        raise AssertionError(f"calib_kernel ({what}): two launches on one input differ")
    plan, load, active = fc.runnable_plan(raw, ped, gain, mask, out_dtype)
    nbytes = raw.numel() * raw.element_size() + npix * got.element_size() + p * h * w * (4 + 4 + 1)
    bms, by = bound_ms(nbytes, 7.0 * npix, F32_OPS_PER_S)
    ms = timer.ms(call, iters=20)
    res = {
        "shape": [b, p, h, w], "raw": str(raw.dtype), "out": str(out_dtype),
        "route": plan.route, "cluster": plan.cluster, "rows_per_cta": plan.rows_per_cta,
        "smem_per_cta": plan.smem_bytes, "active_clusters": active, "load": load,
        "max_abs_err": err, "ms": ms, "ms_cold": timer.ms_cold(call, iters=20),
        "plain_ms": timer.ms(
            lambda: fc.fused_calibrate_plain(raw, ped, gain, mask, out_dtype=out_dtype), iters=5),
        "bound_ms": bms, "bound_by": by, "bytes": nbytes, "gb_per_s": nbytes / ms / 1e6,
    }
    if routes:
        calib_err(torch, call(fc.TWO_PASS), got.float(), f"{what}, two-pass route")
        res["two_pass_ms"] = timer.ms(lambda: call(fc.TWO_PASS), iters=20)
    return res


def phase_calib(torch, pt, timer, src, raw, device):
    """K1 on epix10k2M (f32 raw to f32 and bf16, uint16 raw to bf16) and on
    jungfrau4M (f32 raw to bf16, generated on the card)."""
    import numpy as np

    from psana_ray_tpu_torch.ops import fused_calib as fc

    ped = torch.from_numpy(src.pedestal()).to(device)
    gain = torch.from_numpy(src.gain_map()).to(device)
    mask = torch.from_numpy(src.create_bad_pixel_mask()).to(device)
    raw_u16 = torch.from_numpy(
        np.clip(np.rint(raw.cpu().numpy()), 0, 65535).astype(np.uint16)).to(device)
    result = {
        "f32": calib_case(torch, fc, timer, raw, ped, gain, mask, torch.float32, "f32 out"),
        "bf16": calib_case(torch, fc, timer, raw, ped, gain, mask, torch.bfloat16, "bf16 out"),
        "u16_bf16": calib_case(torch, fc, timer, raw_u16, ped, gain, mask, torch.bfloat16,
                               "uint16 raw, bf16 out"),
    }
    del raw_u16
    # jungfrau4M: 2 MiB panels, more than a portable cluster of 8 holds
    spec = pt.DETECTORS["jungfrau4M"]
    p, h, w = spec.frame_shape
    gen = torch.Generator(device=device).manual_seed(0)
    jped = 100.0 + 3.0 * torch.randn((p, h, w), generator=gen, device=device)
    jgain = 1.0 + 0.02 * torch.randn((p, h, w), generator=gen, device=device)
    jmask = (torch.rand((p, h, w), generator=gen, device=device) > 0.003).to(torch.uint8)
    shape = (JUNGFRAU_BATCH, p, h, w)
    photons = torch.poisson(torch.full(shape, 0.1, device=device), generator=gen)
    jraw = (jped + 35.0 * photons * jgain + 2.5 * torch.randn(shape, generator=gen, device=device))
    del photons
    result["jungfrau4M_bf16"] = calib_case(torch, fc, timer, jraw, jped, jgain, jmask,
                                           torch.bfloat16, "jungfrau4M, bf16 out", routes=False)
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


def start_producer(pt, ring, pool, n_events):
    """A producer thread puts ``n_events`` RAW events (the pool, cycled)
    and one EOS into ``ring``; returns the thread and a dict that gets the
    count. Returns once the ring is full (or the producer is done), so a
    run starts at steady state."""
    events = ((i, pool[i % len(pool)], 10.0) for i in range(n_events))
    produced = {}

    def producer():
        produced["n"] = pt.produce(events, ring, timeout=120.0)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    wait_full(ring, thread.is_alive)
    return thread, produced


def wait_full(ring, alive, timeout=180.0):
    deadline = time.monotonic() + timeout
    while ring.size() < ring.maxsize and alive():
        if time.monotonic() > deadline:
            raise AssertionError(f"the producer filled {ring.size()} of {ring.maxsize} slots "
                                 f"in {timeout} s")
        time.sleep(0.01)


def check_staging(pt, metrics, n_batches, frame_nbytes, batcher=None):
    """Every batch went to the card straight from a pinned arena, and the
    host copied each frame once: the counts of ``PipelineMetrics`` and,
    its batcher's arenas (``arenas_pinned`` is null where no batcher was
    given)."""
    s = metrics.summary()
    pinned = None
    if batcher is not None:
        pinned = [bool(t.is_pinned()) for a in batcher.pool for t in a.tensors]
        if len(batcher.pool) != BUFFERS or not all(pinned):
            raise AssertionError(f"{len(batcher.pool)} arenas, pinned {pinned}: expected "
                                 f"{BUFFERS}, all pinned")
    if s["arena_copies"] != n_batches or s["host_frame_bytes_per_frame"] != frame_nbytes:
        raise AssertionError(f"{s['arena_copies']} of {n_batches} batches copied from their "
                             f"arena, {s['host_frame_bytes_per_frame']} host bytes copied a "
                             f"frame against {frame_nbytes}")
    return {"arenas": BUFFERS, "arenas_pinned": None if pinned is None else all(pinned),
            "arena_h2d_copies": s["arena_copies"],
            "host_bytes_copied_per_batch": metrics.host_frame_bytes / n_batches,
            "host_bytes_copied_per_frame": s["host_frame_bytes_per_frame"],
            "frame_bytes": frame_nbytes}


def run_pipeline(torch, pt, pool, step, device, n_batches, on_result=None, batch=BATCH):
    """A producer thread fills a ``RingBuffer`` with ``WARMUP_BATCHES +
    n_batches`` batches of RAW events (the pool, cycled) and one EOS;
    ``InfeedPipeline`` with pinned batch arenas drives ``step`` over them,
    timing the last ``n_batches``. Returns the pipeline and the wall
    seconds of the whole run."""
    total = WARMUP_BATCHES + n_batches
    ring = pt.RingBuffer(maxsize=3 * batch)
    thread, produced = start_producer(pt, ring, pool, total * batch)
    pipe = pt.InfeedPipeline(ring, batch_size=batch, device=device, prefetch_depth=PREFETCH_DEPTH,
                             batcher_buffers=BUFFERS,
                             metrics=pt.PipelineMetrics(warmup=WARMUP_BATCHES))
    t0 = time.monotonic()
    try:
        seen = pipe.run(step, on_result=on_result, block_until_ready=True)
    finally:
        wall = time.monotonic() - t0
        ring.close()
        thread.join(timeout=60)
    if produced.get("n") != total * batch or seen != total * batch or pipe.metrics.batches.count != n_batches:
        raise AssertionError(f"produced {produced.get('n')}, consumed {seen} in "
                             f"{pipe.metrics.batches.count} timed batches, expected {total * batch}")
    return pipe, wall


def profiled(torch, run, n_batches):
    """``run(on_batch)`` under ``torch.profiler``, switched on when the
    warm-up's last batch is done: the summary covers the ``n_batches``
    timed batches only. ``run`` calls ``on_batch()`` after each batch."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    state = {"done": 0, "t0": None}

    def on_batch():
        state["done"] += 1
        if state["done"] == WARMUP_BATCHES:
            torch.cuda.synchronize()
            prof.start()
            state["t0"] = time.monotonic()

    run(on_batch)
    torch.cuda.synchronize()
    wall = time.monotonic() - state["t0"]
    prof.stop()
    return profile_summary(torch, prof, wall, n_batches)


def phase_end_to_end(torch, pt, pool, consts, model, params, device):
    import numpy as np

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
    nb = WARMUP_BATCHES + pipe.metrics.batches.count
    check_resnet_counts(counts, nb)
    staging = check_staging(pt, pipe.metrics, nb, pool[0].nbytes, pipe.batcher)
    errs = check_resnet_result(torch, pt, model, consts, last)
    summary = pipe.metrics.summary()
    result = {
        "batches": nb, "timed_batches": summary["batches"], "frames": summary["frames"],
        "wall_s": wall, "fps": summary["fps"],
        "p50_batch_ms": summary["p50_ms"], "p99_batch_ms": summary["p99_ms"],
        "host_batch_ms": summary["host_batch_ms"], "host_stage_ms": summary["host_stage_ms"],
        "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30,
        "launches": counts, **staging, **errs,
    }
    emit("end_to_end", **result)
    return counts


def check_resnet_counts(counts, nb):
    want = {"calib_kernel": nb, "conv1x1_kernel": 16 * nb, "conv3x3_kernel": 16 * nb,
            "back_kernel": 16 * nb, "conv_block_kernel": 0, "flash_kernel": 0, **NO_BWD}
    if counts != want:
        raise AssertionError(f"launch counts {counts} over {nb} batches, expected {want}")


def check_resnet_result(torch, pt, model, consts, last):
    """The last batch's logits and pooled features against the plain path
    on the same frames."""
    from psana_ray_tpu_torch.ops.fused_calib import fused_calibrate_plain

    ped, gain, mask = consts
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
    return errs


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


def phase_profile(torch, pt, pool, consts, params, device, n_batches=PROFILE_BATCHES):
    """The ResNet pipeline's timed batches under ``torch.profiler``."""
    step = make_step(torch, pt, consts, params)

    def run(on_batch):
        run_pipeline(torch, pt, pool, step, device, n_batches, lambda out, batch: on_batch())

    emit("profile", **profiled(torch, run, n_batches))


def phase_shm_end_to_end(torch, pt, pool, consts, model, params, device):
    """The ResNet serving path fed by another process: a ``spawn`` producer
    process writes the pool (drawn again there from the same seed) into a
    ``ShmRingBuffer``; this process attaches, drains it with
    ``get_batch_view`` -> ``push_view`` into pinned arenas, and runs the
    serving step. Held as ``end_to_end`` is, and to one host copy a frame."""
    import multiprocessing as mp

    import numpy as np

    from psana_ray_tpu_torch.records import FrameRecord, encoded_size

    total = WARMUP_BATCHES + E2E_BATCHES
    n_events = total * BATCH
    slot_bytes = 1 + encoded_size(FrameRecord(0, 0, pool[0], 0.0))
    slots = 1 << (BATCH + 8 - 1).bit_length()  # the ring rounds up to a power of two
    shm = check_shm_room(slots * (slot_bytes + 64))
    owner = pt.ShmRingBuffer.create(f"chip_smoke_{os.getpid()}", maxsize=BATCH + 8,
                                    slot_bytes=slot_bytes)
    ctx = mp.get_context("spawn")
    produced = ctx.Value("q", 0)
    proc = ctx.Process(target=pt.produce_synthetic, daemon=True,
                       args=(owner.name, DETECTOR, n_events, POOL_EVENTS),
                       kwargs=dict(seed=0, produced=produced))
    step = make_step(torch, pt, consts, params)
    last = {}

    def on_result(out, batch):
        last["out"], last["frames"], last["event_idx"] = out, batch.frames, batch.event_idx

    t_start = time.monotonic()
    proc.start()
    ring = None
    try:
        ring = pt.ShmRingBuffer.attach(owner.name)
        wait_full(ring, proc.is_alive)
        fill_s = time.monotonic() - t_start
        pt.reset_counters()
        pipe = pt.InfeedPipeline(ring, batch_size=BATCH, device=device,
                                 prefetch_depth=PREFETCH_DEPTH, batcher_buffers=BUFFERS,
                                 max_wait_s=60.0, metrics=pt.PipelineMetrics(warmup=WARMUP_BATCHES))
        t0 = time.monotonic()
        seen = pipe.run(step, on_result=on_result, block_until_ready=True)
        wall = time.monotonic() - t0
        counts = pt.counts()
        proc.join(timeout=60)
        ring_stats = ring.stats()
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=10)
        if ring is not None:
            ring.disconnect()
        owner.destroy()
    if proc.exitcode != 0 or produced.value != n_events or seen != n_events:
        raise AssertionError(f"producer exit {proc.exitcode}: produced {produced.value}, "
                             f"consumed {seen}, expected {n_events}")
    nb = WARMUP_BATCHES + pipe.metrics.batches.count
    if nb != total:
        raise AssertionError(f"{nb} batches, expected {total}")
    check_resnet_counts(counts, nb)
    staging = check_staging(pt, pipe.metrics, nb, pool[0].nbytes, pipe.batcher)
    if ring_stats["bytes_copied_out"] != 0:
        raise AssertionError(f"frames were copied out of the ring's slots: {ring_stats}")
    # the frames crossed the process boundary unchanged
    idx = last["event_idx"].cpu().numpy()
    want = torch.from_numpy(np.stack([pool[i % len(pool)] for i in idx])).to(device)
    if not torch.equal(want, last["frames"]):
        raise AssertionError("the last batch's frames differ from the producer's pool")
    errs = check_resnet_result(torch, pt, model, consts, last)
    summary = pipe.metrics.summary()
    emit("shm_end_to_end", batches=nb, timed_batches=summary["batches"], frames=summary["frames"],
         wall_s=wall, fill_s=fill_s, fps=summary["fps"],
         p50_batch_ms=summary["p50_ms"], p99_batch_ms=summary["p99_ms"],
         host_batch_ms=summary["host_batch_ms"], host_stage_ms=summary["host_stage_ms"],
         dev_shm_bytes=shm.total, dev_shm_free_bytes=shm.free, ring_slots=ring_stats["maxsize"],
         slot_bytes=slot_bytes, ring=ring_stats, launches=counts, **staging, **errs)
    return counts


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
    """An in-memory writer: keeps every appended peak set; ``on_batch``
    (if set) is called after each append, one a batch."""

    max_peaks = 128

    def __init__(self):
        self.sets = []
        self.on_batch = None

    def append(self, sets):
        self.sets.extend(sets)
        if self.on_batch is not None:
            self.on_batch()


def run_sfx(torch, pt, pool, pipe, n_batches, on_batch=None):
    """A producer thread fills a ``RingBuffer`` with ``WARMUP_BATCHES +
    n_batches`` batches of RAW events and one EOS; ``pipe.run`` drains
    them through pinned arenas, timing the last ``n_batches``. Returns the
    wall seconds of the whole run."""
    n_events = (WARMUP_BATCHES + n_batches) * SFX_BATCH
    ring = pt.RingBuffer(maxsize=3 * SFX_BATCH)
    thread, produced = start_producer(pt, ring, pool, n_events)
    pipe.metrics = pt.PipelineMetrics(warmup=WARMUP_BATCHES)
    pipe.writer.on_batch = on_batch
    before = pipe.n_events
    t0 = time.monotonic()
    try:
        written = pipe.run(ring)
    finally:
        wall = time.monotonic() - t0
        ring.close()
        thread.join(timeout=60)
        pipe.writer.on_batch = None
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
    pipe = pt.SfxPipeline(params, sink, calib=calib_np,
                          config=pt.SfxConfig(batch_size=SFX_BATCH))
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
    nb = WARMUP_BATCHES + pipe.metrics.batches.count
    want = {"calib_kernel": nb, **NO_RESNET, "conv_block_kernel": 8 * nb, "flash_kernel": 0,
            **NO_BWD}
    if pipe.metrics.batches.count != SFX_BATCHES or counts != want:
        raise AssertionError(f"launch counts {counts} over {nb} batches, expected {want}")
    staging = check_staging(pt, pipe.metrics, nb, pool[0].nbytes, pipe.batcher)
    peak_mem = torch.cuda.max_memory_allocated(device) / 2**30

    # the last batch again: kernel-path logits against the plain path, and
    # the peaks the pipeline wrote against find_peaks of those logits
    n_events = nb * SFX_BATCH
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
    emit("sfx_end_to_end", batches=nb, timed_batches=summary["batches"], frames=summary["frames"],
         wall_s=wall, fps=summary["fps"],
         p50_batch_ms=summary["p50_ms"], p99_batch_ms=summary["p99_ms"],
         host_batch_ms=summary["host_batch_ms"], host_stage_ms=summary["host_stage_ms"],
         peak_mem_gib=peak_mem, peaks_written=pipe.n_peaks, launches=counts, **staging,
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
    nb = WARMUP_BATCHES + pipe.metrics.batches.count
    want = {"calib_kernel": nb, **NO_RESNET, "conv_block_kernel": 0,
            "flash_kernel": VIT_DEPTH * nb, **NO_BWD}
    if counts != want:
        raise AssertionError(f"launch counts {counts} over {nb} batches, expected {want}")
    staging = check_staging(pt, pipe.metrics, nb, pool[0].nbytes, pipe.batcher)

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
    emit("vit_end_to_end", batches=nb, timed_batches=summary["batches"], frames=summary["frames"],
         wall_s=wall, fps=summary["fps"],
         p50_batch_ms=summary["p50_ms"], p99_batch_ms=summary["p99_ms"],
         host_batch_ms=summary["host_batch_ms"], host_stage_ms=summary["host_stage_ms"],
         peak_mem_gib=peak_mem, launches=counts, **staging, logits_rel_err=err,
         logits_max_abs=float(ref.abs().max()),
         logits_rel_err_flat_attention=rel_err(ref, ref_flat), tokens_per_frame=model.embed.pos_embed.shape[1])
    return model, counts


def phase_vit_profile(torch, pt, pool, consts, model, device, n_batches=PROFILE_BATCHES):
    """The ViT pipeline's timed batches under ``torch.profiler``."""
    step = make_vit_step(torch, pt, consts, model)

    def run(on_batch):
        run_pipeline(torch, pt, pool, step, device, n_batches, lambda out, batch: on_batch(),
                     batch=VIT_BATCH)

    emit("vit_profile", **profiled(torch, run, n_batches))


def phase_sfx_profile(torch, pt, pool, pipe, n_batches=PROFILE_BATCHES):
    """The SFX pipeline's timed batches under ``torch.profiler``."""
    emit("sfx_profile", **profiled(
        torch, lambda on_batch: run_sfx(torch, pt, pool, pipe, n_batches, on_batch), n_batches))


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


# -- phases 17 and 18 -------------------------------------------------------


def peak_recall_precision(pt, sets, src):
    """Recall and precision of written peak sets against the planted truth
    of ``src``'s events (raw coordinates: panels stacked vertically),
    as ``tests/test_torch_sfx.py`` scores them."""
    import numpy as np

    h = src.spec.height
    k = max(1, max(len(s.y) for s in sets))
    yx, n, truth = np.zeros((len(sets), k, 2), np.float32), np.zeros(len(sets), np.int64), []
    for i, s in enumerate(sets):
        yx[i, :len(s.y), 0], yx[i, :len(s.y), 1], n[i] = s.y, s.x, len(s.y)
        t = src.event_with_truth(s.event_idx, pt.RetrievalMode.RAW)[2].copy()
        t[:, 1] = t[:, 0] * h + t[:, 1]
        t[:, 0] = 0
        truth.append(t)
    return pt.peak_metrics(yx, n, truth, tolerance=3.0, min_amplitude=100.0)


def phase_peaknet_train(torch, pt, pool, calib_np, device, root):
    """Train -> fold -> serve for PeakNet-TPU on the card: ``train_peaknet``
    with ``norm="batch"`` for ``PEAKNET_STEPS`` steps on batches cycled over
    the RAW pool, then ``unet_to_flax`` -> ``fold_batchnorm`` ->
    ``save_params``/``load_params`` -> ``SfxPipeline`` over held-out RAW
    events with planted truth."""
    import numpy as np

    from psana_ray_tpu_torch.convert import flatten

    model = pt.unet_from_flax(pt.init_peaknet_tpu_params(SFX_FEATURES, seed=0, norm="batch"),
                              norm="batch", device=device)
    frames = torch.from_numpy(np.stack(pool)).to(device)
    n_batches = len(pool) // PEAKNET_BATCH
    batches = (frames[PEAKNET_BATCH * (s % n_batches):PEAKNET_BATCH * (s % n_batches + 1)]
               for s in range(PEAKNET_STEPS))
    stamps = []

    def on_step(n, loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    pt.reset_counters()
    t0 = time.perf_counter()
    model, losses = pt.train_peaknet(model, batches, *calib_np, PEAKNET_STEPS, device=device,
                                     on_step=on_step)
    train_counts = pt.counts()
    peak_mem = torch.cuda.max_memory_allocated(device) / 2**30
    del frames, batches
    want = {**dict.fromkeys(train_counts, 0), "calib_kernel": PEAKNET_STEPS}
    first20, last20 = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    if (train_counts != want or len(losses) != PEAKNET_STEPS or not np.all(np.isfinite(losses))
            or not last20 < first20):
        raise AssertionError(f"PeakNet training: counts {train_counts} (expected {want}), "
                             f"{len(losses)} losses, first 20 {first20}, last 20 {last20}")
    step_ms = np.diff(stamps) * 1e3  # steps 1..: step 0 also builds the optimizer's state

    # fold, and the serving tree through a parameter file
    t1 = time.perf_counter()
    variables = pt.unet_to_flax(model)
    serving = pt.fold_batchnorm(variables)
    fold_ms = (time.perf_counter() - t1) * 1e3
    path = os.path.join(root, "build", "chip_smoke", "peaknet_serving.npz")
    pt.save_params(path, serving)
    loaded = pt.load_params(path)
    a, b = flatten(serving), flatten(loaded)
    exact = a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)
    if not exact:
        raise AssertionError("the serving tree did not round-trip bit-exactly through its file")

    # serve held-out events with planted truth through the folded tree
    src = pt.SyntheticSource(run=PEAKNET_EVAL_RUN, num_events=PEAKNET_EVAL_EVENTS,
                             detector_name=DETECTOR, seed=0)
    events = list(src.iter_indexed_events(pt.RetrievalMode.RAW))
    sink = PeakSink()
    pipe = pt.SfxPipeline(loaded, sink, calib=calib_np, config=pt.SfxConfig(batch_size=SFX_BATCH),
                          device=device)
    held = torch.from_numpy(np.stack([e[1] for e in events[:SFX_BATCH]])).to(device)
    pipe.device_step(held)  # warm-up outside the counted run
    torch.cuda.synchronize()
    ring = pt.RingBuffer(maxsize=len(events) + 1)
    pt.produce(events, ring)
    pt.reset_counters()
    written = pipe.run(ring)
    serve_counts = pt.counts()
    nb = -(-len(events) // SFX_BATCH)
    want = {**dict.fromkeys(serve_counts, 0), "calib_kernel": nb, "conv_block_kernel": 8 * nb}
    if serve_counts != want or written != len(events):
        raise AssertionError(f"serving the trained tree: counts {serve_counts} (expected {want}), "
                             f"{written} of {len(events)} events written")
    physics = peak_recall_precision(pt, sink.sets, src)

    # the folded, fused served logits against the batch_eval model with the
    # same trained weights
    eval_model = pt.unet_from_flax(variables, norm="batch_eval", device=device)
    ped, gain, mask = (torch.from_numpy(x).to(device) for x in calib_np)
    with torch.no_grad():
        x = pt.panels_to_nhwc(pt.fused_calibrate(held, ped, gain, mask, threshold=10.0,
                                                 out_dtype=torch.bfloat16), mode="batch")
        fused = pt.peaknet_tpu_fused_infer(pipe.params, x)
        ref = eval_model(x)
    torch.cuda.synchronize()
    err = rel_err(ref, fused)
    if not (err < REL_TOL and torch.isfinite(fused).all() and float(ref.abs().max()) >= 1e-2):
        raise AssertionError(f"folded fused logits vs batch_eval: rel_err {err}")
    emit("peaknet_train", features=list(SFX_FEATURES), s2d=2, norm="batch", steps=PEAKNET_STEPS,
         batch=PEAKNET_BATCH, panel_rows_per_step=PEAKNET_BATCH * pool[0].shape[0],
         pool_events=len(pool), first_step_ms=(stamps[0] - t0) * 1e3,
         p50_step_ms=float(np.percentile(step_ms, 50)),
         p99_step_ms=float(np.percentile(step_ms, 99)), mean_step_ms=float(step_ms.mean()),
         frames_per_s=PEAKNET_BATCH / (float(step_ms.mean()) / 1e3), peak_mem_gib=peak_mem,
         loss_first=losses[0], loss_last=losses[-1], loss_first20=first20, loss_last20=last20,
         train_launches=train_counts, fold_ms=fold_ms, params_file_bytes=os.path.getsize(path),
         round_trip_exact=exact, eval_run=PEAKNET_EVAL_RUN, eval_events=len(events),
         serve_launches=serve_counts, peaks_written=pipe.n_peaks, recall=physics["recall"],
         precision=physics["precision"], n_truth=physics["n_truth"], n_pred=physics["n_pred"],
         fused_vs_batch_eval_rel_err=err, logits_max_abs=float(ref.abs().max()))
    served = {"params": path, "sets": sink.sets, "calib": calib_np}
    return {name: train_counts[name] + serve_counts[name] for name in train_counts}, model, served


def phase_peaknet_train_profile(torch, pt, model, pool, calib_np, device):
    """``PROFILE_STEPS`` more recipe steps of the trained PeakNet-TPU on one
    batch under ``torch.profiler`` (after its serving checks: these steps
    move its weights)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    step = pt.make_peaknet_step(model, *calib_np, device=device)
    batch = torch.from_numpy(np.stack(pool[:PEAKNET_BATCH])).to(device)
    step(batch)  # warm-up: the optimizer's state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(PROFILE_STEPS):
            step(batch)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    emit("peaknet_train_profile", **profile_summary(torch, prof, wall, PROFILE_STEPS))



def check_leg_staging(fan, det, floor, frame_nbytes) -> int:
    """A fan-in leg kept ``floor`` pinned arenas, copied every batch to the
    card straight from its arena and each frame once on the host; returns
    the leg's pinned bytes."""
    pool = fan.pipes[det].batcher.pool
    arenas = [t for a in pool for t in a.tensors]
    s = fan.metrics[det].summary()
    if (len(pool) != floor or not all(t.is_pinned() for t in arenas)
            or s["arena_copies"] != FANIN_BATCHES or s["host_frame_bytes_per_frame"] != frame_nbytes):
        raise AssertionError(f"{det}: {len(pool)} arenas (expected {floor}), staging {s}")
    return sum(t.numel() * t.element_size() for t in arenas)


def phase_fanin(torch, pt, device):
    """Config 5's device leg: two ``spawn`` producer processes stream
    epix10k2M and jungfrau4M RAW frames into their own shm rings; one
    ``FanInPipeline`` with pinned arenas at the fan-in floor runs K1 on each
    detector's batches, each with its own constants."""
    import multiprocessing as mp

    import numpy as np

    from psana_ray_tpu_torch.config import TransportConfig
    from psana_ray_tpu_torch.ops.fused_calib import fused_calibrate_plain
    from psana_ray_tpu_torch.records import FrameRecord, encoded_size
    from psana_ray_tpu_torch.transport.addressing import open_queue

    t_phase = time.monotonic()
    floor = 2 + FANIN_MERGE_DEPTH * len(FANIN_LEGS) + 4  # prefetch + merge + 4
    ctx = mp.get_context("spawn")
    owners, procs, produced, consts, slot_bytes = {}, {}, {}, {}, {}
    need = 0
    for det, _, slots, _ in FANIN_LEGS:
        spec = pt.DETECTORS[det]
        slot_bytes[det] = 1 + encoded_size(FrameRecord(0, 0, np.zeros(spec.frame_shape,
                                                                      np.float32), 0.0))
        need += slots * (slot_bytes[det] + 64)
    shm = check_shm_room(need)
    queues = {}
    try:
        for det, batch, slots, pool in FANIN_LEGS:
            owners[det] = pt.ShmRingBuffer.create(f"chip_smoke_fanin_{det}_{os.getpid()}",
                                                  maxsize=slots, slot_bytes=slot_bytes[det])
            produced[det] = ctx.Value("q", 0)
            procs[det] = ctx.Process(target=pt.produce_synthetic, daemon=True,
                                     args=(owners[det].name, det, FANIN_BATCHES * batch, pool),
                                     kwargs=dict(seed=0, produced=produced[det]))
            procs[det].start()
        for det, *_ in FANIN_LEGS:
            src = pt.SyntheticSource(num_events=1, detector_name=det, seed=0)
            consts[det] = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
                src.pedestal(), src.spec.adu_gain * src.gain_map(), src.create_bad_pixel_mask()))
            queues[det] = open_queue(TransportConfig(address=f"shm://{owners[det].name}"))
        for det, *_ in FANIN_LEGS:
            wait_full(queues[det], procs[det].is_alive)
        fill_s = time.monotonic() - t_phase
        stamps = {det: [] for det, *_ in FANIN_LEGS}
        order, last, snap = [], {}, {}

        def on_result(name, out, batch):
            stamps[name].append(time.monotonic())
            order.append(name)
            last[name] = (batch.frames, out)
            if len(stamps[name]) == FANIN_WARMUP:  # the staging thread's sums so far
                m = fan.metrics[name]
                snap[name] = (m.host_batch_s, m.host_stage_s, m.staged)

        steps = {det: (lambda batch, c=consts[det]: pt.fused_calibrate(batch.frames, *c,
                                                                        threshold=10.0))
                 for det, *_ in FANIN_LEGS}
        pt.reset_counters()
        t0 = time.monotonic()
        fan = pt.FanInPipeline([pt.DetectorStream(det, queues[det], batch_size=batch,
                                                  batcher_buffers=floor, max_wait_s=60.0)
                                for det, batch, *_ in FANIN_LEGS],
                               merge_depth=FANIN_MERGE_DEPTH)
        counts = fan.run(steps, on_result=on_result, block_until_ready=True)
        wall = time.monotonic() - t0
        launches = pt.counts()
        for det, *_ in FANIN_LEGS:
            procs[det].join(timeout=60)
    finally:
        for det, proc in procs.items():
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
        for q in queues.values():
            q.disconnect()
        for owner in owners.values():
            owner.destroy()

    want_counts = {det: FANIN_BATCHES * batch for det, batch, *_ in FANIN_LEGS}
    got_produced = {det: produced[det].value for det in produced}
    if (counts != want_counts or got_produced != want_counts
            or any(p.exitcode != 0 for p in procs.values())):
        raise AssertionError(f"fan-in counts {counts}, produced {got_produced}, producer exits "
                             f"{[p.exitcode for p in procs.values()]}, expected {want_counts}")
    want = {**dict.fromkeys(launches, 0), "calib_kernel": FANIN_BATCHES * len(FANIN_LEGS)}
    if launches != want:
        raise AssertionError(f"fan-in launches {launches}, expected {want}")
    legs, errs, pinned_bytes = {}, {}, 0
    for det, batch, *_ in FANIN_LEGS:
        frames, out = last[det]
        ref = fused_calibrate_plain(frames, *consts[det], threshold=10.0)
        err = (out - ref).abs()
        if not (torch.isfinite(out).all() and bool((err <= 1e-4 + 1e-5 * ref.abs()).all())):
            raise AssertionError(f"{det}: the last batch differs from fused_calibrate_plain by "
                                 f"{float(err.max())}")
        errs[det] = float(err.max())
        leg_pinned = check_leg_staging(fan, det, floor, frames[0].numel() * 4)
        pinned_bytes += leg_pinned
        m, s = fan.metrics[det], fan.metrics[det].summary()
        hb, hs, n0 = snap[det]
        legs[det] = {
            "batch": batch, "frame_shape": list(frames.shape[1:]), "batches": len(stamps[det]),
            "fps": batch * (len(stamps[det]) - FANIN_WARMUP)  # after the warm-up
                   / (stamps[det][-1] - stamps[det][FANIN_WARMUP - 1]),
            "host_batch_ms": 1e3 * (m.host_batch_s - hb) / max(m.staged - n0, 1),
            "host_stage_ms": 1e3 * (m.host_stage_s - hs) / max(m.staged - n0, 1),
            "p50_step_ms": s["p50_ms"], "p99_step_ms": s["p99_ms"],
            "pinned_bytes": leg_pinned,
            "max_abs_err": errs[det],
        }
    # interleaved: each leg delivered a batch before the other's last one
    firsts = {d: order.index(d) for d in legs}
    lasts = {d: len(order) - 1 - order[::-1].index(d) for d in legs}
    if any(firsts[a] > lasts[b] for a in legs for b in legs if a != b):
        raise AssertionError(f"the legs were not interleaved: {''.join(d[0] for d in order)}")
    # aggregate: every leg's batches after its warm-up, over the time from
    # the first leg's warm-up end to the last batch; and over the window in
    # which both legs are past their warm-up and still running (None if
    # one leg ended before the other's warm-up did)
    steady = {d: stamps[d][FANIN_WARMUP - 1] for d in legs}
    t0, t1 = min(steady.values()), max(st[-1] for st in stamps.values())
    frames_after = sum(legs[d]["batch"] * (len(stamps[d]) - FANIN_WARMUP) for d in legs)
    w0, w1 = max(steady.values()), min(st[-1] for st in stamps.values())
    both = sum(legs[d]["batch"] * sum(w0 < t <= w1 for t in stamps[d]) for d in legs)
    emit("fanin", legs=legs, merge_depth=FANIN_MERGE_DEPTH, batcher_buffers=floor,
         pinned_bytes=pinned_bytes, aggregate_fps=frames_after / (t1 - t0),
         both_legs_fps=both / (w1 - w0) if w1 > w0 else None, both_legs_window_s=w1 - w0,
         wall_s=wall, fill_s=fill_s, seconds=time.monotonic() - t_phase, frames=counts,
         launches=launches,
         order="".join(d[0] for d in order),
         switches=sum(a != b for a, b in zip(order, order[1:])),
         dev_shm_free_bytes=shm.free)
    return launches


def phase_sfx_cli(torch, pt, device, root, served):
    """The operator CLI over ``shm://``, fed by a ``spawn`` producer: first
    the held-out events that ``peaknet_train`` served in-process, through
    the parameter file it wrote, whose peak sets must equal its; then a
    longer stream cut by ``--max_events``."""
    import multiprocessing as mp
    import tempfile

    import numpy as np

    from psana_ray_tpu_torch import sfx
    from psana_ray_tpu_torch.records import FrameRecord, encoded_size

    spec = pt.DETECTORS[DETECTOR]
    slot_bytes = 1 + encoded_size(FrameRecord(0, 0, np.zeros(spec.frame_shape, np.float32), 0.0))
    ctx = mp.get_context("spawn")
    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)

    def start(tag, n_events):
        """A fresh ring and a producer process that fills it."""
        owner = pt.ShmRingBuffer.create(f"chip_smoke_cli_{tag}_{os.getpid()}", maxsize=32,
                                        slot_bytes=slot_bytes)
        proc = ctx.Process(target=pt.produce_synthetic, daemon=True,
                           args=(owner.name, DETECTOR, n_events, PEAKNET_EVAL_EVENTS),
                           kwargs=dict(seed=0, run=PEAKNET_EVAL_RUN))
        proc.start()
        return owner, proc

    def serve(tmp, tag, owner, proc, extra, metrics):
        """One CLI run over ``owner``'s ring; returns the peak sets, the
        launches, the cursor's resume point and the wall seconds of the
        run. Stops the producer and destroys the ring."""
        cursor = os.path.join(tmp, f"{tag}.cursor")
        sink = PeakSink()
        try:
            wait_full(owner, proc.is_alive)
            args = sfx.parse_args([
                "--address", f"shm://{owner.name}", "--serving_params", served["params"],
                "--output", os.path.join(tmp, f"{tag}.cxi"), "--mode", "quality",
                "--calib_npz", calib, "--cursor_path", cursor, "--batch", str(SFX_BATCH),
                "--log_level", "WARNING", *extra])
            pt.reset_counters()
            t0 = time.monotonic()
            rc = sfx.run(args, writer=sink, metrics=metrics)
            wall = time.monotonic() - t0
            launches = pt.counts()
        finally:
            proc.terminate()  # a bounded run leaves it waiting on a full ring
            proc.join(timeout=10)
            owner.destroy()
        if rc != 0:
            raise AssertionError(f"the CLI's {tag} run exited {rc}")
        return sink.sets, launches, pt.StreamCursor.load(cursor).resume_point(0), wall

    t_phase = time.monotonic()
    bound = (CLI_BATCHES - 1) * SFX_BATCH
    # both producers start now: the second fills its ring during the first run
    rings = {"held_out": start("held_out", PEAKNET_EVAL_EVENTS),
             "bounded": start("bounded", (CLI_BATCHES + 4) * SFX_BATCH)}
    try:
        with tempfile.TemporaryDirectory(dir=work) as tmp:
            calib = os.path.join(tmp, "calib.npz")
            ped, gain, mask = served["calib"]
            np.savez(calib, pedestal=ped, gain=gain, mask=mask)
            # the held-out events of peaknet_train, through its parameter file
            held = serve(tmp, "held_out", *rings.pop("held_out"), [], None)
            # a longer stream, cut by --max_events: the batch in flight is drained
            metrics = pt.PipelineMetrics(warmup=WARMUP_BATCHES)
            bounded = serve(tmp, "bounded", *rings.pop("bounded"),
                            ["--max_events", str(bound)], metrics)
    finally:
        for owner, proc in rings.values():  # a run that failed before its serve
            proc.terminate()
            proc.join(timeout=10)
            owner.destroy()
    seconds = time.monotonic() - t_phase

    sets, launches, resume, _ = held
    nb = PEAKNET_EVAL_EVENTS // SFX_BATCH
    want = {**dict.fromkeys(launches, 0), "calib_kernel": nb,
            "conv_block_kernel": UNET_LAUNCHES * nb}
    ref = served["sets"]
    same = len(sets) == len(ref) and all(
        (a.event_idx, a.shard_rank, a.photon_energy) == (b.event_idx, b.shard_rank,
                                                         b.photon_energy)
        and np.array_equal(a.y, b.y) and np.array_equal(a.x, b.x)
        and np.array_equal(a.intensity, b.intensity) for a, b in zip(sets, ref))
    if launches != want or not same or resume != PEAKNET_EVAL_EVENTS:
        raise AssertionError(f"CLI on the held-out events: launches {launches} (expected "
                             f"{want}), peak sets equal to peaknet_train's: {same}, "
                             f"cursor resumes at {resume}")
    held = {"events": len(sets), "peaks": int(sum(s.n for s in sets)), "launches": launches,
            "peak_sets_equal_peaknet_train": same, "cursor_resume_point": resume}

    sets, launches, resume, wall = bounded
    written = len(sets)
    want = {**dict.fromkeys(launches, 0), "calib_kernel": CLI_BATCHES,
            "conv_block_kernel": UNET_LAUNCHES * CLI_BATCHES}
    if (not bound <= written <= bound + 2 * SFX_BATCH - 1 or written != CLI_BATCHES * SFX_BATCH
            or [s.event_idx for s in sets] != list(range(written)) or resume != written
            or launches != want):
        raise AssertionError(f"bounded CLI run: {written} events for --max_events {bound}, "
                             f"cursor resumes at {resume}, launches {launches} (expected {want})")
    m = metrics.summary()
    emit("sfx_cli", held_out=held, max_events=bound, events_written=written,
         cursor_resume_point=resume, launches=launches, wall_s=wall, seconds=seconds,
         timed_batches=m["batches"], fps=m["fps"], p50_batch_ms=m["p50_ms"],
         p99_batch_ms=m["p99_ms"], host_batch_ms=m["host_batch_ms"],
         host_stage_ms=m["host_stage_ms"], arena_h2d_copies=m["arena_copies"])
    return {name: held["launches"][name] + launches[name] for name in launches}


def phase_resnet_fold(torch, pt, pool, consts, device):
    """Config-4 ResNet-50 trained with ``norm="batch"`` for ``FOLD_STEPS``
    steps (``masked_softmax_xent``, full batches of ``FOLD_BATCH``), then
    ``resnet_to_flax`` -> ``fold_batchnorm`` -> ``resnet_from_flax`` ->
    ``pack_fused`` -> ``resnet_fused_infer`` on a batch of ``BATCH``
    frames calibrated by K1, against the ``norm="batch_eval"`` model."""
    import numpy as np

    ped, gain, mask = consts
    model = pt.resnet_from_flax(pt.init_resnet_params(in_channels=pool[0].shape[0], seed=0,
                                                      norm="batch"), norm="batch", device=device)
    step = pt.make_train_step(model, pt.adamw(model.parameters(), lambda n: FOLD_LR),
                              lambda logits, aux: pt.masked_softmax_xent(logits, *aux))
    labels = torch.arange(FOLD_BATCH, device=device) % 2
    valid = torch.ones(FOLD_BATCH, dtype=torch.uint8, device=device)

    def calibrated(first, n):
        raw = torch.from_numpy(np.stack(pool[first:first + n])).to(device)
        return pt.panels_to_nhwc(pt.fused_calibrate(raw, ped, gain, mask, threshold=10.0,
                                                    out_dtype=torch.bfloat16))

    torch.cuda.synchronize()
    pt.reset_counters()
    losses, stamps = [], [time.perf_counter()]
    for s in range(FOLD_STEPS):
        losses.append(float(step(calibrated(s * FOLD_BATCH, FOLD_BATCH), (labels, valid))))
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    train_counts = pt.counts()
    want = {**dict.fromkeys(train_counts, 0), "calib_kernel": FOLD_STEPS}
    if train_counts != want or not np.all(np.isfinite(losses)):
        raise AssertionError(f"ResNet training: counts {train_counts} (expected {want}), "
                             f"losses {losses}")

    t1 = time.perf_counter()
    variables = pt.resnet_to_flax(model)
    serving = pt.fold_batchnorm(variables)
    fold_ms = (time.perf_counter() - t1) * 1e3
    frozen = pt.resnet_from_flax(serving, device=device)
    params = pt.pack_fused(frozen)
    eval_model = pt.resnet_from_flax(variables, norm="batch_eval", device=device)
    with torch.no_grad():
        pt.resnet_fused_infer(params, calibrated(0, BATCH))  # warm-up outside the counted run
        torch.cuda.synchronize()
        pt.reset_counters()
        x = calibrated(0, BATCH)
        logits, feat = pt.resnet_fused_infer(params, x, return_features=True)
        serve_counts = pt.counts()
        ref_logits, ref_feat = eval_model(x, return_features=True)
    torch.cuda.synchronize()
    want = {**dict.fromkeys(serve_counts, 0), "calib_kernel": 1, "conv1x1_kernel": 16,
            "conv3x3_kernel": 16, "back_kernel": 16}
    errs = {"logits_rel_err": rel_err(ref_logits, logits),
            "features_rel_err": rel_err(ref_feat, feat),
            "features_max_abs": float(ref_feat.abs().max())}
    if (serve_counts != want or not (errs["logits_rel_err"] < REL_TOL
                                     and errs["features_rel_err"] < REL_TOL)
            or errs["features_max_abs"] < 1e-2 or not torch.isfinite(logits).all()):
        raise AssertionError(f"folded ResNet-50: counts {serve_counts} (expected {want}); {errs}")
    emit("resnet_fold", width=64, stage_sizes=[3, 4, 6, 3], norm="batch", steps=FOLD_STEPS,
         batch=FOLD_BATCH, step_ms=[float(d) for d in np.diff(stamps) * 1e3], losses=losses,
         train_launches=train_counts, fold_ms=fold_ms, serve_batch=BATCH,
         serve_launches=serve_counts, **errs)
    return {name: train_counts[name] + serve_counts[name] for name in train_counts}


# -- phases 6c, 6d and 17e: the producer and consumer programs ---------------


def cli_cmd(module, *args):
    """``python -X importtime -m <module> <args>``: the command a user runs,
    with the interpreter listing every module it imports on stderr."""
    return [sys.executable, "-X", "importtime", "-m", module, *args]


def run_clis(root, cmds, timeout=300.0, lead_s=0.0):
    """Start the commands from the checkout's root, the first one ``lead_s``
    seconds after the others, and wait for all; returns ``[(exit code,
    output), ...]`` in the commands' order and the wall seconds from the
    first command's start. Output goes to files, so no process blocks on a
    pipe."""
    import tempfile

    env = {**os.environ, "PYTHONPATH": root}
    files = [tempfile.TemporaryFile("w+") for _ in cmds]

    def start(i):
        return subprocess.Popen(cmds[i], cwd=root, env=env, stdout=files[i],
                                stderr=subprocess.STDOUT, text=True)

    procs = [None] + [start(i) for i in range(1, len(cmds))]
    try:
        time.sleep(lead_s)
        t0 = time.monotonic()
        procs[0] = start(0)
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    wall = time.monotonic() - t0
    out = []
    for code, f in zip(codes, files):
        f.seek(0)
        out.append((code, f.read()))
        f.close()
    return out, wall


def imported_roots(text):
    """The top-level packages a ``-X importtime`` process imported."""
    return {line.rsplit("|", 1)[1].strip().split(".")[0] for line in text.splitlines()
            if line.startswith("import time:") and line.count("|") == 2}


def destroy_ring(pt, name):
    """Destroy the shm ring ``name`` if it exists (the CLIs leave theirs)."""
    try:
        pt.ShmRingBuffer.attach(name, retries=0, interval_s=0.01).destroy()
    except TimeoutError:
        pass


def check_shm_room(nbytes):
    """``/dev/shm``'s usage, once it is known to have ``nbytes`` free."""
    import shutil

    shm = shutil.disk_usage("/dev/shm")
    if shm.free < nbytes:
        raise AssertionError(f"/dev/shm has {shm.free} bytes free, the rings need {nbytes}")
    return shm


def write_replay(path, frames, energies):
    """An uncompressed ``.npz`` replay file: ``ReplaySource`` maps its
    frames in place."""
    import numpy as np

    np.savez(path, frames=frames, photon_energy=np.asarray(energies, np.float64))


_END = r"consumer (\d+): end of stream after (\d+) frames \(frames=(\d+) \(([\d.]+)/s, ([\d.]+) Gbit/s\)"
_PRODUCED = r"producer done: frames=(\d+) \(([\d.]+)/s, ([\d.]+) Gbit/s\)"


def passthrough(pt, root, npz, n_consumers, producer_args=(), consumer_args=()):
    """BASELINE config 1 through the two CLIs over a fresh ``shm://`` ring
    of ``CFG1_SLOTS`` default slots: ``n_consumers`` consumers start and
    wait on it, as long-running consumers do, and ``CONSUMER_LEAD_S``
    later the producer replays ``npz`` (two shards) into it. Checks every
    exit code, each consumer's end-of-stream line, the frame count and
    that no process imported torch or JAX (unless ``consumer_args`` ask
    for a trace); returns the rates the status lines give, the ring's
    counters and the wall seconds from the producer's start."""
    import re

    name = f"chip_smoke_cfg1_{os.getpid()}_{time.monotonic_ns() % 10**6}"
    addr = ["--address", f"shm://{name}"]
    cmds = [cli_cmd("psana_ray_tpu_torch.producer", "--exp", f"replay:{npz}", "--num_shards", "2",
                    "--num_consumers", str(n_consumers), "--queue_size", str(CFG1_SLOTS), *addr,
                    *producer_args)]
    cmds += [cli_cmd("psana_ray_tpu_torch.consumer", str(c), "--quiet", "--status_interval", "1",
                     *addr, *consumer_args) for c in range(n_consumers)]
    ring = pt.ShmRingBuffer.create(name, maxsize=CFG1_SLOTS)
    try:
        out, wall = run_clis(root, cmds, lead_s=CONSUMER_LEAD_S)
        ring_stats = ring.stats()
    finally:
        ring.destroy()
    tails = [text[-3000:] for _, text in out]
    if [code for code, _ in out] != [0] * len(out):
        raise AssertionError(f"config 1 exit codes {[c for c, _ in out]}: {tails}")
    ends = [re.search(_END, text) for _, text in out[1:]]
    produced = re.search(_PRODUCED, out[0][1])
    if None in ends or produced is None:
        raise AssertionError(f"config 1: no end-of-stream or producer line: {tails}")
    counts = [int(m.group(2)) for m in ends]
    if sum(counts) != CFG1_EVENTS or int(produced.group(1)) != CFG1_EVENTS:
        raise AssertionError(f"config 1: consumers ended after {counts} frames, the producer "
                             f"sent {produced.group(1)}, expected {CFG1_EVENTS} in all")
    loaded = [sorted(imported_roots(text) & {"torch", "jax", "psana_ray_tpu"})
              for _, text in out]
    tracing = "--profile_dir" in consumer_args
    if any(loaded[:1]) or (not tracing and any(loaded)):
        raise AssertionError(f"config 1 processes imported {loaded}")
    # a consumer's status line rates its frames from its first to its last:
    # (n - 1) / span. The consumers read one stream at once, so the
    # aggregate is every frame over the longest span
    rates = [float(m.group(4)) for m in ends]
    spans = [(n - 1) / r for n, r in zip(counts, rates) if n > 1 and r > 0]
    fps = CFG1_EVENTS / max(spans)
    bytes_per_frame = sum(float(m.group(5)) * 1e9 / 8 for m in ends) / sum(rates)
    return {"frames_per_consumer": counts, "frames_per_s": fps,
            "gbytes_per_s": fps * bytes_per_frame / 1e9, "bytes_per_frame": bytes_per_frame,
            "consumer_frames_per_s": rates, "consumer_span_s": spans,
            "producer_frames_per_s": float(produced.group(2)),
            "producer_gbytes_per_s": float(produced.group(3)) / 8,
            "ring": {k: ring_stats[k] for k in ("puts", "gets", "puts_rejected")},
            "wall_s": wall, "imported": loaded, "outputs": out}


def producer_breakdown(pt, npz, frame_shape, n=CFG1_SLOTS):
    """Where a config-1 frame's host time goes, one thread, ``n`` frames:
    copying it out of the mapped replay file, putting it into a fresh shm
    ring (its slots' pages touched the first time) and into the same ring
    again, and the consumer's owned get (a copy out of the slot). Mean ms
    a frame."""
    import numpy as np

    src = pt.ReplaySource(npz)
    buf = np.ones(frame_shape, np.float32)
    t0 = time.perf_counter()
    recs = []
    for idx, data, energy in src.iter_indexed_events():
        if idx == n:
            break
        np.copyto(buf, data)
        recs.append(pt.FrameRecord(0, idx, data, energy))
    read_ms = (time.perf_counter() - t0) * 1e3 / n
    ring = pt.ShmRingBuffer.create(f"chip_smoke_breakdown_{os.getpid()}", maxsize=n)
    try:
        out = {"replay_read_ms": read_ms}
        for tag in ("cold", "warm"):
            t0 = time.perf_counter()
            for r in recs:
                if not ring.put(r):
                    raise AssertionError("the breakdown's ring is full")
            out[f"slot_put_ms_{tag}"] = (time.perf_counter() - t0) * 1e3 / n
            t0 = time.perf_counter()
            got = [ring.get() for _ in recs]
            out[f"slot_get_ms_{tag}"] = (time.perf_counter() - t0) * 1e3 / n
            if [g.event_idx for g in got] != list(range(n)):
                raise AssertionError("the breakdown's ring lost frames")
            del got
    finally:
        ring.destroy()
    return out


def phase_passthrough_cli(pt, src, pool, root):
    """BASELINE config 1, producer -> queue -> consumer no-op: the
    ``psana_ray_tpu_torch.producer`` CLI replays 128 epix10k2M f32 RAW
    events from an uncompressed ``.npz`` (two shards) into a 32-slot shm
    ring, and two ``psana_ray_tpu_torch.consumer`` CLIs read it to the end;
    then again with ``--wire_dtype uint16``. Returns the replay file's
    path (``stage_trace`` reads it once more)."""
    import numpy as np

    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.monotonic()
    with ThreadPoolExecutor(8) as ex:  # numpy's generators release the GIL
        events = list(ex.map(lambda i: src.event(i, pt.RetrievalMode.RAW), range(CFG1_EVENTS)))
    if not all(np.array_equal(pool[i], events[i][0]) for i in range(len(pool))):
        raise AssertionError("the replay file's events differ from the source's pool")
    frames = np.stack([e[0] for e in events])
    npz = os.path.join(work, f"cfg1_{os.getpid()}.npz")
    write_replay(npz, frames, [e[1] for e in events])
    del events
    write_s = time.monotonic() - t0
    frame_bytes = frames[0].nbytes
    del frames
    shm = check_shm_room(CFG1_SLOTS * pt.ShmRingBuffer.DEFAULT_SLOT_BYTES)
    runs = {}
    for tag, extra in (("float32", ()), ("uint16", ("--wire_dtype", "uint16"))):
        r = passthrough(pt, root, npz, 2, producer_args=extra)
        r.pop("outputs")
        r["frame_bytes"] = frame_bytes if tag == "float32" else frame_bytes // 2
        runs[tag] = r
    emit("passthrough_cli", events=CFG1_EVENTS, consumers=2, shards=2, ring_slots=CFG1_SLOTS,
         replay_bytes=os.path.getsize(npz), replay_write_s=write_s,
         dev_shm_free_bytes=shm.free, **runs,
         host_ms_per_frame=producer_breakdown(pt, npz, pool[0].shape))
    return npz


def phase_stage_trace(torch, pt, pool, consts, params, device, root, npz):
    """The config-4 ResNet pipeline for ``TRACE_BATCHES`` batches without
    and with ``utils.trace.trace``: the exported Chrome trace must hold one
    ``stage.device_put`` and one ``stage.dispatch`` range a batch and the
    device events of K1 (``calib_*_kernel``), K2 (``conv_sm90_kernel<N,
    0>``, 32 a batch) and K3 (``conv_sm90_kernel<N, 2|3>``, 16 a batch).
    Then ``passthrough_cli``'s consumer 0 with ``--profile_dir``."""
    import glob
    import re
    import shutil

    from psana_ray_tpu_torch.utils.trace import trace

    step = make_step(torch, pt, consts, params)
    logdir = os.path.join(root, "build", "chip_smoke", "trace")
    shutil.rmtree(logdir, ignore_errors=True)

    def run():
        n = TRACE_BATCHES * BATCH
        ring = pt.RingBuffer(maxsize=n + 1)
        pt.produce(((i, pool[i % len(pool)], 10.0) for i in range(n)), ring)
        pipe = pt.InfeedPipeline(ring, batch_size=BATCH, device=device,
                                 prefetch_depth=PREFETCH_DEPTH, batcher_buffers=BUFFERS)
        t0 = time.monotonic()
        seen = pipe.run(step, block_until_ready=True)
        wall = time.monotonic() - t0
        if seen != n:
            raise AssertionError(f"stage_trace: {seen} of {n} frames")
        return pipe.metrics.summary(), wall

    torch.cuda.synchronize()
    pt.reset_counters()
    plain, plain_wall = run()
    with trace(logdir) as path:
        traced, traced_wall = run()
    counts = pt.counts()
    check_resnet_counts(counts, 2 * TRACE_BATCHES)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    modes = [int(m.group(1)) for k in kernels if (m := re.search(r"conv_sm90_kernel<\d+, (\d)>", k))]
    found = {
        "stage.device_put": ranges.count("stage.device_put"),
        "stage.dispatch": ranges.count("stage.dispatch"),
        "K1": sum("calib_cluster_kernel" in k or "calib_two_pass_kernel" in k for k in kernels),
        "K2": modes.count(0), "K3": modes.count(2) + modes.count(3),
    }
    want = {"stage.device_put": TRACE_BATCHES, "stage.dispatch": TRACE_BATCHES,
            "K1": TRACE_BATCHES, "K2": 32 * TRACE_BATCHES, "K3": 16 * TRACE_BATCHES}
    if found != want:
        raise AssertionError(f"trace {path}: found {found}, expected {want}")
    names = sorted({m.group(0) for k in kernels
                    if (m := re.search(r"(calib_\w+kernel<[^>]*>|conv_sm90_kernel<[^>]*>)", k))})

    cli_dir = os.path.join(root, "build", "chip_smoke", "trace_cli")
    shutil.rmtree(cli_dir, ignore_errors=True)
    cli = passthrough(pt, root, npz, 1, consumer_args=("--profile_dir", cli_dir))
    cli_traces = glob.glob(os.path.join(cli_dir, "*", "*.pt.trace.json"))
    if len(cli_traces) != 1:
        raise AssertionError(f"the consumer CLI's --profile_dir wrote {cli_traces}")
    emit("stage_trace", batches=TRACE_BATCHES, trace_bytes=os.path.getsize(path), found=found,
         kernel_names=names, p50_batch_ms=plain["p50_ms"], p50_batch_ms_traced=traced["p50_ms"],
         wall_s=plain_wall, wall_s_traced=traced_wall, launches=counts,
         cli_trace_bytes=os.path.getsize(cli_traces[0]), cli_consumer_imported=cli["imported"][1],
         cli_frames_per_s=cli["frames_per_s"])
    return counts


def phase_producer_cli_sfx(pt, root, served):
    """Config 3 through the two programs a user runs: the producer CLI
    replays ``peaknet_train``'s 16 held-out RAW events over ``shm://`` into
    the SFX CLI (in-process: the card's machine has no h5py), whose peak
    sets must equal ``peaknet_train``'s bit for bit, with exactly one
    ``calib_kernel`` and ``UNET_LAUNCHES`` ``conv_block_kernel`` a batch."""
    import tempfile

    import numpy as np

    from psana_ray_tpu_torch import sfx

    src = pt.SyntheticSource(run=PEAKNET_EVAL_RUN, num_events=PEAKNET_EVAL_EVENTS,
                             detector_name=DETECTOR, seed=0)
    events = list(src.iter_indexed_events(pt.RetrievalMode.RAW))
    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    check_shm_room(CFG1_SLOTS * pt.ShmRingBuffer.DEFAULT_SLOT_BYTES)
    name = f"chip_smoke_cli_sfx_{os.getpid()}"
    sink = PeakSink()
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        npz, calib = os.path.join(tmp, "held_out.npz"), os.path.join(tmp, "calib.npz")
        write_replay(npz, np.stack([e[1] for e in events]), [e[2] for e in events])
        ped, gain, mask = served["calib"]
        np.savez(calib, pedestal=ped, gain=gain, mask=mask)
        log = open(os.path.join(tmp, "producer.log"), "w+")
        t0 = time.monotonic()
        producer = subprocess.Popen(
            [sys.executable, "-m", "psana_ray_tpu_torch.producer", "--exp", f"replay:{npz}",
             "--address", f"shm://{name}", "--queue_size", str(CFG1_SLOTS)],
            cwd=root, env={**os.environ, "PYTHONPATH": root}, stdout=log,
            stderr=subprocess.STDOUT, text=True)
        try:
            args = sfx.parse_args([
                "--address", f"shm://{name}", "--serving_params", served["params"],
                "--output", os.path.join(tmp, "x.cxi"), "--mode", "quality", "--calib_npz", calib,
                "--batch", str(SFX_BATCH), "--log_level", "WARNING"])
            pt.reset_counters()
            rc = sfx.run(args, writer=sink)
            launches = pt.counts()
            wall = time.monotonic() - t0
            produced = producer.wait(timeout=120)
        finally:
            if producer.poll() is None:
                producer.kill()
                producer.wait(timeout=30)
            destroy_ring(pt, name)
            log.seek(0)
            tail = log.read()[-3000:]
            log.close()
    nb = PEAKNET_EVAL_EVENTS // SFX_BATCH
    want = {**dict.fromkeys(launches, 0), "calib_kernel": nb,
            "conv_block_kernel": UNET_LAUNCHES * nb}
    ref = served["sets"]
    same = len(sink.sets) == len(ref) and all(
        (a.event_idx, a.shard_rank, a.photon_energy) == (b.event_idx, b.shard_rank,
                                                         b.photon_energy)
        and np.array_equal(a.y, b.y) and np.array_equal(a.x, b.x)
        and np.array_equal(a.intensity, b.intensity) for a, b in zip(sink.sets, ref))
    if rc != 0 or produced != 0 or launches != want or not same:
        raise AssertionError(f"producer CLI -> SFX CLI: exit codes {produced}, {rc}; launches "
                             f"{launches} (expected {want}); peak sets equal to "
                             f"peaknet_train's: {same}; producer: {tail}")
    emit("producer_cli_sfx", events=len(sink.sets), peaks=int(sum(s.n for s in sink.sets)),
         peak_sets_equal_peaknet_train=same, launches=launches, wall_s=wall)
    return launches


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
    # K1: both routes' kernels, every raw/output/load instantiation
    k1 = [{k: r.get(k) for k in ("function", "registers", "spill_stores", "spill_loads",
                                 "static_smem")} for r in info["ptxas"] if r["lib"] == "calib"]
    emit("build_calib", kernels=k1)
    if not k1 or any(r["spill_stores"] + r["spill_loads"] for r in k1):
        raise AssertionError(f"calib.cu did not build clean (spills or no kernels): {k1}")

    t0 = time.monotonic()
    src = pt.SyntheticSource(num_events=POOL_EVENTS, detector_name=DETECTOR, seed=0)
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
    shm_counts = phase_shm_end_to_end(torch, pt, pool, consts, model, params, device)
    npz = phase_passthrough_cli(pt, src, pool, root)
    try:
        trace_counts = phase_stage_trace(torch, pt, pool, consts, params, device, root, npz)
    finally:
        os.remove(npz)
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
    peaknet_counts, peaknet, served = phase_peaknet_train(torch, pt, pool, calib_np, device,
                                                          root)
    phase_peaknet_train_profile(torch, pt, peaknet, pool, calib_np, device)
    del peaknet
    fanin_counts = phase_fanin(torch, pt, device)
    cli_counts = phase_sfx_cli(torch, pt, device, root, served)
    cli_sfx_counts = phase_producer_cli_sfx(pt, root, served)
    fold_counts = phase_resnet_fold(torch, pt, pool, consts, device)

    csrc = "psana_ray_tpu_torch/csrc"
    c = calib["bf16"]
    kernels = [{
        "name": "calib_kernel", "route": "cuda", "source": f"{csrc}/calib.cu",
        "replaces": "psana_ray_tpu/ops/pallas_calib.py:60",
        "launches": (counts["calib_kernel"] + shm_counts["calib_kernel"]
                     + sfx_counts["calib_kernel"] + vit_counts["calib_kernel"]
                     + train_counts["calib_kernel"] + peaknet_counts["calib_kernel"]
                     + fanin_counts["calib_kernel"] + cli_counts["calib_kernel"]
                     + fold_counts["calib_kernel"] + trace_counts["calib_kernel"]
                     + cli_sfx_counts["calib_kernel"]),
        "max_abs_err": max(case["max_abs_err"] for case in calib.values()),
        "ms": c["ms"], "ms_cold": c["ms_cold"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
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
            "replaces": replaces[name],
            "launches": counts[name] + shm_counts[name] + fold_counts[name] + trace_counts[name],
            "max_abs_err": agg["max_abs_err"], "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"], "bound_by": agg["bound_by"],
            "library_ms": agg["library_ms"],
        })
    kernels.append({
        "name": "conv_block_kernel", "route": "cuda", "source": f"{csrc}/conv_sm90.cu",
        "replaces": "psana_ray_tpu/models/pallas_unet.py:55",
        "launches": (sfx_counts["conv_block_kernel"] + peaknet_counts["conv_block_kernel"]
                     + cli_counts["conv_block_kernel"] + cli_sfx_counts["conv_block_kernel"]),
        "max_abs_err": conv_block["max_abs_err"],
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
