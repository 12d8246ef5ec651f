#!/usr/bin/env python3
"""Drive the port's three serving paths and its training paths on one
NVIDIA H100: the calibrated ResNet-50 classifier (also fed by a producer
process through the shared-memory ring), the SFX Bragg-peak pipeline
(PeakNet-TPU U-Net), the ViT hit classifier with the flash-attention
trunk, the ViT's training recipe with the flash backward kernels, the
f32 ViT, a ViT of head dim 256 and an f16 ViT served and trained through
the f32, wide and f16 flash kernels, a ViT of head dim 64 served and
trained through the reference's XLA route,
train -> fold -> serve: PeakNet-TPU and ResNet-50 trained with BatchNorm,
folded into frozen affines and served through the kernels, the
two-detector fan-in (BASELINE config 5), the SFX operator CLI over
``shm://``, BASELINE config 1 through the producer and consumer CLIs,
the stage ranges on the profiler's timeline, and the producer CLI
feeding the SFX CLI; across the TCP transport, through the queue
server program: the ResNet path, config 1 and the producer CLI feeding
the SFX CLI; from durable queues on a two-worker server: the ResNet
path, once clean and once through a worker killed mid-stream, and
config 1 into a server killed and restarted, then replayed; and through
the sharded queue cluster of two queue servers: the ResNet path, once
clean and once through a consumer-group member joining and a server
killed mid-stream, and config 1 to a consumer group of two; config
4 traced frame by frame across the producer CLI, the queue server CLI
and this process, then stalled, and with every one of those processes
profiled and the profiles merged; config 4 behind the serving gateway
(overloaded by three tenants, then idle over TCP); config 3 with
every process under autotune; and the multi-device layer on a one-rank
NCCL group: the five legs of ``dryrun_multichip``, config 4 through
``make_infer_step``, config 4 through the multi-host
``GlobalStreamConsumer`` (with two detectors through
``MultiDetectorGlobalConsumer``, and beside a stalled leg), the
full-width ViT through Ulysses, ring-flash, the GPipe pipeline and the
switch MoE, and a ViT training step with and without ``remat``.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and imports nothing of JAX. Phases, each printing
one JSON line (``{"phase": ...}``):

1. ``device``: the card's name and count, and ``nvidia-smi``'s name and
   power limit (also printed alone on a line of their own).
1b. ``lint``: the port's static analysis, before the kernel build, in
   child processes started with ``-X importtime`` from the checkout's
   root. ``python -m psana_ray_tpu_torch.lint --json`` must exit 0 with
   ``clean`` true, all 17 rules run, no ``allowlist-rot`` and every
   ``.py`` file of the package plus this script scanned; ``python -m
   psana_ray_tpu_torch.lint --model --json`` must exit 0 with its five
   protocol models exhausted, no counterexample and no drift. Neither
   child may import torch or JAX. Prints the files, findings, the full
   run's seconds (its own ``duration_s`` and the child's wall time) and
   the models' states. (``--changed`` needs git history, which a
   ``git archive`` checkout lacks, so it is not run here.)
2. ``build``: compiles ``psana_ray_tpu_torch/csrc/*.cu`` with ``nvcc``
   (one process per source, all at once) and reports the seconds and each
   kernel's registers and spills from ``-Xptxas -v``, and for each kernel
   whether ``ptxas`` advised that its ``wgmma.mma_async`` instructions
   are serialized or that its ``setmaxnreg`` was ignored. A
   ``build_sm90`` line sums that up for the ``wgmma`` kernels of
   ``conv_sm90.cu``, ``flash.cu``, ``flash_bwd.cu``, ``flash_wide.cu`` and
   ``flash_bwd_wide.cu`` and of the last four's f16 builds
   (``lib<name>_f16.so``, ``-DSM90_F16``); a spill, a serialization or an
   ignored ``setmaxnreg`` there fails the run, and so does a launch
   register count other than 168 in those that move registers with
   ``setmaxnreg`` (``conv_sm90.cu``, ``flash.cu`` in both builds). A ``build_f32`` line gives
   ``flash_f32.cu``'s kernels' registers and spills and counts, in their
   machine code (``cuobjdump -sass``), the TF32 tensor-core instructions
   (``HMMA…TF32``, ``HGMMA…TF32``) by opcode: a spill, or a kernel
   without them, fails the run.
3. ``calib_kernel``: K1 against its plain version on ``[32, 16, 352, 384]``
   f32 RAW frames from ``SyntheticSource`` with f32, bf16 and f16 output,
   the same frames as uint16 ADUs with bf16 output, and ``[8, 8, 512,
   1024]`` jungfrau4M frames drawn on the card from a seeded generator
   with bf16 output (f32: rtol 1e-5, atol 1e-4; bf16 and f16: that plus
   one ulp of the type; two launches on one input bit-identical). Each case gives the plan it ran
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
6d. ``passthrough_tcp``: config 1 over ``tcp://``: the queue server CLI
   (``--queue_size 32``), the producer CLI replaying the same ``.npz`` in
   two shards, two consumer CLIs with ``--stream`` started 1.5 s before
   it; plain, then with ``--wire_codec shuffle-rle`` on the producer and
   both consumers. Every process runs with ``-X importtime`` and none of
   the four may import torch or JAX; the frame counts must be exact.
   The consumers run at ``--log_level DEBUG`` and log their connection's
   codec (none, then ``shuffle-rle``) and the CRC-32 of every frame they
   received: each event must arrive once, and the CRC-32 of the frames'
   CRCs in event order must equal the file's, in both runs. Then the
   codec alone in this process on the file's 128 frames, each encoded as
   a sending connection does and decoded as a receiving one does, and
   held against the file. Prints each run's frames/s and GB/s (the
   consumers hash every frame), the codec's wire bytes over raw bytes and
   its ms a frame each way.
6e. ``tcp_end_to_end``: phase 6b's serving path fed across the TCP
   transport: ``python -m psana_ray_tpu_torch.queue_server --queue_size
   40`` as a process on 127.0.0.1 (``--port 0 --port_file``), a ``spawn``
   producer process (``produce_synthetic`` with a ``tcp://`` target, the
   pool drawn again from the same seed) sending with windowed puts
   (``put_pipelined``), and this process subscribed to the server's push
   stream (``stream_open(32)``), ``InfeedPipeline`` draining it with
   ``get_batch_stream`` -> ``push_view`` into the pinned arenas, 6 + 24
   batches once the queue is full. Held as ``shm_end_to_end`` is (every
   event, launches exact, one host copy a frame, the last batch's frames
   equal to the pool's and its logits and features within ``rel_err <
   0.05`` of the plain path). Prints frames/s, the relay's GB/s,
   ``host_batch_ms``, ``host_stage_ms`` and the server's queue stats
   (the 'T' RPC: depth, high-water mark, puts, gets, rejected puts).
6f. ``stage_trace``: the ResNet pipeline of phase 5 for 4 batches
   without, then with ``utils.trace.trace``: the exported Chrome trace
   must hold 4 ``stage.device_put`` and 4 ``stage.dispatch`` ranges and
   the device events of K1 (``calib_*_kernel``), K2 (``conv_sm90_kernel<N,
   0>``, 128) and K3 (``conv_sm90_kernel<N, 2|3>``, 64), under the names
   the profiler gives them, and every kernel launch and copy of the
   capture must have its record on the device; launches exact. It runs
   after the TCP phases and is the process's first capture (phase 19).
   Then phase 6c's consumer 0 alone with ``--profile_dir``, whose trace
   file must exist. Prints the process's age, the trace's size and the
   p50 batch ms without and with the capture.
6g. ``tcp_profile``: phase 6e's path again for 6 + 8 batches, the 8
   under ``torch.profiler`` as in phase 6: the card's idle share there.
6h. ``durable_end_to_end`` (after 6e, before 6f): phase 6e's path fed
   from ``python -m psana_ray_tpu_torch.queue_server --workers 2
   --durable_dir <fresh directory under build/chip_smoke/> --queue_size
   40`` with the JAX defaults of the segment flags (64 MiB segments, 8
   retained, fsync ``batch`` of 64); the directory's file system must
   have room for 50 segments. The producer's named queue is one that
   worker 1 owns by ``queue_owner`` (printed), so a connection the
   kernel hands worker 0 migrates; 16 more connections after the run
   make that all but certain, and the phase fails unless one migrated.
   Held as 6e is, and every event exactly once.
   Prints frames/s, relay GB/s beside 6e's, ``host_batch_ms``,
   ``host_stage_ms``, the owning worker's log counters (appended bytes,
   fsyncs, segments rolled and recycled, spilled records) and bytes sent
   by ``sendfile`` (from its stop line), the migrations, the directory's
   peak size, and, timed alone in this process, the CRC-32 of a frame's
   payload and a whole segment append under fsync ``none`` and ``batch``.
6i. ``durable_failover``: the same server shape and model, 2 + 8
   batches; after the third batch is consumed, ``SIGKILL`` of worker 1
   (its pid from its start line) with the producer and this process's
   stream mid-stream. The supervisor must fork worker 1 again, both
   clients reconnect on their own, every event arrive at least once with
   at most a put window plus a stream window (64) of duplicates, K1–K3
   launch once a batch served, and the last batch agree within
   ``rel_err < 0.05``. Prints the respawn's seconds, what the new
   worker's log re-exposed and in how many ms, whether it cut a torn
   tail, and the duplicates.
6j. ``passthrough_durable``: config 1 over ``tcp://`` into a durable
   server (``--workers 1``, ``--retain_segments 24``): the producer CLI
   replays 6c's ``.npz`` in two shards with no consumer attached, the
   server is killed (``SIGKILL``) and started again on the same
   directory, two consumer CLIs with ``--stream`` drain it, and a third
   with ``--replay from=begin --replay_group audit`` reads the retained
   range; both reads' CRC-32s must equal the file's, every event once,
   and no process may import torch or JAX. Prints the recovery's ms and
   records, the producer's, the drain's and the replay's frames/s.
6k. ``cluster_end_to_end``: phase 6e's serving path fed through
   ``cluster://``: two ``python -m psana_ray_tpu_torch.queue_server
   --workers 1 --queue_size 16`` processes (the first, started first, the
   groups' coordinator), a queue name whose 4 partitions split 2 + 2
   over the servers (the map printed), a ``spawn`` producer process putting through
   ``cluster://A,B`` with windowed puts and ``retain`` 80 a partition (the
   partition's queue, the put window and the stream window: the zero-loss
   bound), and this process the single member ``m0`` of group ``serve``
   (``open_queue`` with the config's ``group``), streamed
   (``stream_open(32)``), 6 + 24 batches once the partitions are full.
   Every event exactly once, one EOS, launches exact, one host copy a
   frame, the last batch's frames the pool's and its logits and features
   within ``rel_err < 0.05``. Prints frames/s, ``host_batch_ms`` and
   ``host_stage_ms`` beside ``tcp_end_to_end``'s, each server's relayed
   frames (its stop line), the consumer's and the producer's ``CLUSTER``
   counters, and the largest resident set the producer process sampled
   (retained records held) beside the pool's bytes: a retained record
   holds the pool's array.
6l. ``cluster_failover``: the same shape, 2 + 10 batches, the producer
   at 60 Hz (under the consumer's rate, so it is still sending at the
   kill), the queue name one that splits 2 + 2 and whose second server
   hosts a partition of ``m0``'s share after the join. After batch 2 a consumer CLI process joins group
   ``serve`` (``--cluster A,B --partitions 4 --group serve --stream``, no
   torch); after batch 5 the second server (not the coordinator) is
   killed with ``SIGKILL``. The generation must rise at the join, the
   members hold disjoint partitions covering the four, the dead server's
   partitions land on the first (map version 2) with no client process
   restarted, every event arrive at least once across the members (the
   CLI's frames with the pool's CRC-32) with at most ``retain`` plus both
   windows of duplicates for each moved partition, each member end on one
   EOS, K1–K3 launch once a batch served and the last batch agree within
   ``rel_err < 0.05``. Prints the failover's detection (the kill to this
   process's map change) and latency (the kill to the first frame it
   reads from a moved partition's new owner), both from its ``CLUSTER``
   counters and required, the duplicates and the producer's
   ``retained_resent``/``tail_resent``.
6m. ``passthrough_cluster``: config 1 through the three CLIs over
   ``cluster://``: two durable queue servers (``--workers 1
   --durable_dir``), the producer CLI replaying 6c's ``.npz`` in two shards
   with ``--cluster A,B --partitions 4`` on a queue name that splits 2 +
   2, and two consumer CLIs of group ``audit`` (``--stream --log_level
   DEBUG``) started 3 s before it. Each frame's CRC-32 arrives once
   across the consumers, equal to the file's;
   each consumer exits 0 on one EOS; the coordinator's ``groups.json``
   holds the group at generation 2 or more with every partition drained;
   no process imports torch or JAX. Prints frames/s and the members'
   partitions and frames.
6n. ``replicated_end_to_end``: two durable queue servers (``--workers 1
   --durable_dir``) on ports chosen before they start, each with
   ``--replicate_peers A,B --advertise <its own>``, a queue name that
   splits 2 + 2; then the same pair without ``--replicate_peers``. In
   each turn this process puts 6 batches and an EOS with windowed puts
   and ends (timed: the put rate, each answer held until the follower
   logged the frame when replicated; and each server's CPU over the puts,
   in cores), then serves them as the one member of group ``serve``:
   every event once, one EOS, launches exact, one host copy a frame, the
   last batch within ``rel_err < 0.05``; the replicated servers may not
   degrade. Prints both turns' put rates, served frames/s and their
   ratios, ``host_batch_ms``, the records and bytes shipped (the
   servers' ``replication counters`` lines) and each log directory's peak
   bytes.
6o. ``replicated_failover``: a replicated pair whose partitions hold the
   whole stream (10 batches): a ``spawn`` producer process puts every
   frame and its EOS and exits; then this process serves as member
   ``m0`` (stream window 8), and after its first batch the second server
   (not the coordinator) is killed with ``SIGKILL``. Each moved
   partition's 'Y' must answer a range, every event arrive with its
   frame equal to the pool's on the card, the duplicates stay within the
   put and stream windows plus ``FLOOR_COMMIT_STRIDE`` a moved partition,
   one EOS, K1–K3 once a batch, the last batch within ``rel_err < 0.05``.
   Prints the promotions' ms, the failover's detection and latency and
   the duplicates.
6p. ``observed_end_to_end``: the observability plane on config 4 (batch
   32, ResNet-50 at width 64, K1–K3): the producer CLI replays 192 of the
   pool's RAW frames from an ``.npz`` through a queue server CLI
   (``--queue_size 40``) to ``InfeedPipeline`` here (stream window 32),
   in three turns: untraced, ``--trace_sample 100`` and ``--trace_sample
   1``, where all three processes get ``--trace_dir`` and
   ``--flight_dir``, the server ``--metrics_port`` and
   ``--history_interval 0.5``, and this process ``configure_from_args``
   and ``exchange_anchors``. Every turn: every frame served, K1–K3 once a
   batch, the last batch within ``rel_err < 0.05`` of the plain path and
   its logits within 1e-6 of the untraced turn's; at sample 1 every one
   of the 192 frames holds ``produce``, ``enqueue``, ``queue_dwell``,
   ``relay``, ``dequeue``, ``batch``, ``device_put`` and ``dispatch`` in
   the merged trace, their starts in that order within 100 us; a
   ``/metrics`` scrape parses as Prometheus text and gives the queue's
   puts and gets of the 'T' stats; the 'N' ``{"op": "metrics"}`` answer
   has ``ok``, ``host``, ``pid`` and ``metrics``. Then a stall: a server
   with ``--stall_poll_s 0.2 --stall_full_s 1 --flight_dir``, and this
   process stops reading (8 credits) after 32 frames for at least 3 s
   while the producer still puts: the server must log ``backpressure``
   and dump with reason ``stall`` (the event, a metrics snapshot, a
   history tail, the stacks), and a ``SIGUSR2`` to the producer must
   dump with reason ``signal``. Prints frames/s a turn, the serving
   process's stage histograms, the stages' p50/p99 from the merged trace
   and what no span covers, spool bytes a process, the merged spans, each
   process's skew against the server, the scrape's ms and bytes, and the
   dumps' delays.
6q. ``profiled_end_to_end``: the continuous profiler on the same path, in
   four turns of 192 frames: ``--profile_hz 0`` everywhere; the default
   97 Hz in all three processes (a sampler here too); with
   ``--profile_dir`` and ``--trace_dir --trace_sample 1`` in all three;
   and the default through a ``--workers 1 --durable_dir`` server. In
   every turn a ``ClusterCollector`` polls the server over 'N' and the
   producer's ``/federate`` (``--metrics_port``) every 0.25 s. Every
   turn: every frame served, K1–K3 once a batch, the last batch within
   ``rel_err < 0.05`` of the plain path and within 1e-6 of the first
   turn's logits; with the profiler on, the collector's store of the
   server holds ``prof.cpu_frac`` and ``evloop.busy_frac``, and in the
   memory-queue turns at least 0.8 of the server's on-CPU samples bill to
   a known stage. Turn 2: a second producer CLI, held by backpressure,
   and ``python -m psana_ray_tpu_torch.obs.top --once`` (a child process)
   must show it and the server ``up``, the server with CPU% and BUSY%;
   then a ``SIGUSR2`` to the server must dump a ``profile_top`` with hot
   frames. Turn 3: each process's spool loads with both of the port's
   ``load_spool`` s and has samples, and ``prof_merge`` over the spools
   and the trace spools holds the three processes and all 192 frames.
   Prints frames/s a turn; for each process and turn its on-CPU ms a
   frame by stage, cpu_frac, CPU ns a frame and five hottest frames; the
   server's ``evloop`` numbers; this process's threads without a procfs
   entry and its ``dispatch`` samples whose leaf is a synchronise; spool
   bytes, each spool's sampled on-CPU seconds beside its ``os.times``
   CPU seconds; the merged document's rows, spans and bytes; the
   console's frame and the dump's delay.
6r. ``gateway_end_to_end``: config 4 behind the serving gateway
   (``psana_ray_tpu_torch.serving``). The device time of each operating
   point, 1, 2, 4, 8, 16 and 32 frames (the H2D copy from pinned memory,
   K1, the ResNet; CUDA events), seeds ``SloPolicy``; six B32 dispatches
   through ``make_batch_dispatch`` (two pinned arenas a batch size, an
   arena refilled only after its copy's event) give the capacity, host
   copies included, and the SLO is 8 times one of them. (a) Overload: three shard
   threads put the pool's frames, cycled, into an in-process ring in
   bursts every 0.2 s at twice the capacity for 5 s; ``serve_queue``
   admits them as tenants t0, t1, t2 (by ``shard_rank``, weights 2:1:1)
   with a ``StallDetector`` bound, while an autotune registry holding the
   drain knobs, the gateway noted, ticks every 0.1 s. (b) Idle: the
   producer CLI replays 24 frames into the queue server CLI, and
   ``serve_queue`` drains a tenanted client with one stream credit. Gates:
   offered == completed + shed with no backlog, every admitted frame
   completed or shed at dequeue (the device saw every completed one),
   every shed counted on a path, K1–K3 once a dispatch, each point's last
   batch within ``rel_err < 0.05`` of the plain path, (b) every frame at
   B1 with 1.00 host copies a frame, and ``drain_chunk`` never actuated.
   Prints each point's device ms, the capacity, the pinned bytes, the
   admitted p99 a tenant against the SLO, the goodput shares against
   the weights, goodput against capacity, dispatches by size, the
   degraded episodes and the registry's actuations.
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
   each case needs. Then the other variants of K5 (``VARIANT_CASES``):
   ``flash_wide_kernel`` (bf16), ``flash_f32_kernel`` and the f16 builds
   of ``flash_kernel`` and ``flash_wide_kernel`` at every head dim of 128
   to 1024 (B 2, H 4, S 1024; bf16 at 128 is ``flash_kernel`` again), a
   causal case and an uneven one (Sq 256, Sk 768) at head dim 256 in bf16
   and f32, the serving shapes of ``vit_f32`` (f32, B 2, H 4, D 128, S
   8448), ``vit_wide`` (bf16, B 2, H 2, D 256) and ``vit_f16`` (f16, B 2,
   H 4, D 128), and 65536 + 128 batch x heads at S 128, D 128 in bf16 and
   f32 (two launches a call: CUDA's gridDim.y holds 65535), each held
   the same way (f16 at the bf16 tolerances) (f32 at the JAX package's f32 tolerances: ``o`` 2e-5,
   ``lse`` 1e-4, each 1e-4 of its scale), both controls rejected; in f32
   a third control must fail too: the same attention with its two
   products as one TF32 pass each (the plain version under
   ``allow_tf32``, a yardstick the port never runs), which the kernels'
   three-product split must beat. Each row names its Hopper kernel and
   the SDPA backend its library time used; the bound counts the
   function's work at its dtype's peak (989 TFLOP/s bf16; f32-accurate
   products on the TF32 tensor cores at 495 / 3 TFLOP/s, with the old
   67 TFLOP/s CUDA-core bound beside it), not a recompute of the scores.
   Every case also launches the kernel a second time, which must give the
   same ``o`` and ``lse`` bit for bit, and once more from its counting
   build (``build.counting``: each ``wgmma`` adds its 2 M N K operations
   to a device counter), which gives ``issued_over_work``: the tensor-core
   operations the kernel issued over the function's, at most 1.05 in every
   case without the causal mask (each score tile formed once, at every
   head dim); None for the f32 pair, whose ``mma.sync`` has no counter.
   Then the XLA route (``flash_xla_route`` lines): the shapes the
   reference's ``_kernel_shapes_ok`` refuses, head dim 64 at
   ``vit_heads8``'s attention shape (B 2, H 8, S 8448, bf16) and S 2112
   (B 2, H 4, D 128), through ``attention_with_stats``: no kernel launch,
   one route call, the plain version's ``o`` and ``lse`` bit for bit; the
   route's time beside SDPA's and the bound.
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
   dq within one bf16 ulp of its largest value (2**-8 of the reference's;
   dq's f32 sums across key tiles arrive in another order each run), and
   two more launches of the kernel alone f32 dq sums (dq_acc) within
   2**-16 of their largest value. Times: the pair as the
   backward launches it (dq_acc zeroed, the kernel, the dq rounding;
   ``ms`` and ``ms_cold``), the kernel alone and the rounding alone, the
   plain version's (one call for dq, dk and dv), the library's (the
   backward of ``F.scaled_dot_product_attention`` from a saved forward,
   one call for the three), and the bound of the five products the
   function needs, with that of the seven of a two-kernel design beside
   it. Then ``flash_bwd_wide_kernel`` (bf16, then ``flash_bwd_dq_convert``)
   and ``flash_bwd_f32_kernel`` (f32, dq summed straight in f32: no
   rounding launch) in the cases of ``VARIANT_CASES``, each with an lse
   cotangent, held the same way (f32: ``<= 1e-4`` of each gradient's
   scale, and the one-TF32-pass plain backward rejected; the repeat's dq
   within 2**-16 of its largest value; the wide kernel's repeat held by
   its dq_acc alone, whose sums arrive in twice as many reductions), and
   each with its counted ``issued_over_work`` (at most 1.05 without the
   causal mask); the f16 builds (``flash_bwd_dq_convert`` rounding to
   f16) at the bf16 tolerances; 65536 + 128 batch x heads without the SDPA
   yardstick. Then the XLA route's backward (``flash_bwd_xla_route``) in
   the same two cases with an lse cotangent: no kernel, one route call a
   direction, the plain backward's dq, dk and dv bit for bit.
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
15b. ``vit_f32``, 15c. ``vit_wide``, 15d. ``vit_f16`` and 15e.
   ``vit_heads8``: the full-width ViT (patch 16, embed 512, depth 4, 8448
   tokens) in f32 with 4 heads of 128, in bf16 with 2 heads of 256, in
   f16 with 4 heads of 128, and in bf16 with 8 heads of 64, a head dim
   the reference's gate refuses (the XLA route: no K5-K7 launch, 4 route
   calls a batch and 4 + 4 a step, its logits against the same weights
   in f32, ``rel_err < 0.05``, and its train step against the plain
   attention). Each is served through the infeed as in 11
   (batch 2, 6 warm-up and 8 timed batches; ``vit_serve_step``
   calibrates to the model's dtype): +1 ``calib_kernel`` and +4
   ``flash_kernel`` a batch, all of them its variant (``flash_f32_kernel``,
   ``flash_wide_kernel`` or the f16 ``flash_kernel``), the last batch's
   logits against the plain path (``rel_err < 1e-4`` in f32, ``< 0.05`` in
   bf16 and f16). Then one train
   step's parity from the same init against the plain attention (f32: the
   loss and the whole gradient within 1e-4; bf16: as 14), and 12 steps of
   the recipe's loss and AdamW at batch 2 on 16 labelled events
   calibrated to the model's dtype: +4 ``flash_kernel`` and +4
   ``flash_bwd_kernel`` a step (their variants), +4
   ``flash_bwd_dq_convert`` in bf16 and f16 and none in f32, the losses
   finite.
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
17f. ``producer_cli_sfx_tcp``: the same over ``tcp://``: producer CLI
   (``--wire_codec shuffle-rle``) -> queue server CLI -> SFX CLI, whose
   connection negotiates no codec, so the server hands it plain frames.
   The same checks.
17g. ``tuned_end_to_end``: config 3 under autotune in every process. The
   producer CLI replays 384 frames (the pool cycled, a 3.3 GB ``.npz``)
   into a ``--workers 1 --durable_dir`` queue server CLI, which the SFX
   CLI (in-process) serves with ``peaknet_train``'s tree through K1 and
   K4, in three turns, every process with ``--autotune_interval 0.25
   --history_interval 0.1``: ``--autotune on`` (the producer with
   ``--wire_codec none``, which pins its codec knob), ``observe`` and
   ``off``. Every turn writes each frame once, with K1 and K4's launches
   exact and peak sets equal to turn ``off``'s; in ``on`` each process's
   ``autotune`` source (the server's over 'N', the producer's over
   ``/federate``, the SFX's in its registry) shows a resolved probe and
   the pinned knob never moved; in ``observe`` no knob moved. Then config
   1: the producer CLI (320 frames) into a durable server and one consumer
   CLI with ``--stream --autotune on`` at DEBUG: its ``stream_window``
   must have moved live, with every frame's CRC-32 equal to the file's.
   Prints frames/s a turn, each process's knobs and decisions.
18. ``resnet_fold``: config 4's ResNet-50 (width 64, (3, 4, 6, 3)) with
   ``norm="batch"`` trained 3 steps (``masked_softmax_xent``, full
   batches of 8, +1 ``calib_kernel`` a step), then ``resnet_to_flax`` ->
   ``fold_batchnorm`` -> ``resnet_from_flax`` -> ``pack_fused`` ->
   ``resnet_fused_infer`` on 32 frames calibrated by K1 (+1
   ``calib_kernel``, +16 ``conv1x1_kernel``, +16 ``conv3x3_kernel``, +16
   ``back_kernel``, exactly), logits and pooled features against the
   ``norm="batch_eval"`` model (``rel_err < 0.05``).
19. ``profiler_loss``: a defect of ``torch.profiler`` on the card's
   machine, measured and not gated: late in a process that has captured
   before, a capture loses the device records (not the runtime calls) of
   its first milliseconds of device work, more the longer since the
   first capture (``tools/profiler_capture_probe.py``). A capture of 30
   synchronised copies of distinct sizes, one every 2 ms; prints which
   have no device record.
20. ``multichip`` (before 19; phases 20-22 run on a one-rank NCCL group
   that this process starts from a ``TCPStore`` on a free localhost port
   and destroys after them): the five legs of ``dryrun_multichip(1)`` on
   that group (DP x TP ResNet-18 training, config 4 serving over
   ``data``, the Ulysses-flash ViT trained and served, the pipelined ViT,
   the MoE ViT on an ``expert`` axis; the ViT legs in f32, the
   reference's dtype, at the flash kernels' shapes: heads of 128, 256
   and 1,152 tokens), each checked against its single-device result (the
   ViT legs at the reference's f32 tolerances); K1-K3 and K5-K7 must
   launch, every attention launch of the legs ``flash_f32_kernel`` and
   ``flash_bwd_f32_kernel``. Then config 4
   through ``make_infer_step`` on a one-wide ``data`` axis at batch 32:
   launches +1 ``calib_kernel`` and +16 of each of K2's two and K3's, the
   logits equal to the ``end_to_end`` step's on the same frames. Prints the
   ``COLLECTIVES`` counts (by op and backend: ``nccl``, or ``self`` for a
   ``ppermute`` to one's own rank, a local copy).
20b. ``multihost`` (on the same group, after ``multichip``): config 4
   through ``GlobalStreamConsumer`` on a ``("data",)`` mesh of 1 at local
   batch 32: a producer thread puts ``3 * 32 + 5`` RAW frames of the pool
   and an EOS into a ``RingBuffer``; 4 rounds, 101 frames, each round's
   real rows of logits (a DTensor sharded on ``data``) equal to the
   ``end_to_end`` step's on the same frames, launches +1 ``calib_kernel``
   and +16 of each of K2's two and K3's a round. Then epix10k2M (the same
   ResNet step, 40 frames) and jungfrau4M (K1 alone at batch 8, 20
   frames, its last round within K1's f32 tolerance of the plain version)
   through ``MultiDetectorGlobalConsumer``: the rounds in the fixed order,
   each leg's count exact, launches exact; then the same two beside a
   silent third leg (``stall_timeout_s=0.5``): the healthy legs finish and
   ``StreamStalled`` is raised after the loop (the phase expects that
   exception and no other). Prints the frames and rounds, p50 and p90 of
   the round time, the host time of one global valid count (its
   ``all_reduce`` and read-back, apart), a round's parts measured apart
   (the batcher's copies of 32 frames into a fresh pageable arena, the
   synchronous copy of that batch to the card, the step's p50), the
   ``COLLECTIVES`` counts and the launches.
21. ``vit_parallel``: the full-width ViT (8,448 tokens, embed 512, 4 heads
   of 128, depth 4, bf16) at batch 2 on calibrated frames, through
   ``ulysses_attention(impl="flash")`` and ``ring_flash_attention`` on a
   ``("data", "seq")`` (1, 1) mesh, ``vit_pipelined_apply`` (2
   microbatches) on ``("data", "pipe")`` (1, 1), and ``moe_experts=4``
   (grouped dispatch, G = ``pick_group_size(8448, 512)``), each against its
   plain-attention forward (``rel_err < 0.05``), ``flash_kernel`` launched
   depth x calls (x 2 microbatches for the pipeline) and nothing else;
   p50 batch ms and peak GiB of 8 timed calls after 2. Then the gradient
   of ``sum(logits**2)`` through ``ring_flash_attention`` (K5's lse enters
   the hop combine, so K6/K7 run with an lse cotangent, one launch a
   layer) against K5's forward with ``attention_bwd_plain`` behind it (the
   same activations: the bf16 max-pool head makes gradients from another
   forward tie-sensitive), leaf by leaf (``rel_err < 0.05``).
22. ``remat``: one ViT training step at batch 4 (SGD at learning rate 0,
   so each step sees the same weights) with ``remat=False`` and
   ``remat=True``: step ms and peak GiB of each, the launches (remat runs
   K5 twice a layer), the gradients' largest relative difference
   (``< 0.05``); then K6/K7 (``launch_flash_bwd``) against
   ``attention_bwd_plain`` at the step's shape (``BWD_TOL``).

Phase 6f's capture is the process's first, so the profiling phases (6,
6g and the other ``*_profile`` phases) run after it.

Then a ``{"kernels": [...]}`` line and, last, the device line. Any failure
raises and exits non-zero before the device line is printed. The
``calib_kernel`` launches in the kernels line are those of the three
serving runs, the shm-fed, TCP-fed, durable-fed, cluster-fed and
replicated runs, the traced and profiled runs, the gateway's, the
training runs, the fan-in, the CLIs, the tuned runs, the fold runs and
the multi-device runs (phases 5, 6b, 6e, 6f, 6h, 6i, 6k, 6l, 6n, 6o, 6p,
6q, 6r, 8, 11, 14, 17, 17c, 17d, 17e, 17f, 17g, 18, 20 and 20b), those of
``conv1x1_kernel``, ``conv3x3_kernel`` and ``back_kernel`` the ResNet
runs' (5, 6b, 6e, 6f, 6h, 6i, 6k, 6l, 6n, 6o, 6p, 6q, 6r, 18, 20 and 20b),
those of ``conv_block_kernel`` the SFX runs' (8, 17, 17d, 17e, 17f and
17g, and 15b-15e), the ``flash_kernel`` launches those of the bf16
head-dim-128 ViT's serving and training runs (11, 14, 21 and 22),
``flash_bwd_kernel``'s those of its training runs (14 and 22), the
``flash_f32_kernel`` and ``flash_bwd_f32_kernel`` ones those of 15b and
of the dry run's f32 legs (20), ``flash_wide_kernel`` and
``flash_bwd_wide_kernel`` those of 15c, ``flash_kernel_f16`` and
``flash_bwd_kernel_f16`` (the f16 builds) those of 15d, each from the
tally by variant (``pt.variant_counts()``). Each run sets the counts to 0 just before it
and reads them just after.

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
is 4 launches of the pair (kernel and dq rounding) at the training shape;
for the wide, f32 and f16 kernels the same at their ViT's shape, batch 2
(``plain_ms`` is the plain version's one call for dq, dk and dv;
``library_ms``, the SDPA backward's one call for the three, is given
once, with K6). ``bound_ms`` is
the larger of bytes / 3.35 TB/s and operations / peak (989 TFLOP/s bf16
tensor cores; 67 TFLOP/s f32 for the calibration arithmetic; for the f32
attention kernels, whose f32-accurate products are three TF32 ones on
the tensor cores, 3 x operations / 495 TFLOP/s), counting each input
byte read once and each output byte written once.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
# f32 on the CUDA cores: K1's arithmetic, and the f32 attention rows' old bound
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
# an f32-accurate product on the TF32 tensor cores: three TF32 products
# (the f32 attention kernels' split)
F32_SPLIT_OPS_PER_S = TF32_OPS_PER_S / 3
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
# f32: the JAX package's f32 tolerances (tests/test_ring_attention.py:235, :316)
FLASH_TOL_F32 = {"o": 2e-5, "lse": 1e-4, "o_rel": 1e-4, "lse_rel": 1e-4}
BWD_TOL = 1e-2  # max|g - g_ref| / max|g_ref| for each of dq, dk, dv
BWD_TOL_F32 = 1e-4
# the most tensor-core work a kernel may issue over the function's, without
# the causal mask: every score tile formed once, whatever the head dim
ISSUED_TOL = 1.05
F32_REL_TOL = 1e-4  # the f32 ViT's logits against the plain path
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
# the other variants of K5-K7: (case, dtype, head dim, B, H, Sq, Sk, causal) for
# the forward, and the same with an lse cotangent for the backward. Every
# (dtype, head dim) the TPU kernels take at BH 8 and S 1024 (f16: the bf16
# kernels' f16 builds), a causal and an uneven case at head dim 256 in bf16
# and f32, the serving shapes of the f32 ViT (4 heads of 128), the wide ViT (2
# heads of 256) and the f16 ViT (4 heads of 128), batch 2, and 65536 + 128
# batch x heads (two launches of each kernel: gridDim.y holds 65535)
HEAD_DIMS = tuple(range(128, 1025, 128))
VARIANT_CASES = tuple(
    [("grid", dt, d, 2, 4, 1024, 1024, False) for dt in ("bf16", "f32", "f16") for d in HEAD_DIMS]
    + [(c, dt, 256, 2, 4, sq, sk, causal) for dt in ("bf16", "f32")
       for c, sq, sk, causal in (("causal", 1024, 1024, True), ("uneven", 256, 768, False))]
    + [("serving", "f32", 128, VIT_BATCH, 4, 8448, 8448, False),
       ("serving", "bf16", 256, VIT_BATCH, 2, 8448, 8448, False),
       ("serving", "f16", 128, VIT_BATCH, 4, 8448, 8448, False)]
    + [("bh_65664", dt, 128, 4, 16416, 128, 128, False) for dt in ("bf16", "f32")])
# shapes the reference's gate (_kernel_shapes_ok) sends to its XLA formulation:
# (case, dtype, head dim, B, H, Sq, Sk, causal); the first is vit_heads8's attention
XLA_CASES = (("xla_d64", "bf16", 64, VIT_BATCH, 8, 8448, 8448, False),
             ("xla_s2112", "bf16", 128, 2, 4, 2112, 2112, False))
VARIANT_ITERS = 5  # timed launches of each variant case (10 for the bf16 head-dim-128 cases)
# vit_f32, vit_wide, vit_f16, vit_heads8: the full-width ViT (patch 16, embed 512,
# depth 4) in f32 with 4 heads of 128, in bf16 with 2 heads of 256, in f16 with 4
# heads of 128 and in bf16 with 8 heads of 64 (the XLA route), served at batch 2
# through the infeed and trained at batch 2: (phase, dtype, heads)
VIT_VARIANTS = (("vit_f32", "f32", 4), ("vit_wide", "bf16", 2), ("vit_f16", "f16", 4),
                ("vit_heads8", "bf16", 8))
VARIANT_BATCHES = 8  # timed serving batches of each, after the warm-up
VARIANT_TRAIN_STEPS = 12
VARIANT_TRAIN_EVENTS = 16  # 8 batches of 2
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
TCP_QUEUE_SIZE = 40  # tcp_end_to_end: the queue server's default queue
TCP_STREAM_WINDOW = 32  # tcp_end_to_end: the consumer's stream credits
TCP_PROFILE_BATCHES = 8  # tcp_end_to_end: timed batches of the profiled run
CONSUMER_LEAD_S = 1.5  # the consumers start and attach this long before the producer
DURABLE_WORKERS = 2  # durable_end_to_end, durable_failover: the queue server's fleet
CLUSTER_PARTITIONS = 4  # the cluster phases: the logical queue's partitions over two servers
CLUSTER_QUEUE_SIZE = 16  # the cluster phases: a partition's queue on its server
# the producer's retained frames a partition: the partition's queue, the put
# window (the client's default, 32) and the stream window, the zero-loss bound
CLUSTER_RETAIN = CLUSTER_QUEUE_SIZE + 32 + TCP_STREAM_WINDOW
CLUSTER_FAILOVER_WARMUP, CLUSTER_FAILOVER_BATCHES = 2, 10  # cluster_failover's batches
CLUSTER_JOIN_AFTER, CLUSTER_KILL_AFTER = 2, 5  # cluster_failover: batches before each event
# cluster_failover's producer pace: under the consumer's rate, so the producer is
# still sending at the kill
CLUSTER_RATE_HZ = 60.0
CLUSTER_LEAD_S = 3.0  # passthrough_cluster: both members join before the first frame
REPL_WARMUP, REPL_BATCHES = 2, 4  # replicated_end_to_end: each turn's batches
# replicated_failover: the whole stream fits the partitions, and is longer than
# what the member can have taken in at the kill (a batch served, the arenas and
# the stream windows)
REPL_FAILOVER_BATCHES = 10
REPL_KILL_AFTER = 1  # replicated_failover: batches served before the owner is killed
REPL_STREAM_WINDOW = 8  # replicated_failover: the member's stream credits a partition
DURABLE_SEGMENT_BYTES = 64 * 1024 * 1024  # the JAX defaults: 64 MiB segments, 8 retained
DURABLE_RETAIN = 8
FAILOVER_WARMUP, FAILOVER_BATCHES = 2, 8  # durable_failover's batches
FAILOVER_KILL_AFTER = 3  # batches consumed before the queue's owner is killed
CFG1_DURABLE_QUEUE = 160  # passthrough_durable: the 128 frames and their EOS markers fit
CFG1_RETAIN = 24  # passthrough_durable: consumed segments kept, so the replay finds the run
PROBE_CONNECTIONS = 16  # durable_end_to_end: connections opened after the run
TRACE_BATCHES = 4  # stage_trace: ResNet-50 batches under the capture
LOSS_MARKERS = 30  # profiler_loss: synchronised copies, one every 2 ms
STARTED = time.monotonic()  # the process's age in stage_trace and profiler_loss
LINT_RULES = 17  # lint: the registry's rules, every one run over the port
LINT_MODELS = 5  # lint --model: windowed, stream, durable, chain, fencing

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
    """One JSON line: the phase, its fields, and the seconds since the
    script started (``at_s``)."""
    print(json.dumps({"phase": phase, **fields, "at_s": time.monotonic() - STARTED}), flush=True)


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
    outside rtol 1e-5 / atol 1e-4 (bf16 or f16 output: plus one ulp of
    that type) or on a non-finite value."""
    ref = ref.float()
    diff = (got.float() - ref).abs()
    tol = 1e-4 + 1e-5 * ref.abs()
    bits = {torch.bfloat16: 8, torch.float16: 11}.get(got.dtype)
    if bits is not None:
        # f32 values that differ by the f32 tolerance can round to
        # neighbouring 16-bit values: allow one ulp (8 significant bits
        # in bf16, 11 in f16) of the plain version's value on top
        tol = tol + torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - bits)
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
    """K1 on epix10k2M (f32 raw to f32, bf16 and f16, uint16 raw to bf16)
    and on jungfrau4M (f32 raw to bf16, generated on the card)."""
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
        "f16": calib_case(torch, fc, timer, raw, ped, gain, mask, torch.float16, "f16 out"),
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


class QueueServerCLI:
    """``python -X importtime -m psana_ray_tpu_torch.queue_server`` on
    127.0.0.1, a free port (``--port 0 --port_file``), started from the
    checkout's root; ``stop()`` sends SIGTERM (the CLI drains, then
    closes) and returns the exit code and the output."""

    def __init__(self, root, *args):
        import tempfile

        work = os.path.join(root, "build", "chip_smoke")
        os.makedirs(work, exist_ok=True)
        self.port_file = os.path.join(work, f"queue_server_{os.getpid()}_{time.monotonic_ns()}.port")
        self.log = tempfile.TemporaryFile("w+")
        self.proc = subprocess.Popen(
            cli_cmd("psana_ray_tpu_torch.queue_server", "--host", "127.0.0.1", "--port", "0",
                    "--port_file", self.port_file, "--drain_s", "2", *args),
            cwd=root, env={**os.environ, "PYTHONPATH": root}, stdout=self.log,
            stderr=subprocess.STDOUT, text=True)
        deadline = time.monotonic() + 60.0
        while not os.path.exists(self.port_file):
            if self.proc.poll() is not None or time.monotonic() > deadline:
                self.stop()
                raise AssertionError(f"the queue server did not start: {self.output[-3000:]}")
            time.sleep(0.05)
        with open(self.port_file) as f:
            self.port = int(f.read())
        self.address = f"tcp://127.0.0.1:{self.port}"

    def stop(self):
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        self.code = self.proc.returncode
        self.log.seek(0)
        self.output = self.log.read()
        self.log.close()
        if os.path.exists(self.port_file):
            os.remove(self.port_file)
        return self.code, self.output

    def text(self):
        """The server's output so far (read through a descriptor of its own:
        the server writes at the shared one's offset)."""
        with open(f"/proc/self/fd/{self.log.fileno()}") as f:
            return f.read()


def tcp_serving_run(torch, pt, pool, step, device, root, n_batches, on_result, server=None,
                    queue_name="shared_queue", warmup=WARMUP_BATCHES, exact=True):
    """One run of the ResNet serving path fed across the TCP transport:
    the queue server CLI as a process (``--queue_size 40``; or ``server``,
    started and stopped by the caller), a ``spawn`` producer process
    sending ``warmup + n_batches`` batches of the pool over ``tcp://``
    with windowed puts into the named queue ``("default", queue_name)``
    of 40 frames, and this process streaming it (``stream_open(32)``),
    once the queue is full, through ``InfeedPipeline`` into ``step``.
    Checks every exit code and count (``exact=False``: at least every
    event, duplicates allowed); returns the pipeline, the wall and fill
    seconds, the launch counts, the server's stats of the queue and the
    frames the pipeline took."""
    import multiprocessing as mp

    total = warmup + n_batches
    n_events = total * BATCH
    own = server is None
    if own:
        server = QueueServerCLI(root, "--queue_size", str(TCP_QUEUE_SIZE), "--log_level",
                                "WARNING")
    ctx = mp.get_context("spawn")
    produced = ctx.Value("q", 0)
    proc = ctx.Process(target=pt.produce_synthetic, daemon=True,
                       args=(server.address, DETECTOR, n_events, POOL_EVENTS),
                       kwargs=dict(seed=0, produced=produced, queue_name=queue_name))
    # the producer's named queue: the monitor creates it, at TCP_QUEUE_SIZE
    # frames, before the producer starts
    config = pt.TransportConfig(address=server.address, queue_size=TCP_QUEUE_SIZE,
                                queue_name=queue_name)
    client = monitor = None
    t_start = time.monotonic()
    try:
        monitor = pt.open_queue(config, role="consumer")
        proc.start()
        deadline = time.monotonic() + 180.0
        while monitor.size() < TCP_QUEUE_SIZE and proc.is_alive():
            if time.monotonic() > deadline:
                raise AssertionError(f"the producer filled {monitor.size()} of {TCP_QUEUE_SIZE}")
            time.sleep(0.01)
        fill_s = time.monotonic() - t_start
        client = pt.open_queue(config, role="consumer")
        client.stream_open(TCP_STREAM_WINDOW)
        pt.reset_counters()
        pipe = pt.InfeedPipeline(client, batch_size=BATCH, device=device,
                                 prefetch_depth=PREFETCH_DEPTH, batcher_buffers=BUFFERS,
                                 max_wait_s=60.0, metrics=pt.PipelineMetrics(warmup=warmup))
        t0 = time.monotonic()
        seen = pipe.run(step, on_result=on_result, block_until_ready=True)
        wall = time.monotonic() - t0
        counts = pt.counts()
        proc.join(timeout=60)
        queue_stats = monitor.stats()
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=10)
        for c in (client, monitor):
            if c is not None:
                c.disconnect()
        code, out = server.stop() if own else (0, "")
    if (proc.exitcode != 0 or produced.value != n_events or code != 0
            or (seen != n_events if exact else seen < n_events)):
        raise AssertionError(f"producer exit {proc.exitcode}, server exit {code}: produced "
                             f"{produced.value}, consumed {seen}, expected {n_events}; "
                             f"server: {out[-2000:]}")
    nb = warmup + pipe.metrics.batches.count
    if exact and nb != total:
        raise AssertionError(f"{nb} batches, expected {total}")
    return pipe, wall, fill_s, counts, queue_stats, seen


def phase_tcp_end_to_end(torch, pt, pool, consts, model, params, device, root):
    """The ResNet serving path fed across the TCP transport
    (``tcp_serving_run``), held as ``shm_end_to_end`` is."""
    import numpy as np

    step = make_step(torch, pt, consts, params)
    last = {}

    def on_result(out, batch):
        last["out"], last["frames"], last["event_idx"] = out, batch.frames, batch.event_idx

    pipe, wall, fill_s, counts, queue_stats, _ = tcp_serving_run(
        torch, pt, pool, step, device, root, E2E_BATCHES, on_result)
    nb = WARMUP_BATCHES + pipe.metrics.batches.count
    check_resnet_counts(counts, nb)
    staging = check_staging(pt, pipe.metrics, nb, pool[0].nbytes, pipe.batcher)
    idx = last["event_idx"].cpu().numpy()
    want = torch.from_numpy(np.stack([pool[i % len(pool)] for i in idx])).to(device)
    if not torch.equal(want, last["frames"]):
        raise AssertionError("the last batch's frames differ from the producer's pool")
    errs = check_resnet_result(torch, pt, model, consts, last)
    summary = pipe.metrics.summary()
    emit("tcp_end_to_end", batches=nb, timed_batches=summary["batches"], frames=summary["frames"],
         wall_s=wall, fill_s=fill_s, fps=summary["fps"],
         relay_gbytes_per_s=summary["fps"] * pool[0].nbytes / 1e9,
         p50_batch_ms=summary["p50_ms"], p99_batch_ms=summary["p99_ms"],
         host_batch_ms=summary["host_batch_ms"], host_stage_ms=summary["host_stage_ms"],
         queue_size=TCP_QUEUE_SIZE, stream_window=TCP_STREAM_WINDOW,
         server_queue={k: queue_stats.get(k) for k in ("depth", "high_water", "puts", "gets",
                                                        "puts_rejected")},
         launches=counts, **staging, **errs)
    return counts, {"fps": summary["fps"],
                    "relay_gbytes_per_s": summary["fps"] * pool[0].nbytes / 1e9,
                    "host_batch_ms": summary["host_batch_ms"],
                    "host_stage_ms": summary["host_stage_ms"]}


def phase_tcp_profile(torch, pt, pool, consts, params, device, root):
    """The TCP-fed ResNet serving path again, its ``TCP_PROFILE_BATCHES``
    timed batches under ``torch.profiler``: the card's idle share there."""
    step = make_step(torch, pt, consts, params)

    def run(on_batch):
        tcp_serving_run(torch, pt, pool, step, device, root, TCP_PROFILE_BATCHES,
                        lambda out, batch: on_batch())

    emit("tcp_profile", **profiled(torch, run, TCP_PROFILE_BATCHES))


# -- phases 6h-6j: the durable queues and the worker fleet -------------------
_LOG_TIME = r"(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3})"
_WORKER = _LOG_TIME + r" - INFO - worker (\d+) of \d+ \(pid (\d+)\)"
_RECOVERED = (_LOG_TIME + r" - INFO - durable queue \((\S+), (\S+)\): recovered (\d+) "
              r"unconsumed record\(s\) of (\d+) from \S+ in ([\d.]+) ms \(committed offset "
              r"(-?\d+)(, torn tail cut)?\)")
_COUNTERS = r"(?:worker (\d+): )?durable log counters (\{.*?\}) sendfile (\{.*?\})"
_MIGRATED = r"worker (\d+): connections migrated (\d+), adopted (\d+)"


def log_time(stamp):
    """Seconds since the epoch of a log line's ``asctime``."""
    import datetime

    return datetime.datetime.strptime(stamp, "%Y-%m-%d %H:%M:%S,%f").timestamp()


def recoveries(out, name, since=0.0):
    """The ``recovered`` lines of queue ``name`` logged at or after
    ``since`` (every durable open logs one, the default queue's too)."""
    import re

    return [m for m in re.findall(_RECOVERED, out) if m[2] == name and log_time(m[0]) >= since]


def owned_queue(owner):
    """The first queue name ``durable_<i>`` of namespace ``default`` that the
    fleet's pinning gives worker ``owner``."""
    from psana_ray_tpu_torch.transport.workers import queue_owner

    i = 0
    while queue_owner("default", f"durable_{i}", DURABLE_WORKERS) != owner:
        i += 1
    return f"durable_{i}"


def worker_pids(text):
    """``{worker id: [(log time, pid), ...]}`` in the order the fleet's
    workers (and their respawns) logged their start."""
    import re

    out = {}
    for stamp, wid, pid in re.findall(_WORKER, text):
        out.setdefault(int(wid), []).append((log_time(stamp), int(pid)))
    return out


def durable_counters(text):
    """``{worker id (None alone): (durable log counters, sendfile counters)}``
    from the servers' stop lines, and ``{worker id: (migrated, adopted)}``."""
    import re

    counters = {(int(w) if w else None): (json.loads(a), json.loads(b))
                for w, a, b in re.findall(_COUNTERS, text)}
    migrations = {int(w): (int(m), int(a)) for w, m, a in re.findall(_MIGRATED, text)}
    return counters, migrations


def durable_dir(root, tag, segments):
    """A fresh log directory under ``build/chip_smoke/``, once its file
    system is known to have room for ``segments`` segments; returns it
    and the free bytes."""
    import shutil

    d = os.path.join(root, "build", "chip_smoke", f"durable_{tag}_{os.getpid()}")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    free = shutil.disk_usage(d).free
    if free < segments * DURABLE_SEGMENT_BYTES:
        raise AssertionError(f"{d}: {free} bytes free, {segments} segments of "
                             f"{DURABLE_SEGMENT_BYTES} need more")
    return d, free


class DirPeak:
    """The largest size of a directory's files while it runs: the bytes
    allocated on disk (segments are sparse until written) and the files'
    apparent sizes, sampled every 50 ms on a thread."""

    def __init__(self, path):
        self.path = path
        self.peak = {"allocated_bytes": 0, "apparent_bytes": 0}
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _sample(self):
        alloc = apparent = 0
        for base, _, files in os.walk(self.path):
            for f in files:
                try:
                    st = os.stat(os.path.join(base, f))
                except OSError:
                    continue
                alloc += st.st_blocks * 512
                apparent += st.st_size
        self.peak["allocated_bytes"] = max(self.peak["allocated_bytes"], alloc)
        self.peak["apparent_bytes"] = max(self.peak["apparent_bytes"], apparent)

    def _run(self):
        while not self._done.wait(0.05):
            self._sample()

    def stop(self):
        self._done.set()
        self._thread.join(timeout=10)
        self._sample()
        return self.peak


def durable_server(root, tag, *extra):
    """The queue server CLI with ``--workers 2 --durable_dir`` (a fresh
    directory with room for the queue's depth, the retained segments and
    two more, checked first) and the JAX defaults of the segment flags."""
    d, free = durable_dir(root, tag, TCP_QUEUE_SIZE + DURABLE_RETAIN + 2)
    server = QueueServerCLI(root, "--queue_size", str(TCP_QUEUE_SIZE), "--workers",
                            str(DURABLE_WORKERS), "--durable_dir", d, *extra)
    return server, d, free


def log_path_costs(pt, pool):
    """This process, one thread: the CRC-32 of a frame's tagged payload (what
    a segment append computes on the worker's loop), and a whole append
    (``encode_into`` the mapped segment, the CRC, rolls) into a fresh
    ``SegmentLog`` with the server's segment size, under fsync ``none`` and
    ``batch`` (the server's: an ``msync`` of the segment at each roll and
    every 64 appends). Mean ms a frame over the pool's frames."""
    import shutil
    import tempfile
    import zlib

    from psana_ray_tpu_torch.storage import SegmentLog
    from psana_ray_tpu_torch.transport.codec import encode_payload

    recs = [pt.FrameRecord(0, i, f, 10.0) for i, f in enumerate(pool)]
    payloads = [encode_payload(r) for r in recs[:16]]
    zlib.crc32(payloads[0])
    t0 = time.perf_counter()
    for p in payloads:
        zlib.crc32(p)
    crc_ms = (time.perf_counter() - t0) * 1e3 / len(payloads)
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    append_ms = {}
    for fsync in ("none", "batch"):
        d = tempfile.mkdtemp(dir=work)
        try:
            log = SegmentLog(d, fsync=fsync)
            t0 = time.perf_counter()
            for r in recs:
                log.append(r)
            append_ms[fsync] = (time.perf_counter() - t0) * 1e3 / len(recs)
            log.close()
        finally:
            shutil.rmtree(d, ignore_errors=True)
    return {"crc32_ms_per_frame": crc_ms, "append_ms_per_frame": append_ms,
            "payload_bytes": len(payloads[0]), "crc_frames": len(payloads),
            "append_frames": len(recs), "zlib": zlib.ZLIB_RUNTIME_VERSION}


def collect_batches(last, seen):
    """An ``on_result`` that keeps the last batch and every event index."""

    def on_result(out, batch):
        last["out"], last["frames"], last["event_idx"] = out, batch.frames, batch.event_idx
        last["valid"] = batch.num_valid
        seen.extend(batch.event_idx[:batch.num_valid].tolist())

    return on_result


def check_last_frames(torch, pool, last, device):
    import numpy as np

    n = last["valid"]
    idx = last["event_idx"][:n].cpu().numpy()
    want = torch.from_numpy(np.stack([pool[i % len(pool)] for i in idx])).to(device)
    if not torch.equal(want, last["frames"][:n]):
        raise AssertionError("the last batch's frames differ from the producer's pool")


def phase_durable_end_to_end(torch, pt, pool, consts, model, params, device, root, tcp_gbps):
    """The ResNet serving path of ``tcp_end_to_end`` fed from a durable
    two-worker queue server: ``--workers 2 --durable_dir`` (segment flags
    at the JAX defaults), the producer's named queue one that worker 1
    owns, so every connection the kernel hands worker 0 migrates, and at
    least one must (``PROBE_CONNECTIONS`` more after the run: a
    connection misses worker 0 with odds of one half each). Every
    event exactly once, launches exact, one host copy a frame, the last
    batch's frames the pool's and its logits and features within
    ``rel_err < 0.05`` of the plain path. Prints the rates beside
    ``tcp_end_to_end``'s, the owner's log and ``sendfile`` counters, the
    migrations, the log directory's peak size and the append path's
    costs timed alone here."""
    name = owned_queue(1)
    server, d, free = durable_server(root, "e2e")
    step = make_step(torch, pt, consts, params)
    last, seen_idx = {}, []
    peak = DirPeak(d)
    try:
        pipe, wall, fill_s, counts, queue_stats, seen = tcp_serving_run(
            torch, pt, pool, step, device, root, E2E_BATCHES, collect_batches(last, seen_idx),
            server=server, queue_name=name, warmup=WARMUP_BATCHES)
        # more connections to the queue, so the kernel all but surely hands
        # some to worker 0, which migrates them (the run's three may all
        # land on the owner)
        for _ in range(PROBE_CONNECTIONS):
            c = pt.open_queue(pt.TransportConfig(address=server.address, queue_name=name),
                              role="consumer")
            if c.size() != 0:
                raise AssertionError("the drained queue is not empty")
            c.disconnect()
    finally:
        dir_peak = peak.stop()
        code, out = server.stop()
        import shutil

        shutil.rmtree(d, ignore_errors=True)
    n_events = (WARMUP_BATCHES + E2E_BATCHES) * BATCH
    if code != 0 or sorted(seen_idx) != list(range(n_events)):
        raise AssertionError(f"server exit {code}; {len(seen_idx)} deliveries of {n_events} "
                             f"events, {len(set(seen_idx))} distinct: {out[-2000:]}")
    nb = WARMUP_BATCHES + pipe.metrics.batches.count
    check_resnet_counts(counts, nb)
    staging = check_staging(pt, pipe.metrics, nb, pool[0].nbytes, pipe.batcher)
    check_last_frames(torch, pool, last, device)
    errs = check_resnet_result(torch, pt, model, consts, last)
    counters, migrations = durable_counters(out)
    if 1 not in counters:
        raise AssertionError(f"no counters from the owning worker: {out[-2000:]}")
    log_counters, sendfile = counters[1]
    migrated = sum(m for m, _ in migrations.values())
    adopted = sum(a for _, a in migrations.values())
    if migrated < 1 or adopted != migrated:
        raise AssertionError(f"{migrated} connections migrated, {adopted} adopted, of "
                             f"{PROBE_CONNECTIONS + 3}: {migrations}")
    summary = pipe.metrics.summary()
    emit("durable_end_to_end", queue=name, owner=1, workers=DURABLE_WORKERS,
         batches=nb, timed_batches=summary["batches"], frames=summary["frames"], wall_s=wall,
         fill_s=fill_s, fps=summary["fps"],
         relay_gbytes_per_s=summary["fps"] * pool[0].nbytes / 1e9,
         tcp_relay_gbytes_per_s=tcp_gbps,
         p50_batch_ms=summary["p50_ms"], p99_batch_ms=summary["p99_ms"],
         host_batch_ms=summary["host_batch_ms"], host_stage_ms=summary["host_stage_ms"],
         segment_bytes=DURABLE_SEGMENT_BYTES, retain_segments=DURABLE_RETAIN, fsync="batch",
         log=log_counters, sendfile=sendfile,
         migrations={w: {"migrated": m, "adopted": a} for w, (m, a) in migrations.items()},
         dir_peak=dir_peak, dir_free_bytes=free,
         server_queue={k: queue_stats.get(k) for k in (
             "depth", "high_water", "puts", "gets", "puts_rejected", "spilled", "resident",
             "committed_offset")},
         append_path=log_path_costs(pt, pool), launches=counts, **staging, **errs)
    return counts


def phase_durable_failover(torch, pt, pool, consts, model, params, device, root):
    """The same server shape and model, ``FAILOVER_WARMUP +
    FAILOVER_BATCHES`` batches; once the pipeline has consumed
    ``FAILOVER_KILL_AFTER`` batches, ``SIGKILL`` of the worker that owns the
    queue (its pid from its start line), with the producer process and
    this process's stream mid-stream. The supervisor must fork worker 1
    again, both clients reconnect on their own, every event arrive at
    least once with at most a put window and a stream window of
    duplicates, the launches be one set a batch served and the last batch
    within ``rel_err < 0.05``. Prints the respawn's seconds, what the new
    worker's log re-exposed and whether it cut a torn tail, and the
    duplicates."""
    import signal

    from psana_ray_tpu_torch.transport.tcp import DEFAULT_STREAM_WINDOW

    name = owned_queue(1)
    server, d, free = durable_server(root, "failover")
    step = make_step(torch, pt, consts, params)
    last, seen_idx, kill = {}, [], {}
    keep = collect_batches(last, seen_idx)

    def on_result(out, batch):
        keep(out, batch)
        kill["batches"] = kill.get("batches", 0) + 1
        if kill["batches"] == FAILOVER_KILL_AFTER:
            kill["pid"] = worker_pids(server.text())[1][-1][1]
            kill["t"] = time.time()
            os.kill(kill["pid"], signal.SIGKILL)

    try:
        pipe, wall, _, counts, queue_stats, seen = tcp_serving_run(
            torch, pt, pool, step, device, root, FAILOVER_BATCHES, on_result, server=server,
            queue_name=name, warmup=FAILOVER_WARMUP, exact=False)
        deadline = time.monotonic() + 30
        while len(worker_pids(server.text()).get(1, [])) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        code, out = server.stop()
        import shutil

        shutil.rmtree(d, ignore_errors=True)
    n_events = (FAILOVER_WARMUP + FAILOVER_BATCHES) * BATCH
    starts = worker_pids(out).get(1, [])
    respawn = [(t, pid) for t, pid in starts if pid != kill.get("pid") and t >= kill.get("t", 0)]
    recovered = recoveries(out, name, kill.get("t", 0))
    dups = len(seen_idx) - len(set(seen_idx))
    window = DEFAULT_STREAM_WINDOW + TCP_STREAM_WINDOW
    if code != 0 or "pid" not in kill or not respawn or not recovered:
        raise AssertionError(f"server exit {code}, killed {kill}, worker 1 starts {starts}, "
                             f"recoveries {recovered}: {out[-3000:]}")
    if set(seen_idx) != set(range(n_events)) or dups > window:
        raise AssertionError(f"{len(set(seen_idx))} of {n_events} events, {dups} duplicates "
                             f"(at most {window}); missing "
                             f"{sorted(set(range(n_events)) - set(seen_idx))[:16]}")
    nb = FAILOVER_WARMUP + pipe.metrics.batches.count
    check_resnet_counts(counts, nb)
    check_last_frames(torch, pool, last, device)
    errs = check_resnet_result(torch, pt, model, consts, last)
    t_rec, _, _, n_rec, n_retained, rec_ms, floor, torn = recovered[0]
    summary = pipe.metrics.summary()
    emit("durable_failover", queue=name, owner=1, killed_pid=kill["pid"],
         respawned_pid=respawn[0][1], respawn_s=respawn[0][0] - kill["t"],
         first_reopen_s=log_time(t_rec) - kill["t"], reexposed_records=int(n_rec),
         retained_records=int(n_retained), recovery_ms=float(rec_ms),
         committed_offset_at_boot=int(floor), torn_tail_cut=bool(torn), events=n_events,
         deliveries=len(seen_idx), duplicates=dups, duplicates_bound=window,
         batches=nb, wall_s=wall, fps=summary["fps"],
         server_queue={k: queue_stats.get(k) for k in ("depth", "puts", "gets", "spilled",
                                                        "committed_offset")},
         counters={w: c for w, c in durable_counters(out)[0].items()},
         launches=counts, **errs)
    return counts


def phase_passthrough_durable(pt, root, npz):
    """Config 1 through the three CLIs over ``tcp://`` into a durable
    server (``--workers 1 --durable_dir``, ``--retain_segments 24`` so that
    the drained run stays replayable): the producer CLI replays
    ``passthrough_cli``'s ``.npz`` in two shards with no consumer attached,
    the server is killed (``SIGKILL``) and started again on the same
    directory, two consumer CLIs with ``--stream`` drain what it recovered,
    and a third with ``--replay from=begin --replay_group audit`` reads
    the retained range. The CRC-32s the consumers log must equal the
    file's in both reads, and no process imports torch or JAX."""
    import re
    import shutil
    import zlib

    import numpy as np

    with np.load(npz, mmap_mode="r") as f:
        frames = f["frames"]
        crcs = [zlib.crc32(np.ascontiguousarray(frames[i])) for i in range(len(frames))]
    want = 0
    for c in crcs:
        want = zlib.crc32(c.to_bytes(4, "little"), want)
    per_segment = DURABLE_SEGMENT_BYTES // (frames[0].nbytes + 512)
    d, free = durable_dir(root, "cfg1", -(-CFG1_DURABLE_QUEUE // per_segment) + 2)
    # the run's 19 segments stay retained once drained: the replay reads it all
    args = ("--queue_size", str(CFG1_DURABLE_QUEUE), "--workers", "1", "--durable_dir", d,
            "--retain_segments", str(CFG1_RETAIN))
    queue = ("--queue_name", "cfg1_durable")
    outputs = []

    def consumers(n, address, *flags):
        cmds = [cli_cmd("psana_ray_tpu_torch.consumer", str(c), "--quiet", "--status_interval",
                        "1", "--log_level", "DEBUG", "--address", address, *queue, *flags)
                for c in range(n)]
        out, wall = run_clis(root, cmds)
        outputs.extend(out)
        received = {}
        for code, text in out:
            if code != 0:
                raise AssertionError(f"passthrough_durable: a consumer exited {code}: "
                                     f"{text[-2000:]}")
            for m in re.finditer(_CRC, text):
                idx = int(m.group(3))
                if idx in received:
                    raise AssertionError(f"passthrough_durable {flags}: event {idx} arrived "
                                         f"twice: {[text[-1500:] for _, text in out]}")
                received[idx] = int(m.group(4), 16)
        got = 0
        for i in range(len(crcs)):
            got = zlib.crc32(received.get(i, 0).to_bytes(4, "little"), got)
        ends = [re.search(_END, text) for _, text in out]
        if len(received) != len(crcs) or got != want or None in ends:
            raise AssertionError(f"passthrough_durable: {len(received)} of {len(crcs)} events, "
                                 f"CRC {got} against the file's {want}")
        counts = [int(m.group(2)) for m in ends]
        # a status line rates a consumer's frames from its first to its last
        spans = [(n - 1) / float(m.group(4)) for n, m in zip(counts, ends)
                 if n > 1 and float(m.group(4)) > 0]
        return {"frames_per_consumer": counts,
                "frames_per_s": len(crcs) / max(spans) if spans else None, "wall_s": wall,
                "crc32": got}

    server = QueueServerCLI(root, *args)
    try:
        t0 = time.monotonic()
        (code, text), = run_clis(root, [cli_cmd(
            "psana_ray_tpu_torch.producer", "--exp", f"replay:{npz}", "--num_shards", "2",
            "--num_consumers", "2", "--queue_size", str(CFG1_DURABLE_QUEUE), "--address",
            server.address, *queue)])[0]
        produce_s = time.monotonic() - t0
        outputs.append((code, text))
        produced = re.search(_PRODUCED, text)
        if code != 0 or produced is None or int(produced.group(1)) != CFG1_EVENTS:
            raise AssertionError(f"passthrough_durable: producer exit {code}: {text[-2000:]}")
        dir_bytes = DirPeak(d).stop()
        server.proc.kill()  # SIGKILL: the queue's depth is in the page cache and the log
        server.proc.wait(timeout=30)
        _, first_out = server.stop()
        outputs.append((0, first_out))
        server = QueueServerCLI(root, *args)
        drain = consumers(2, server.address, "--stream")
        replay = consumers(1, server.address, "--replay", "from=begin", "--replay_group", "audit")
    finally:
        code, out = server.stop()
        outputs.append((code, out))
        shutil.rmtree(d, ignore_errors=True)
    recovered = recoveries(out, queue[1])
    loaded = sorted(set().union(*(imported_roots(text) for _, text in outputs))
                    & {"torch", "jax", "psana_ray_tpu"})
    if code != 0 or loaded or not recovered:
        raise AssertionError(f"passthrough_durable: server exit {code}, imported {loaded}, "
                             f"recoveries {recovered}: {out[-2000:]}")
    _, _, _, n_rec, n_retained, rec_ms, floor, torn = recovered[0]
    counters, _ = durable_counters(out)
    emit("passthrough_durable", events=CFG1_EVENTS, shards=2, queue_size=CFG1_DURABLE_QUEUE,
         produce_s=produce_s, producer_frames_per_s=float(produced.group(2)),
         log_dir=dir_bytes, dir_free_bytes=free, recovery_ms=float(rec_ms),
         recovered_records=int(n_rec), retained_records=int(n_retained),
         committed_offset_at_boot=int(floor), torn_tail_cut=bool(torn), drain=drain,
         replay=replay, counters=counters.get(None), imported=loaded, crc32=want)


# -- phases 6k-6m: the sharded queue cluster ---------------------------------
def cluster_servers(root, *extra):
    """Two queue server CLIs (``--workers 1``, ``--queue_size 16``), the
    coordinator first: ``(servers, cluster address list)``."""
    servers = []
    try:
        for _ in range(2):
            servers.append(QueueServerCLI(root, "--queue_size", str(CLUSTER_QUEUE_SIZE),
                                          "--workers", "1", *extra))
    except BaseException:
        for s in servers:
            s.stop()
        raise
    return servers, ",".join(f"127.0.0.1:{s.port}" for s in servers)


def cluster_queue(addrs, prefix="cluster", want=lambda m: True):
    """The first queue name ``<prefix>_<i>`` whose partition map puts the
    same number of partitions on every server (2 + 2: the servers' ports
    change from run to run, the split does not) and meets ``want``;
    returns its map."""
    from psana_ray_tpu_torch.cluster import PartitionMap

    for i in range(4096):
        m = PartitionMap.compute(addrs, f"{prefix}_{i}", CLUSTER_PARTITIONS)
        if (all(len(m.partitions_on(a)) == CLUSTER_PARTITIONS // len(addrs) for a in addrs)
                and want(m)):
            return m
    raise AssertionError(f"no queue name splits evenly over {addrs}")


def group_info(addr, group):
    """The coordinator's answer to ``{"op": "info"}`` for ``group``."""
    from psana_ray_tpu_torch.transport.tcp import TcpQueueClient

    host, _, port = addr.rpartition(":")
    c = TcpQueueClient(host, int(port), timeout_s=5.0)
    try:
        return c.cluster_rpc({"op": "info", "group": group})
    finally:
        c.disconnect()


def relayed_frames(out, queue_name):
    """The frames a stopped server handed out of the partitions of
    ``queue_name`` (its ``queue server stopped`` line's ``gets``)."""
    import ast
    import re

    m = re.search(r"queue server stopped: (\{.*\})", out)
    if m is None:
        return None
    stats = ast.literal_eval(m.group(1))
    return sum(v.get("gets", 0) for k, v in stats.items()
               if k.startswith(f"default/{queue_name}#p"))


def cluster_serving_run(torch, pt, pool, step, device, pmap, cluster, n_batches, on_result,
                        warmup, exact=True, interval_s=0.0, on_client=None,
                        queue_size=CLUSTER_QUEUE_SIZE, stream_window=TCP_STREAM_WINDOW):
    """One run of the ResNet serving path fed through ``cluster://``: a
    ``spawn`` producer process (``produce_synthetic``) putting ``warmup +
    n_batches`` batches of the pool into ``CLUSTER_PARTITIONS`` partitions
    of ``pmap.queue_name`` with windowed puts, keeping ``CLUSTER_RETAIN``
    frames a partition, and this process the single member ``m0`` of group
    ``serve``, streamed (``stream_open(stream_window)``), once the partitions are
    full (``queue_size`` frames each), through ``InfeedPipeline`` into
    ``step``. Returns the pipeline,
    the wall and fill seconds, the launch counts, the producer's stats and
    the frames the pipeline took."""
    import multiprocessing as mp

    from psana_ray_tpu_torch.cluster import CLUSTER

    n_events = (warmup + n_batches) * BATCH
    address = f"cluster://{cluster}"
    ctx = mp.get_context("spawn")
    produced = ctx.Value("q", 0)
    stats = ctx.Queue()
    proc = ctx.Process(target=pt.produce_synthetic, daemon=True,
                       args=(address, DETECTOR, n_events, POOL_EVENTS),
                       kwargs=dict(seed=0, produced=produced, queue_name=pmap.queue_name,
                                   partitions=CLUSTER_PARTITIONS, retain=CLUSTER_RETAIN,
                                   stats=stats, interval_s=interval_s))
    config = pt.TransportConfig(address=address, queue_name=pmap.queue_name,
                                cluster_partitions=CLUSTER_PARTITIONS, queue_size=queue_size)
    full = CLUSTER_PARTITIONS * queue_size
    client = monitor = None
    producer_stats = {}
    eos_before = CLUSTER.stats()["eos_aggregated_total"]
    t_start = time.monotonic()
    try:
        monitor = pt.open_queue(config, role="consumer")  # no group: a probe
        proc.start()
        deadline = time.monotonic() + 180.0
        while (interval_s == 0 and monitor.size() < full and proc.is_alive()
               or monitor.size() == 0 and proc.is_alive()):
            if time.monotonic() > deadline:
                raise AssertionError(f"the producer filled {monitor.size()} of {full}")
            time.sleep(0.01)
        fill_s = time.monotonic() - t_start
        import dataclasses

        client = pt.open_queue(dataclasses.replace(config, group="serve", member_id="m0"),
                               role="consumer")
        client.stream_open(stream_window)
        if on_client is not None:
            on_client(client, proc)
        pt.reset_counters()
        pipe = pt.InfeedPipeline(client, batch_size=BATCH, device=device,
                                 prefetch_depth=PREFETCH_DEPTH, batcher_buffers=BUFFERS,
                                 max_wait_s=60.0, metrics=pt.PipelineMetrics(warmup=warmup))
        t0 = time.monotonic()
        seen = pipe.run(step, on_result=on_result, block_until_ready=True)
        wall = time.monotonic() - t0
        counts = pt.counts()
        proc.join(timeout=60)
        producer_stats = stats.get(timeout=10)
        eos_once = CLUSTER.stats()["eos_aggregated_total"] - eos_before == 1
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=10)
        for c in (client, monitor):
            if c is not None:
                c.disconnect()
    if (proc.exitcode != 0 or produced.value != n_events or not eos_once
            or (seen != n_events if exact else seen < 1)):
        raise AssertionError(f"producer exit {proc.exitcode}: produced {produced.value}, "
                             f"consumed {seen}, expected {n_events}, EOS {eos_once}")
    return pipe, wall, fill_s, counts, producer_stats, seen


def phase_cluster_end_to_end(torch, pt, pool, consts, model, params, device, root, tcp):
    """Config 4 fed through ``cluster://`` from two queue server processes
    (``cluster_serving_run``): both servers host partitions, every event
    exactly once and one EOS, launches exact, one host copy a frame, the
    last batch's frames the pool's and its logits and features within
    ``rel_err < 0.05`` of the plain path. Prints the map, the rates
    beside ``tcp_end_to_end``'s, each server's relayed frames, and the
    consumer's and the producer's ``CLUSTER`` counters."""
    from psana_ray_tpu_torch.cluster import CLUSTER

    servers, cluster = cluster_servers(root)
    addrs = cluster.split(",")
    pmap = cluster_queue(addrs)
    print(f"cluster_end_to_end: queue {pmap.queue_name}, partitions "
          f"{ {a: list(pmap.partitions_on(a)) for a in addrs} }", flush=True)
    step = make_step(torch, pt, consts, params)
    last, seen_idx = {}, []
    eos_before = CLUSTER.stats()["eos_aggregated_total"]
    try:
        pipe, wall, fill_s, counts, producer, seen = cluster_serving_run(
            torch, pt, pool, step, device, pmap, cluster, E2E_BATCHES,
            collect_batches(last, seen_idx), WARMUP_BATCHES)
        consumer = CLUSTER.stats()
    finally:
        stopped = [s.stop() for s in servers]
    n_events = (WARMUP_BATCHES + E2E_BATCHES) * BATCH
    if any(code != 0 for code, _ in stopped) or sorted(seen_idx) != list(range(n_events)):
        raise AssertionError(f"server exits {[c for c, _ in stopped]}; {len(seen_idx)} "
                             f"deliveries of {n_events} events, {len(set(seen_idx))} distinct")
    if consumer["eos_aggregated_total"] - eos_before != 1:
        raise AssertionError(f"{consumer['eos_aggregated_total'] - eos_before} EOS surfaced")
    nb = WARMUP_BATCHES + pipe.metrics.batches.count
    check_resnet_counts(counts, nb)
    staging = check_staging(pt, pipe.metrics, nb, pool[0].nbytes, pipe.batcher)
    check_last_frames(torch, pool, last, device)
    errs = check_resnet_result(torch, pt, model, consts, last)
    relayed = {a: relayed_frames(out, pmap.queue_name) for a, (_, out) in zip(addrs, stopped)}
    if sum(v or 0 for v in relayed.values()) < n_events or not all(relayed.values()):
        raise AssertionError(f"relayed frames {relayed} of {n_events}")
    summary = pipe.metrics.summary()
    emit("cluster_end_to_end", servers=addrs, queue=pmap.queue_name,
         partitions=CLUSTER_PARTITIONS,
         partition_map={a: list(pmap.partitions_on(a)) for a in addrs},
         batches=nb, timed_batches=summary["batches"], frames=summary["frames"], wall_s=wall,
         fill_s=fill_s, fps=summary["fps"],
         relay_gbytes_per_s=summary["fps"] * pool[0].nbytes / 1e9,
         p50_batch_ms=summary["p50_ms"], p99_batch_ms=summary["p99_ms"],
         host_batch_ms=summary["host_batch_ms"], host_stage_ms=summary["host_stage_ms"],
         tcp_end_to_end=tcp, queue_size=CLUSTER_QUEUE_SIZE, stream_window=TCP_STREAM_WINDOW,
         retain=CLUSTER_RETAIN, relayed_frames=relayed, consumer_cluster=consumer,
         producer_cluster=producer.get("cluster"),
         producer_peak_rss_bytes=producer.get("peak_rss_bytes"),
         pool_bytes=len(pool) * pool[0].nbytes, launches=counts, **staging, **errs)
    return counts


def phase_cluster_failover(torch, pt, pool, consts, model, params, device, root):
    """The same servers' shape and model, ``CLUSTER_FAILOVER_WARMUP +
    CLUSTER_FAILOVER_BATCHES`` batches, the producer at a detector's pace
    (``CLUSTER_RATE_HZ``, so it is still sending at the kill). After
    batch ``CLUSTER_JOIN_AFTER`` a consumer CLI process joins group
    ``serve``; after batch ``CLUSTER_KILL_AFTER``, ``SIGKILL`` of the second
    server (not the coordinator). The generation must rise at the join and
    the members hold disjoint partitions covering all four; after the kill
    the dead server's partitions land on the first (map version + 1) with
    no client process restarted; every event arrives at least once across
    the members (the CLI's frames with the pool's CRC-32), with at most
    ``retain`` plus the put and stream windows of duplicates for each
    partition that moved; each member ends on one EOS; launches once a
    batch served, the last batch within ``rel_err < 0.05``. Prints the
    failover latency (the kill to the first frame this process reads from
    a moved partition's new owner), the duplicates and the producer's
    resends."""
    import re
    import tempfile
    import zlib

    import numpy as np

    from psana_ray_tpu_torch.cluster import CLUSTER, assign_group_partitions
    from psana_ray_tpu_torch.transport.tcp import DEFAULT_STREAM_WINDOW

    servers, cluster = cluster_servers(root)
    addrs = cluster.split(",")
    # the moved partitions include one of m0's share after the join, so that
    # this process reads a frame from a new owner
    share = set(assign_group_partitions(["m0", "m1"], "m0", CLUSTER_PARTITIONS))
    pmap = cluster_queue(addrs, want=lambda m: set(m.partitions_on(addrs[1])) & share)
    moved = set(pmap.partitions_on(addrs[1]))
    print(f"cluster_failover: queue {pmap.queue_name}, partitions "
          f"{ {a: list(pmap.partitions_on(a)) for a in addrs} }, m0's share after the join "
          f"{sorted(share)}", flush=True)
    step = make_step(torch, pt, consts, params)
    last, seen_idx, state = {}, [], {"batches": 0}
    keep = collect_batches(last, seen_idx)
    member_cmd = cli_cmd("psana_ray_tpu_torch.consumer", "1", "--cluster", cluster,
                         "--partitions", str(CLUSTER_PARTITIONS), "--group", "serve",
                         "--member_id", "m1", "--queue_name", pmap.queue_name, "--stream",
                         "--quiet", "--log_level", "DEBUG")
    member_log = tempfile.TemporaryFile("w+")

    def on_client(client, producer):
        state["client"], state["producer"] = client, producer

    joined = threading.Event()

    def watch_join():
        # the generation at which the coordinator holds the second member
        deadline = time.monotonic() + 60
        info = group_info(addrs[0], "serve")
        while len(info.get("members", ())) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
            info = group_info(addrs[0], "serve")
        state["gen_after"], state["members"] = info.get("generation"), info.get("members")
        joined.set()

    def on_result(out, batch):
        keep(out, batch)
        state["batches"] += 1
        if state["batches"] == CLUSTER_JOIN_AFTER:
            state["gen_before"] = group_info(addrs[0], "serve")["generation"]
            state["member"] = subprocess.Popen(member_cmd, cwd=root,
                                               env={**os.environ, "PYTHONPATH": root},
                                               stdout=member_log, stderr=subprocess.STDOUT,
                                               text=True)
            threading.Thread(target=watch_join, daemon=True).start()
        if state["batches"] == CLUSTER_KILL_AFTER:
            joined.wait(60)  # the kill comes after the join
            state["producer_alive_at_kill"] = state["producer"].is_alive()
            state["t_kill"] = time.time()
            servers[1].proc.kill()

    try:
        pipe, wall, _, counts, producer, seen = cluster_serving_run(
            torch, pt, pool, step, device, pmap, cluster, CLUSTER_FAILOVER_BATCHES, on_result,
            CLUSTER_FAILOVER_WARMUP, exact=False, interval_s=1.0 / CLUSTER_RATE_HZ,
            on_client=on_client)
        client = state["client"]
        final_map = client.partition_map
        telemetry = CLUSTER.stats()
        member = state.get("member")
        if member is not None:
            member.wait(timeout=120)
    finally:
        member = state.get("member")
        if member is not None and member.poll() is None:
            member.kill()
            member.wait(timeout=30)
        stopped = [s.stop() for s in servers]
        member_log.seek(0)
        member_out = member_log.read()
        member_log.close()
    n_events = (CLUSTER_FAILOVER_WARMUP + CLUSTER_FAILOVER_BATCHES) * BATCH
    crcs = [zlib.crc32(np.ascontiguousarray(f)) for f in pool]
    theirs = []
    for _, _, idx, crc in re.findall(_CRC, member_out):
        if int(crc, 16) != crcs[int(idx) % len(pool)]:
            raise AssertionError(f"member m1: event {idx} arrived with CRC {crc}")
        theirs.append(int(idx))
    deliveries = seen_idx + theirs
    dups = len(deliveries) - len(set(deliveries))
    bound = (CLUSTER_RETAIN + DEFAULT_STREAM_WINDOW + TCP_STREAM_WINDOW) * len(moved)
    split = [sorted(assign_group_partitions(state.get("members", ()), m, CLUSTER_PARTITIONS))
             for m in ("m0", "m1")]
    loaded = sorted(imported_roots(member_out) & {"torch", "jax", "psana_ray_tpu"})
    if (stopped[0][0] != 0 or member is None or member.returncode != 0 or loaded
            or member_out.count("end of stream after") != 1):
        raise AssertionError(f"coordinator exit {stopped[0][0]}, member exit "
                             f"{None if member is None else member.returncode}, imported "
                             f"{loaded}: {member_out[-3000:]}")
    if not (state.get("gen_after", -1) > state["gen_before"]
            and state.get("members") == ["m0", "m1"]
            and not set(split[0]) & set(split[1])
            and sorted(split[0] + split[1]) == list(range(CLUSTER_PARTITIONS))):
        raise AssertionError(f"the join: generation {state['gen_before']} -> "
                             f"{state.get('gen_after')}, members {state.get('members')}, "
                             f"split {split}")
    if not state.get("producer_alive_at_kill"):
        raise AssertionError("the producer process had ended before the kill: the phase "
                             "needs it mid-stream")
    if not (final_map.version == 2 and set(final_map.assignments.values()) == {addrs[0]}):
        raise AssertionError(f"after the kill: map version {final_map.version}, "
                             f"{final_map.assignments}")
    t_map, t_first = telemetry["failover_at"], telemetry["first_moved_frame_at"]
    if t_map is None or t_first is None or not state["t_kill"] < t_map <= t_first:
        raise AssertionError(f"the failover's times: kill {state['t_kill']}, map change "
                             f"{t_map}, first frame from a new owner {t_first}")
    if set(deliveries) != set(range(n_events)) or dups > bound:
        raise AssertionError(f"{len(set(deliveries))} of {n_events} events, {dups} duplicates "
                             f"(at most {bound}); missing "
                             f"{sorted(set(range(n_events)) - set(deliveries))[:16]}")
    nb = CLUSTER_FAILOVER_WARMUP + pipe.metrics.batches.count
    check_resnet_counts(counts, nb)
    check_last_frames(torch, pool, last, device)
    errs = check_resnet_result(torch, pt, model, consts, last)
    consumer = CLUSTER.stats()
    pc = producer.get("cluster") or {}
    emit("cluster_failover", servers=addrs, queue=pmap.queue_name,
         partition_map={a: list(pmap.partitions_on(a)) for a in addrs},
         moved_partitions=sorted(moved), rate_hz=CLUSTER_RATE_HZ,
         generation_before_join=state["gen_before"], generation_after_join=state["gen_after"],
         members=state["members"], split={"m0": split[0], "m1": split[1]},
         map_version_after_kill=final_map.version,
         failover_detect_s=t_map - state["t_kill"], failover_latency_s=t_first - state["t_kill"],
         events=n_events, deliveries_m0=len(seen_idx), deliveries_m1=len(theirs),
         duplicates=dups, duplicates_bound=bound, retain=CLUSTER_RETAIN,
         producer_retained_resent=pc.get("retained_resent_total"),
         producer_tail_resent=pc.get("tail_resent_total"), producer_cluster=pc,
         consumer_cluster=consumer, batches=nb, wall_s=wall,
         fps=pipe.metrics.summary()["fps"], launches=counts, **errs)
    return counts


def phase_passthrough_cluster(pt, root, npz):
    """Config 1 through the three CLIs over ``cluster://``: two durable
    queue servers (``--workers 1 --durable_dir``, the coordinator first),
    the producer CLI replaying ``passthrough_cli``'s ``.npz`` in two shards
    with ``--cluster A,B --partitions 4``, and two consumer CLIs of group
    ``audit`` with ``--stream`` (started ``CLUSTER_LEAD_S`` before it, so
    both have joined before the first frame). Each frame's CRC-32 arrives
    once across the consumers, equal to the file's; each consumer exits 0
    on one EOS; the coordinator's ``groups.json`` holds the group at
    generation 2 or more; no process imports torch or JAX. Prints frames/s
    and how the partitions split between the members."""
    import re
    import shutil
    import zlib

    import numpy as np

    with np.load(npz, mmap_mode="r") as f:
        frames = f["frames"]
        crcs = [zlib.crc32(np.ascontiguousarray(frames[i])) for i in range(len(frames))]
        per_segment = DURABLE_SEGMENT_BYTES // (frames[0].nbytes + 512)
    dirs = [durable_dir(root, f"cluster{i}", -(-CFG1_EVENTS // per_segment) + DURABLE_RETAIN + 2)
            for i in range(2)]
    servers, stopped, store = [], [], None
    try:
        for d, _ in dirs:
            servers.append(QueueServerCLI(root, "--queue_size", str(CLUSTER_QUEUE_SIZE),
                                          "--workers", "1", "--durable_dir", d))
        cluster = ",".join(f"127.0.0.1:{s.port}" for s in servers)
        pmap = cluster_queue(cluster.split(","), prefix="cfg1_cluster")
        print(f"passthrough_cluster: queue {pmap.queue_name}, partitions "
              f"{ {a: list(pmap.partitions_on(a)) for a in pmap.servers} }", flush=True)
        flags = ("--cluster", cluster, "--partitions", str(CLUSTER_PARTITIONS),
                 "--queue_name", pmap.queue_name)
        # the producer first: run_clis starts it CLUSTER_LEAD_S after the consumers
        cmds = [cli_cmd("psana_ray_tpu_torch.producer", "--exp", f"replay:{npz}",
                        "--num_shards", "2", "--num_consumers", "2", "--queue_size",
                        str(CLUSTER_QUEUE_SIZE), *flags)]
        cmds += [cli_cmd("psana_ray_tpu_torch.consumer", str(c), "--quiet", "--status_interval",
                         "1", "--log_level", "DEBUG", "--group", "audit", "--member_id", f"m{c}",
                         "--stream", *flags) for c in range(2)]
        out, wall = run_clis(root, cmds, lead_s=CLUSTER_LEAD_S)
        stopped = [s.stop() for s in servers]
        store_path = os.path.join(dirs[0][0], "groups.json")
        if os.path.exists(store_path):
            with open(store_path) as f:
                store = json.load(f)
    finally:
        if not stopped:  # a failure before the servers were stopped
            for s in servers:
                s.stop()
        for d, _ in dirs:
            shutil.rmtree(d, ignore_errors=True)
    texts = [text for _, text in out] + [text for _, text in stopped]
    loaded = sorted(set().union(*(imported_roots(t) for t in texts))
                    & {"torch", "jax", "psana_ray_tpu"})
    codes = [code for code, _ in out] + [code for code, _ in stopped]
    if any(codes) or loaded:
        raise AssertionError(f"passthrough_cluster: exits {codes}, imported {loaded}: "
                             f"{[t[-1500:] for t in texts]}")
    received, split = {}, {}
    for c, (_, text) in enumerate(out[1:]):
        if len(re.findall(_END, text)) != 1:
            raise AssertionError(f"consumer {c}: not one end of stream: {text[-1500:]}")
        for m in re.finditer(_CRC, text):
            idx = int(m.group(3))
            if idx in received:
                raise AssertionError(f"passthrough_cluster: event {idx} arrived twice")
            received[idx] = int(m.group(4), 16)
        split[f"m{c}"] = sum(1 for _ in re.finditer(_CRC, text))
    if received != dict(enumerate(crcs)):
        wrong = [i for i, c in enumerate(crcs) if received.get(i, c) != c]
        raise AssertionError(f"passthrough_cluster: {len(received)} of {len(crcs)} events, "
                             f"CRCs differing at {wrong[:16]}")
    group = (store or {}).get("groups", {}).get("audit", {})
    if group.get("generation", 0) < 2 or group.get("drained") != list(range(CLUSTER_PARTITIONS)):
        raise AssertionError(f"groups.json under the coordinator's --durable_dir: {store}")
    ends = [re.search(_END, text) for _, text in out[1:]]
    spans = [(int(m.group(2)) - 1) / float(m.group(4)) for m in ends
             if int(m.group(2)) > 1 and float(m.group(4)) > 0]
    produced = re.search(_PRODUCED, out[0][1])
    from psana_ray_tpu_torch.cluster import assign_group_partitions

    emit("passthrough_cluster", events=CFG1_EVENTS, shards=2, partitions=CLUSTER_PARTITIONS,
         servers=cluster.split(","), queue=pmap.queue_name,
         partition_map={a: list(pmap.partitions_on(a)) for a in pmap.servers},
         frames_per_member=split,
         partitions_per_member={m: list(assign_group_partitions(["m0", "m1"], m,
                                                                 CLUSTER_PARTITIONS))
                                for m in ("m0", "m1")},
         frames_per_s=len(crcs) / max(spans) if spans else None, wall_s=wall,
         producer_frames_per_s=float(produced.group(2)) if produced else None,
         group_store=group, imported=loaded)


# -- phase 7 ---------------------------------------------------------------


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def replicated_pair(root, tag, replicate=True, queue_size=CLUSTER_QUEUE_SIZE, segments=40):
    """Two queue server CLIs (``--workers 1 --durable_dir``, the coordinator
    first) on ports chosen before they start, so that with ``replicate``
    each is given ``--replicate_peers A,B --advertise <its own>`` spelled as
    in the list. Returns the servers, the addresses, the log directories
    and a :class:`DirPeak` on each."""
    ports = [free_port(), free_port()]
    addrs = [f"127.0.0.1:{p}" for p in ports]
    servers, dirs = [], []
    try:
        for i, port in enumerate(ports):
            d, _ = durable_dir(root, f"{tag}{i}", segments)
            dirs.append(d)
            extra = (["--replicate_peers", ",".join(addrs), "--advertise", addrs[i]]
                     if replicate else [])
            servers.append(QueueServerCLI(root, "--queue_size", str(queue_size), "--workers", "1",
                                          "--port", str(port), "--durable_dir", d, *extra))
    except BaseException:
        for srv in servers:
            srv.stop()
        raise
    return servers, addrs, dirs, [DirPeak(d) for d in dirs]


def repl_counters(out):
    """A stopped server's ``REPL`` counters (its ``replication counters`` line)."""
    import re

    m = re.search(r"replication counters (\{.*\})", out)
    return json.loads(m.group(1)) if m else None


def cpu_seconds(pid):
    """User + system CPU seconds of process ``pid`` so far (every thread),
    from ``/proc/<pid>/stat``; None without it."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def put_stream(pt, pool, pmap, addrs, n):
    """The producer's side of a turn: ``n`` frames of the pool and one EOS
    into ``pmap.queue_name``'s partitions with windowed puts from this
    process, flushed, then the client closed (the producer has ended).
    Returns its put rate, frames/s: no consumer runs meanwhile and the
    partitions hold every frame, so nothing but the servers paces it."""
    from psana_ray_tpu_torch.cluster import ClusterClient

    client = ClusterClient(addrs, queue_name=pmap.queue_name, n_partitions=CLUSTER_PARTITIONS)
    try:
        records = [pt.FrameRecord(0, i, pool[i % len(pool)], 9.0) for i in range(n)]
        t0 = time.monotonic()
        for r in records:
            if not client.put_pipelined(r, deadline=time.monotonic() + 60):
                raise AssertionError("a windowed put was refused")
        if not client.flush_puts(time.monotonic() + 60):
            raise AssertionError("the windowed puts were not all answered")
        fps = n / (time.monotonic() - t0)
        if not client.put_wait(pt.EndOfStream(0, -1, 1, 1), timeout=60):
            raise AssertionError("the EOS was refused")
        return fps
    finally:
        client.disconnect()


def serve_member(torch, pt, step, device, pmap, addrs, queue_size, on_result, warmup):
    """The consumer's side of a turn: this process the single member
    ``m0`` of group ``serve``, streamed, through ``InfeedPipeline`` into
    ``step`` until the group's EOS. Returns the pipeline, the wall
    seconds, the launch counts and the frames taken."""
    import dataclasses

    from psana_ray_tpu_torch.cluster import CLUSTER

    config = pt.TransportConfig(address="cluster://" + ",".join(addrs),
                                queue_name=pmap.queue_name, cluster_partitions=CLUSTER_PARTITIONS,
                                queue_size=queue_size, group="serve", member_id="m0")
    eos_before = CLUSTER.stats()["eos_aggregated_total"]
    client = pt.open_queue(config, role="consumer")
    try:
        client.stream_open(TCP_STREAM_WINDOW)
        pt.reset_counters()
        pipe = pt.InfeedPipeline(client, batch_size=BATCH, device=device,
                                 prefetch_depth=PREFETCH_DEPTH, batcher_buffers=BUFFERS,
                                 max_wait_s=60.0, metrics=pt.PipelineMetrics(warmup=warmup))
        t0 = time.monotonic()
        seen = pipe.run(step, on_result=on_result, block_until_ready=True)
        wall = time.monotonic() - t0
        counts = pt.counts()
    finally:
        client.disconnect()
    if CLUSTER.stats()["eos_aggregated_total"] - eos_before != 1:
        raise AssertionError("the member did not end on one EOS")
    return pipe, wall, counts, seen


def phase_replicated_end_to_end(torch, pt, pool, consts, model, params, device, root):
    """Config 4 through two queue servers that chain-replicate their
    durable partition logs (``--replicate_peers A,B``), then through the
    same pair without replication, one turn each. A turn: this process
    puts ``(REPL_WARMUP + REPL_BATCHES)`` batches of the pool and an EOS
    with windowed puts (every answer waits until the follower has logged
    the frame when replicated) and ends, timed; then serves them as the
    group's one member: every event once and one EOS, launches once a
    batch, one host copy a frame, the last batch's frames the pool's and
    its logits within ``rel_err < 0.05`` of the plain path. The replicated
    servers may not degrade. Prints the put rates, the served frames/s and
    their ratios, each server's CPU over the puts (in cores),
    ``host_batch_ms``, the records and bytes shipped, and each log
    directory's peak size."""
    import shutil

    step = make_step(torch, pt, consts, params)
    n_events = (REPL_WARMUP + REPL_BATCHES) * BATCH
    queue_size = n_events // CLUSTER_PARTITIONS + 4  # a partition's frames, its EOS, room
    frames_a_segment = DURABLE_SEGMENT_BYTES // pool[0].nbytes
    segments = CLUSTER_PARTITIONS * (queue_size // frames_a_segment + 3)
    runs, counts_all = {}, None
    for replicate in (True, False):
        label = "replicated" if replicate else "unreplicated"
        servers, addrs, dirs, peaks = replicated_pair(root, f"r2e_{label}", replicate,
                                                      queue_size, segments)
        pmap = cluster_queue(addrs, prefix="repl")
        last, seen_idx = {}, []
        try:
            cpu0 = [cpu_seconds(srv.proc.pid) for srv in servers]
            t_put = time.monotonic()
            put_fps = put_stream(pt, pool, pmap, addrs, n_events)
            put_wall = time.monotonic() - t_put
            # each server's CPU over the puts, in cores: near 1 means its
            # one loop thread was the bound
            put_cores = [None if a is None or b is None else (b - a) / put_wall
                         for a, b in zip(cpu0, (cpu_seconds(srv.proc.pid) for srv in servers))]
            pipe, wall, counts, seen = serve_member(torch, pt, step, device, pmap, addrs,
                                                    queue_size, collect_batches(last, seen_idx),
                                                    REPL_WARMUP)
        finally:
            stopped = [srv.stop() for srv in servers]
            dir_peaks = [pk.stop() for pk in peaks]
            for d in dirs:
                shutil.rmtree(d, ignore_errors=True)
        if any(code != 0 for code, _ in stopped) or sorted(seen_idx) != list(range(n_events)):
            raise AssertionError(f"{label}: server exits {[c for c, _ in stopped]}; "
                                 f"{len(seen_idx)} deliveries of {n_events} events")
        nb = REPL_WARMUP + pipe.metrics.batches.count
        check_resnet_counts(counts, nb)
        staging = check_staging(pt, pipe.metrics, nb, pool[0].nbytes, pipe.batcher)
        check_last_frames(torch, pool, last, device)
        errs = check_resnet_result(torch, pt, model, consts, last)
        repl = [repl_counters(out) for _, out in stopped]
        if replicate:
            if any(r is None for r in repl) or any(r["degrades"] for r in repl):
                raise AssertionError(f"replication counters {repl}: a link degraded")
            if sum(r["records_shipped"] for r in repl) < n_events:
                raise AssertionError(f"{sum(r['records_shipped'] for r in repl)} records "
                                     f"shipped for {n_events} put")
        elif any(r is not None for r in repl):
            raise AssertionError(f"an unreplicated server logged replication: {repl}")
        summary = pipe.metrics.summary()
        runs[label] = dict(
            put_fps=put_fps, put_server_cores=put_cores, served_fps=summary["fps"],
            served_wall_fps=seen / wall, batches=nb,
            wall_s=wall, p50_batch_ms=summary["p50_ms"], p99_batch_ms=summary["p99_ms"],
            host_batch_ms=summary["host_batch_ms"], host_stage_ms=summary["host_stage_ms"],
            records_shipped=sum(r["records_shipped"] for r in repl) if replicate else 0,
            bytes_shipped=sum(r["bytes_shipped"] for r in repl) if replicate else 0,
            degraded=sum(r["degrades"] for r in repl) if replicate else 0,
            floor_refreshes=sum(r["floor_refreshes"] for r in repl) if replicate else 0,
            dir_peak_bytes=[pk["allocated_bytes"] for pk in dir_peaks],
            dirs_peak_bytes=sum(pk["allocated_bytes"] for pk in dir_peaks),
            launches=counts, **staging, **errs)
        counts_all = counts if counts_all is None else {
            k: counts_all[k] + counts[k] for k in counts}
    r, u = runs["replicated"], runs["unreplicated"]
    emit("replicated_end_to_end", partitions=CLUSTER_PARTITIONS, queue_size=queue_size,
         events=n_events, frame_bytes=pool[0].nbytes, put_fps_ratio=r["put_fps"] / u["put_fps"],
         served_fps_ratio=r["served_fps"] / u["served_fps"], **runs)
    return counts_all


def phase_replicated_failover(torch, pt, pool, consts, model, params, device, root):
    """Config 4 through a replicated pair whose partitions hold the whole
    stream (``REPL_FAILOVER_BATCHES`` batches): the ``spawn`` producer puts
    every frame and its EOS and exits; the member ``m0`` then serves, and
    after ``REPL_KILL_AFTER`` batches the second server (not the
    coordinator, owner of two partitions) is killed with ``SIGKILL``. The
    member fails over and each moved partition's 'Y' must answer a range;
    every event must arrive, each frame the pool's byte for byte on the
    card, with at most the put and stream windows plus
    ``FLOOR_COMMIT_STRIDE`` of duplicates a moved partition, and one EOS;
    launches once a batch, the last batch within ``rel_err < 0.05``. Prints
    the promotions' ms on the survivor, the failover latency (the kill to
    the first frame read from a moved partition's new owner) and the
    duplicates."""
    import re
    import shutil

    import numpy as np

    from psana_ray_tpu_torch.cluster import CLUSTER
    from psana_ray_tpu_torch.cluster.replication import FLOOR_COMMIT_STRIDE
    from psana_ray_tpu_torch.transport.tcp import DEFAULT_STREAM_WINDOW

    n_events = REPL_FAILOVER_BATCHES * BATCH
    per_partition = n_events // CLUSTER_PARTITIONS
    # the frames, their EOS markers and a little room; each server holds two
    # partitions' logs and two replicas
    queue_size = per_partition + 4
    frames_a_segment = DURABLE_SEGMENT_BYTES // pool[0].nbytes
    segments = CLUSTER_PARTITIONS * (per_partition // frames_a_segment + 3)
    servers, addrs, dirs, peaks = replicated_pair(root, "rfo", True, queue_size, segments)
    pmap = cluster_queue(addrs, prefix="rfo")
    moved = sorted(pmap.partitions_on(addrs[1]))
    print(f"replicated_failover: queue {pmap.queue_name}, partitions "
          f"{ {a: list(pmap.partitions_on(a)) for a in addrs} }", flush=True)
    step = make_step(torch, pt, consts, params)
    pool_dev = torch.from_numpy(np.stack(pool)).to(device)
    last, seen_idx, state = {}, [], {"batches": 0, "mismatch": []}
    keep = collect_batches(last, seen_idx)
    before = CLUSTER.stats()

    def on_client(client, producer):
        producer.join(timeout=120)  # every frame and EOS put: the producer has ended
        state["producer_exit"] = producer.exitcode

    def on_result(out, batch):
        keep(out, batch)
        n = batch.num_valid
        idx = batch.event_idx[:n]
        want = pool_dev[idx.to(device) % len(pool)]
        if not torch.equal(want, batch.frames[:n]):
            state["mismatch"].append(idx.tolist())
        state["batches"] += 1
        if state["batches"] == REPL_KILL_AFTER:
            state["t_kill"] = time.time()
            servers[1].proc.kill()

    try:
        pipe, wall, _, counts, producer, seen = cluster_serving_run(
            torch, pt, pool, step, device, pmap, ",".join(addrs), REPL_FAILOVER_BATCHES,
            on_result, 0, exact=False, on_client=on_client, queue_size=queue_size,
            stream_window=REPL_STREAM_WINDOW)
        telemetry = CLUSTER.stats()
    finally:
        stopped = [srv.stop() for srv in servers]
        dir_peaks = [pk.stop() for pk in peaks]
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    survivor = stopped[0][1]
    promotes = [json.loads(m) for m in re.findall(r"replica_promote (\{.*?\})", survivor)]
    requested = telemetry["promotes_requested_total"] - before["promotes_requested_total"]
    served = telemetry["promotes_served_total"] - before["promotes_served_total"]
    if state.get("producer_exit") != 0 or stopped[0][0] != 0:
        raise AssertionError(f"producer exit {state.get('producer_exit')}, survivor exit "
                             f"{stopped[0][0]}: {survivor[-3000:]}")
    if not (requested == served == len(moved) and len(promotes) == len(moved)
            and all(p["end"] > p["start"] for p in promotes)):
        raise AssertionError(f"promotions: {requested} asked, {served} answered with a range, "
                             f"{promotes} on the survivor, {len(moved)} partitions moved")
    t_map, t_first = telemetry["failover_at"], telemetry["first_moved_frame_at"]
    if t_map is None or t_first is None or not state["t_kill"] < t_map <= t_first:
        raise AssertionError(f"the failover's times: kill {state['t_kill']}, map change "
                             f"{t_map}, first frame from a new owner {t_first}")
    dups = len(seen_idx) - len(set(seen_idx))
    bound = (DEFAULT_STREAM_WINDOW + REPL_STREAM_WINDOW + FLOOR_COMMIT_STRIDE) * len(moved)
    if set(seen_idx) != set(range(n_events)) or dups > bound or state["mismatch"]:
        raise AssertionError(f"{len(set(seen_idx))} of {n_events} events, {dups} duplicates "
                             f"(at most {bound}), frames unlike the pool's in "
                             f"{state['mismatch'][:2]}; missing "
                             f"{sorted(set(range(n_events)) - set(seen_idx))[:16]}")
    if telemetry["eos_aggregated_total"] - before["eos_aggregated_total"] != 1:
        raise AssertionError("the member did not end on one EOS")
    nb = pipe.metrics.batches.count
    check_resnet_counts(counts, nb)
    errs = check_resnet_result(torch, pt, model, consts, last)
    emit("replicated_failover", servers=addrs, queue=pmap.queue_name,
         partition_map={a: list(pmap.partitions_on(a)) for a in addrs}, moved_partitions=moved,
         events=n_events, queue_size=queue_size, producer_ended_before_kill=True,
         promotes=promotes, promote_ms=[p["ms"] for p in promotes],
         failover_detect_s=t_map - state["t_kill"], failover_latency_s=t_first - state["t_kill"],
         deliveries=len(seen_idx), duplicates=dups, duplicates_bound=bound,
         survivor_replication=repl_counters(survivor),
         dir_peak_bytes=[pk["allocated_bytes"] for pk in dir_peaks], batches=nb, wall_s=wall,
         fps=pipe.metrics.summary()["fps"], launches=counts, **errs)
    return counts


OBS_QUEUE = "observed"  # observed_end_to_end: the named queue of every turn
OBS_FRAMES = 192  # observed_end_to_end: frames a turn (6 batches), the pool cycled
OBS_TURNS = (("off", None), ("sample_100", 100), ("sample_1", 1))  # (tag, --trace_sample)
OBS_STAGES = ("enqueue", "queue_dwell", "dequeue", "batch", "device_put", "dispatch", "e2e")
OBS_SPANS = ("produce", "enqueue", "queue_dwell", "relay", "dequeue", "batch", "device_put",
             "dispatch")
OBS_ALIGN_TOL_US = 100.0  # one host: spans may not step back in time past this
OBS_LOGIT_TOL = 1e-6  # a traced turn's last logits against the untraced turn's
OBS_STALL_WINDOW = 8  # the stall run's stream credits
OBS_STALL_S = 3.0  # the stall run reads nothing for at least this long
OBS_STALL_WAIT_S = 15.0  # ... and at most this long for the dumps


def observed_npz(root, pool):
    """``OBS_FRAMES`` RAW frames, the pool cycled, as a replay ``.npz``
    under ``build/chip_smoke/``."""
    import numpy as np

    frames = np.empty((OBS_FRAMES, *pool[0].shape), pool[0].dtype)
    for i in range(OBS_FRAMES):
        frames[i] = pool[i % len(pool)]
    path = os.path.join(root, "build", "chip_smoke", f"observed_{os.getpid()}.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_replay(path, frames, [10.0] * OBS_FRAMES)
    return path


class ProducerCLI:
    """``python -X importtime -m psana_ray_tpu_torch.producer`` replaying
    ``npz`` into the named queue ``OBS_QUEUE`` of ``address``, from the
    checkout's root; its output goes to a file."""

    def __init__(self, root, npz, address, *args):
        import tempfile

        self.log = tempfile.TemporaryFile("w+")
        self.proc = subprocess.Popen(
            cli_cmd("psana_ray_tpu_torch.producer", "--exp", f"replay:{npz}", "--address",
                    address, "--queue_name", OBS_QUEUE, "--queue_size", str(TCP_QUEUE_SIZE),
                    *args),
            cwd=root, env={**os.environ, "PYTHONPATH": root}, stdout=self.log,
            stderr=subprocess.STDOUT, text=True)

    def wait(self, timeout=120.0):
        """The exit code and the output; kills a process still running at
        the timeout."""
        try:
            code = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            code = self.proc.wait(timeout=30)
        self.log.seek(0)
        out = self.log.read()
        self.log.close()
        return code, out


def obs_flags(turn_dir, sample):
    """``--trace_dir``/``--flight_dir`` under ``turn_dir``, and the rate."""
    return ["--trace_dir", os.path.join(turn_dir, "trace"), "--trace_sample", str(sample),
            "--flight_dir", os.path.join(turn_dir, "flight")]


def scrape_metrics(port, stats):
    """One ``/metrics`` scrape of the queue server: its ms and bytes; the
    text must parse as Prometheus exposition text, and its puts and gets
    of ``OBS_QUEUE`` must equal the server's 'T' ``stats``."""
    import re
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        body = r.read()
        ctype = r.headers.get("Content-Type", "")
    ms = (time.perf_counter() - t0) * 1e3
    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)\{source="((?:[^"\\]|\\.)*)"\} (\S+)$')
    values = {}
    for line in body.decode().splitlines():
        if line.startswith("# HELP ") or re.match(r"^# TYPE \S+ (counter|gauge)$", line):
            continue
        m = sample.match(line)
        if m is None:
            raise AssertionError(f"/metrics line is no Prometheus sample: {line!r}")
        values[(m.group(1), m.group(2))] = float(m.group(3))
    key = f"default_{OBS_QUEUE}"
    got = {k: values.get((f"psana_ray_{key}_{k}", "queue_server")) for k in ("puts", "gets")}
    if not ctype.startswith("text/plain; version=0.0.4") or got != {
            k: float(stats[k]) for k in ("puts", "gets")}:
        raise AssertionError(f"/metrics ({ctype}) gives {got} for the queue, 'T' gives "
                             f"{ {k: stats[k] for k in ('puts', 'gets')} }")
    return {"ms": ms, "bytes": len(body), "samples": len(values), "queue": got}


def spool_bytes(trace_dir):
    """Each process's spool bytes, by its process name."""
    out = {}
    for name in os.listdir(trace_dir):
        out[name.split("-", 1)[0]] = os.path.getsize(os.path.join(trace_dir, name))
    return out


def _quantiles(xs):
    import numpy as np

    if not xs:
        return None
    a = np.asarray(xs)
    return {"p50_ms": float(np.quantile(a, 0.5)), "p99_ms": float(np.quantile(a, 0.99)),
            "n": len(xs)}


def merged_frames(pt, trace_dir, complete):
    """Merge the turn's spools: the merged spans and instants, each track's
    skew against the server, and with ``complete`` every one of the
    ``OBS_FRAMES`` frames holding each of ``OBS_SPANS``, their starts in
    that order within ``OBS_ALIGN_TOL_US``, and the stages' p50 and p99
    from the merged trace (``e2e``: ``produce`` to the end of ``dispatch``)."""
    from psana_ray_tpu_torch.obs import trace_merge

    t0 = time.perf_counter()
    doc = trace_merge.merge([trace_dir])
    merge_s = time.perf_counter() - t0
    tracks = doc["otherData"]["tracks"]
    out = {"merge_s": merge_s, "tracks": len(tracks),
           "spans": sum(t["spans"] for t in tracks),
           "instants": sum(t["instants"] for t in tracks),
           "skew_ms": {t["process"].split()[0]: t["skew_vs_server_s"] * 1e3 for t in tracks},
           "anchor_exchanges": {t["process"].split()[0]: t["peer_anchor_exchanges"]
                                for t in tracks}}
    frames = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "frame":
            frames.setdefault(e["args"]["trace_id"], {})[e["name"]] = (e["ts"], e.get("dur", 0.0))
    out["frames_traced"] = len(frames)
    if not complete:
        return out
    missing = {tid: sorted(set(OBS_SPANS) - set(sp)) for tid, sp in frames.items()
               if set(sp) != set(OBS_SPANS)}
    if len(frames) != OBS_FRAMES or missing:
        raise AssertionError(f"{len(frames)} traced frames of {OBS_FRAMES}; missing spans: "
                             f"{dict(list(missing.items())[:4])}")
    back = max(max(sp[a][0] - sp[b][0] for a, b in zip(OBS_SPANS, OBS_SPANS[1:]))
               for sp in frames.values())
    if back > OBS_ALIGN_TOL_US:
        raise AssertionError(f"a frame's spans go back {back} us in time once aligned")
    out["largest_step_back_us"] = back
    durs = {name: [sp[name][1] / 1e3 for sp in frames.values()] for name in OBS_SPANS}
    durs["e2e"] = [(sp["dispatch"][0] + sp["dispatch"][1] - sp["produce"][0]) / 1e3
                   for sp in frames.values()]
    out["stages_from_trace"] = {name: _quantiles(durs[name])
                                for name in (*OBS_STAGES, "relay")}
    # what no span covers: the put's wire time (and window waits) before
    # the server's arrival stamp, and the push's before the consumer's pop
    out["unspanned"] = {
        "put_to_arrival": _quantiles([(sp["queue_dwell"][0] - sum(sp["enqueue"])) / 1e3
                                      for sp in frames.values()]),
        "send_to_pop": _quantiles([(sp["dequeue"][0] - sum(sp["relay"])) / 1e3
                                   for sp in frames.values()])}
    return out


def observed_turn(torch, pt, step, device, root, npz, work, tag, sample):
    """One turn of ``observed_end_to_end``: a queue server CLI, the producer
    CLI replaying ``npz`` and this process serving the ResNet path over
    ``tcp://``; with ``sample`` every process traces 1 frame in ``sample``
    and arms its flight recorder, and the server serves ``/metrics`` and
    samples its history."""
    import argparse

    from psana_ray_tpu_torch.obs.flight import FLIGHT
    from psana_ray_tpu_torch.obs.tracing import TRACER, configure_from_args, exchange_anchors

    traced = sample is not None
    turn_dir = os.path.join(work, tag)
    metrics_port = free_port() if traced else None
    srv_obs = prod_obs = []
    if traced:
        prod_obs = obs_flags(turn_dir, sample)
        srv_obs = [*prod_obs, "--metrics_port", str(metrics_port), "--history_interval", "0.5"]
    server = QueueServerCLI(root, "--queue_size", str(TCP_QUEUE_SIZE), "--log_level", "WARNING",
                            *srv_obs)
    config = pt.TransportConfig(address=server.address, queue_size=TCP_QUEUE_SIZE,
                                queue_name=OBS_QUEUE)
    producer = client = monitor = None
    last, result = {}, {}

    def on_result(out, batch):
        last["out"], last["frames"], last["event_idx"] = out, batch.frames, batch.event_idx

    try:
        monitor = pt.open_queue(config, role="consumer")  # creates the queue, 40 frames
        client = pt.open_queue(config, role="consumer")
        if traced:
            args = argparse.Namespace(trace_dir=os.path.join(turn_dir, "trace"),
                                      trace_sample=sample,
                                      flight_dir=os.path.join(turn_dir, "flight"))
            configure_from_args(args, "serving")
            result["anchor_exchanges"] = exchange_anchors(monitor)
        client.stream_open(TCP_STREAM_WINDOW)
        pt.reset_counters()
        producer = ProducerCLI(root, npz, server.address, *prod_obs)
        pipe = pt.InfeedPipeline(client, batch_size=BATCH, device=device,
                                 prefetch_depth=PREFETCH_DEPTH, batcher_buffers=BUFFERS,
                                 max_wait_s=60.0, metrics=pt.PipelineMetrics(warmup=1))
        t0 = time.monotonic()
        seen = pipe.run(step, on_result=on_result, block_until_ready=True)
        result["wall_s"] = time.monotonic() - t0
        counts = pt.counts()
        code, out = producer.wait()
        producer = None
        stats = monitor.stats()
        if traced:
            result["scrape"] = scrape_metrics(metrics_port, stats)
            fed = monitor.cluster_rpc({"op": "metrics"})
            if not (fed.get("ok") is True and {"host", "pid", "metrics"} <= set(fed)
                    and "queue_server" in fed["metrics"]):
                raise AssertionError(f"the 'N' metrics answer lacks keys: {sorted(fed)}")
            result["federation_keys"] = sorted(fed)
    finally:
        if traced:
            TRACER.close()
            FLIGHT.uninstall()
        for c in (client, monitor):
            if c is not None:
                c.disconnect()
        if producer is not None:
            producer.proc.kill()
            producer.wait(timeout=30)
        srv_code, srv_out = server.stop()
    roots = imported_roots(out) & {"torch", "jax"}
    if seen != OBS_FRAMES or code != 0 or srv_code != 0 or roots:
        raise AssertionError(f"{tag}: consumed {seen} of {OBS_FRAMES}, producer exit {code} "
                             f"(imported {roots}), server exit {srv_code}: {out[-1500:]} "
                             f"{srv_out[-1500:]}")
    check_resnet_counts(counts, OBS_FRAMES // BATCH)
    summary = pipe.metrics.summary()
    stages = pipe.metrics.stages.snapshot()
    result.update(
        fps=summary["fps"], frames=OBS_FRAMES, timed_batches=summary["batches"],
        p50_batch_ms=summary["p50_ms"], p99_batch_ms=summary["p99_ms"],
        host_batch_ms=summary["host_batch_ms"], host_stage_ms=summary["host_stage_ms"],
        server_queue={k: stats.get(k) for k in ("puts", "gets", "high_water")},
        stages_serving={name: ({k: stages[name][k] for k in ("count", "p50_ms", "p99_ms")}
                               if name in stages else None) for name in OBS_STAGES},
        launches=counts)
    if traced:
        tdir = os.path.join(turn_dir, "trace")
        result["spool_bytes"] = spool_bytes(tdir)
        if set(result["spool_bytes"]) != {"producer", "queue_server", "serving"}:
            raise AssertionError(f"{tag}: spools {result['spool_bytes']}")
        result["merged"] = merged_frames(pt, tdir, complete=sample == 1)
    return result, last, counts


def observed_stall(pt, root, npz, work):
    """The stall of ``observed_end_to_end``: a queue server CLI with
    ``--stall_poll_s 0.2 --stall_full_s 1 --flight_dir``, the producer CLI
    with ``--flight_dir``, and this process reading the stream (8 credits),
    which stops reading after the first batch's frames for at least
    ``OBS_STALL_S`` while the producer still has frames to put: the
    server must log a ``backpressure`` event and write a flight dump with
    reason ``stall`` holding the event, a metrics snapshot, a history tail
    and the thread stacks; a ``SIGUSR2`` to the producer must then give a
    dump with reason ``signal``. Then the rest is read to the end."""
    import json as _json
    import signal

    sdir, pdir = (os.path.join(work, "stall", n) for n in ("server", "producer"))
    server = QueueServerCLI(root, "--queue_size", str(TCP_QUEUE_SIZE), "--stall_poll_s", "0.2",
                            "--stall_full_s", "1", "--flight_dir", sdir, "--history_interval",
                            "0.5", "--log_level", "INFO")
    config = pt.TransportConfig(address=server.address, queue_size=TCP_QUEUE_SIZE,
                                queue_name=OBS_QUEUE)
    producer = client = None
    frames = eos = 0
    found = {}

    def dumps(d):
        if not os.path.isdir(d):
            return []
        return [_json.loads(open(os.path.join(d, f)).read()) for f in sorted(os.listdir(d))
                if f.endswith(".json")]

    def read(max_items, timeout):
        nonlocal frames, eos
        for item in client.get_batch_stream(max_items, timeout=timeout):
            if isinstance(item, pt.EndOfStream):
                eos += 1
            else:
                frames += 1
                item.release()

    try:
        client = pt.open_queue(config, role="consumer")
        client.stream_open(OBS_STALL_WINDOW)
        producer = ProducerCLI(root, npz, server.address, "--flight_dir", pdir)
        deadline = time.monotonic() + 120.0
        while frames < BATCH:
            if time.monotonic() > deadline:
                raise AssertionError(f"stall run: {frames} frames before the stall")
            read(BATCH - frames, 1.0)
        t_stall = time.monotonic()
        while time.monotonic() - t_stall < OBS_STALL_WAIT_S:
            if "stall" not in found and '"kind": "backpressure"' in server.text():
                stall_dumps = [d for d in dumps(sdir) if d["reason"] == "stall"]
                if stall_dumps:
                    found["stall"] = (time.monotonic() - t_stall, stall_dumps[0])
                    producer.proc.send_signal(signal.SIGUSR2)
            if "stall" in found and "signal" not in found:
                signal_dumps = [d for d in dumps(pdir) if d["reason"] == "signal"]
                if signal_dumps:
                    found["signal"] = (time.monotonic() - t_stall, signal_dumps[0])
            if len(found) == 2 and time.monotonic() - t_stall >= OBS_STALL_S:
                break
            time.sleep(0.05)
        stall_s = time.monotonic() - t_stall
        deadline = time.monotonic() + 120.0
        while not eos and time.monotonic() < deadline:
            read(64, 1.0)
        code, out = producer.wait()
        producer = None
    finally:
        if client is not None:
            client.disconnect()
        if producer is not None:
            producer.proc.kill()
            producer.wait(timeout=30)
        srv_code, srv_out = server.stop()
    if len(found) != 2 or frames != OBS_FRAMES or eos != 1 or code != 0 or srv_code != 0:
        raise AssertionError(f"stall run: dumps {sorted(found)}, {frames} frames, {eos} EOS, "
                             f"producer exit {code}, server exit {srv_code}: {srv_out[-2000:]}")
    t_dump, doc = found["stall"]
    checks = {
        "trigger_backpressure": (doc.get("trigger") or {}).get("kind") == "backpressure",
        "event_in_ring": any(e.get("kind") == "stall" and e.get("stall_kind") == "backpressure"
                             for e in doc["events"]),
        "metrics_snapshot": "queue_server" in (doc.get("metrics") or {}),
        "timeseries_tail": bool(doc.get("timeseries_tail")),
        "thread_stacks": bool(doc.get("threads")),
        "signal_dump_stacks": bool(found["signal"][1].get("threads")),
    }
    if not all(checks.values()):
        raise AssertionError(f"stall dump lacks: {[k for k, v in checks.items() if not v]}")
    line = next(ln for ln in srv_out.splitlines() if '"kind": "backpressure"' in ln)
    return {"stall_s": stall_s, "stall_dump_after_s": t_dump,
            "signal_dump_after_s": found["signal"][0], "stall_log": line.split(" - ", 2)[-1],
            "stall_dump_keys": sorted(doc), "timeseries_tail_keys": len(doc["timeseries_tail"]),
            "frames": frames, **checks}


def phase_observed_end_to_end(torch, pt, pool, consts, model, params, device, root):
    """Config 4 at full width (batch 32, ResNet-50 at width 64, K1–K3)
    from the producer CLI through the queue server CLI over
    ``tcp://127.0.0.1`` to the serving pipeline here, in three turns of
    ``OBS_FRAMES`` frames: tracing off, 1 frame in 100, every frame; then
    a stall. Returns the three turns' launch counts, summed."""
    import shutil

    step = make_step(torch, pt, consts, params)
    npz = observed_npz(root, pool)
    work = os.path.join(root, "build", "chip_smoke", f"observed_{os.getpid()}")
    t_phase = time.monotonic()
    turns, lasts = {}, {}
    total = {}
    try:
        for tag, sample in OBS_TURNS:
            turns[tag], lasts[tag], counts = observed_turn(torch, pt, step, device, root, npz,
                                                           work, tag, sample)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        stall = observed_stall(pt, root, npz, work)
    finally:
        os.remove(npz)
        shutil.rmtree(work, ignore_errors=True)
    base = lasts["off"]
    for tag, last in lasts.items():
        turns[tag].update(check_resnet_result(torch, pt, model, consts, last))
        if not torch.equal(last["event_idx"], base["event_idx"]):
            raise AssertionError(f"{tag}: the last batch holds other events than the untraced")
        diff = float((last["out"][0].float() - base["out"][0].float()).abs().max())
        turns[tag]["logits_max_abs_diff_vs_off"] = diff
        if diff > OBS_LOGIT_TOL:
            raise AssertionError(f"{tag}: logits differ from the untraced turn's by {diff}")
    emit("observed_end_to_end", frames_per_turn=OBS_FRAMES, batch=BATCH,
         queue_size=TCP_QUEUE_SIZE, stream_window=TCP_STREAM_WINDOW,
         fps={tag: turns[tag]["fps"] for tag in turns},
         fps_ratio_vs_off={tag: turns[tag]["fps"] / turns["off"]["fps"] for tag in turns},
         turns=turns, stall=stall, phase_s=time.monotonic() - t_phase)
    return total


# profiled_end_to_end: (tag, --profile_hz, spools and traces, durable server);
# None is the default rate (97 Hz), with a sampler in this process too
PROF_TURNS = (("off", "0", False, False), ("default", None, False, False),
              ("spooled_traced", None, True, False), ("durable", None, False, True))
PROF_POLL_S = 0.25  # profiled_end_to_end: the collector's sweep interval
PROF_ATTRIBUTED = 0.8  # ... the least share of the server's on-CPU samples billed to a stage
PROF_PROCESSES = ("producer", "queue_server", "serving")


def prof_view(summary, frames):
    """A process's profile summary (the federation payload's ``profile``)
    over ``frames``: on-CPU ms a frame by stage and in all, the share billed
    to a known stage, cpu_frac and CPU ns a frame of its last tick, and its
    five hottest frames with their share of the on-CPU samples."""
    if not summary:
        return None
    ms = summary["stage_cpu_ms"]
    total = sum(ms.values())
    return {"frames": frames, "samples": summary["samples"], "on_cpu": summary["on_cpu"],
            "stage_cpu_ms_per_frame": {k: v / frames for k, v in ms.items()} if frames else None,
            "cpu_ms_per_frame": total / frames if frames else None,
            "attributed": 1.0 - ms.get("untagged", 0.0) / total if total else None,
            "cpu_frac": summary["cpu_frac"], "cpu_ns_per_frame": summary["cpu_ns_per_frame"],
            "hot": [[h["frame"], h["pct"]] for h in summary["hot"][:5]]}


def serving_threads(sampler):
    """This process's sampler: the threads with no procfs entry (counted
    on-CPU at every sample) by their outermost frames, and the ``dispatch``
    stage's on-CPU samples with the ones whose leaf is a synchronise."""
    frames = sys._current_frames()
    untracked = []
    for ident in sampler.untracked_threads():
        f, names = frames.get(ident), []
        while f is not None:
            names.append(f.f_code.co_name)
            f = f.f_back
        untracked.append(" > ".join(reversed(names[-3:])) or "ended")
    rows = [r for r in sampler.trie.rows() if r["stage"] == "dispatch" and r["on"]]
    return {"untracked_threads": untracked,
            "dispatch_on_cpu": sum(r["on"] for r in rows),
            "dispatch_on_cpu_leaf_synchronize": sum(r["on"] for r in rows
                                                    if "synchronize" in r["frames"][-1])}


def await_http(url, timeout=60.0):
    import urllib.request

    deadline = time.monotonic() + timeout
    while True:
        try:
            with urllib.request.urlopen(url, timeout=2) as r:
                return r.status
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)


def console_and_dump(root, npz, server, flight_dir):
    """After the measured run of the ``default`` turn: a second producer CLI
    (default profiler, ``--metrics_port``) fills the queue and is held
    there by backpressure; ``python -m psana_ray_tpu_torch.obs.top --once``
    over the server and that producer, as a child process, must show both
    ``up``, the server's CPU% and BUSY%; then a ``SIGUSR2`` to the server
    must write a flight dump whose ``profile_top`` holds hot frames."""
    import json as _json
    import signal

    mport = free_port()
    held = ProducerCLI(root, npz, server.address, "--metrics_port", str(mport))
    try:
        await_http(f"http://127.0.0.1:{mport}/federate")
        peers = [f"127.0.0.1:{server.port}", f"http://127.0.0.1:{mport}"]
        top = subprocess.run(cli_cmd("psana_ray_tpu_torch.obs.top", "--peers", ",".join(peers),
                                     "--once", "--settle", "0.5"),
                             cwd=root, env={**os.environ, "PYTHONPATH": root},
                             capture_output=True, text=True, timeout=120)
        t0 = time.monotonic()
        server.proc.send_signal(signal.SIGUSR2)
        dump = None
        while dump is None and time.monotonic() - t0 < 15.0:
            names = sorted(os.listdir(flight_dir)) if os.path.isdir(flight_dir) else []
            for name in names:
                if name.endswith(".json"):
                    doc = _json.loads(open(os.path.join(flight_dir, name)).read())
                    if doc["reason"] == "signal":
                        dump = doc
            time.sleep(0.05)
        dump_s = time.monotonic() - t0
    finally:
        held.proc.kill()
        held.wait(timeout=30)
    lines = top.stdout.splitlines()
    if top.returncode != 0 or imported_roots(top.stderr) & {"torch", "jax"}:
        raise AssertionError(f"obs.top exit {top.returncode}: {top.stderr[-2000:]}")
    head = next(ln for ln in lines if ln.startswith("PEER")).split()
    rows = {ln.split()[0]: ln.split() for ln in lines if ln.split() and ln.split()[0] in peers}
    srv = rows.get(peers[0])
    if (set(rows) != set(peers) or any(r[1] != "up" for r in rows.values())
            or srv[head.index("CPU%")] == "-" or srv[head.index("BUSY%")] == "-"):
        raise AssertionError(f"the console lacks a row, a state or a column:\n{top.stdout}")
    top_doc = (dump or {}).get("profile_top") or {}
    if dump is None or not top_doc.get("hot"):
        raise AssertionError(f"the server's SIGUSR2 dump lacks profile_top: {top_doc}")
    return {"console": top.stdout, "dump_after_s": dump_s,
            "dump_profile_top": {"samples": top_doc["samples"], "on_cpu": top_doc["on_cpu"],
                                 "hot": top_doc["hot"][:5],
                                 "stage_cpu_ms": top_doc["stage_cpu_ms"]}}


def spooled_merge(pt, prof_dir, trace_dir, out_path):
    """Turn 3's spools: each process's present, loaded by both of the port's
    ``load_spool`` s with samples, its sampled on-CPU seconds beside its
    CPU seconds from ``os.times``; then ``prof_merge`` over them and the
    trace spools, written to ``out_path``: its process rows, frame spans
    and bytes."""
    import json as _json

    from psana_ray_tpu_torch.obs import prof_merge
    from psana_ray_tpu_torch.obs.profiling import export

    spools = {}
    for name in sorted(os.listdir(prof_dir)):
        path = os.path.join(prof_dir, name)
        doc = export.load_spool(path)
        if prof_merge.load_spool(path)["totals"] != doc["totals"] or doc["totals"]["samples"] <= 0:
            raise AssertionError(f"{name}: a spool the merge reads otherwise, or no samples")
        series = doc["cpu_series"]
        spools[name.split("-")[0]] = {
            "bytes": os.path.getsize(path), "totals": doc["totals"],
            "stage_totals": doc["stage_totals"],
            # the sampler's on-CPU seconds against the process's CPU seconds
            # from os.times over the same ticks (cpu_frac x each tick's span)
            "on_cpu_s_sampled": doc["totals"]["on_cpu"] / doc["meta"]["hz"],
            "cpu_s_os_times": sum(v * (t - t0) for (t0, _), (t, v) in zip(series, series[1:]))}
    if sorted(spools) != sorted(PROF_PROCESSES):
        raise AssertionError(f"spools {sorted(spools)}, expected {PROF_PROCESSES}")
    t0 = time.perf_counter()
    doc = prof_merge.merge([prof_dir], trace_inputs=[trace_dir])
    merge_s = time.perf_counter() - t0
    with open(out_path, "w") as f:
        _json.dump(doc, f)
    frames = [e for e in doc["traceEvents"] if e.get("cat") == "frame"]
    procs = sorted(p["process"].split(":")[0] for p in doc["profile"]["processes"])
    traced = {e["args"]["trace_id"] for e in frames}
    if procs != sorted(PROF_PROCESSES) or len(traced) != OBS_FRAMES:
        raise AssertionError(f"the merged profile holds {procs} and {len(traced)} traced frames")
    return spools, {"rows": len(procs), "spans": len(frames),
                    "counters": sum(e.get("ph") == "C" for e in doc["traceEvents"]),
                    "bytes": os.path.getsize(out_path), "merge_s": merge_s,
                    "hot": doc["profile"]["hot"][:5]}


def profiled_turn(torch, pt, step, device, root, npz, work, tag, hz, spooled, durable):
    """One turn of ``profiled_end_to_end``: a queue server CLI, the producer
    CLI replaying ``npz`` with ``--metrics_port`` and this process serving
    the ResNet path over ``tcp://``, a ``ClusterCollector`` polling the
    server over 'N' and the producer's ``/federate``. ``hz`` is the CLIs'
    ``--profile_hz`` (None: their default, and a sampler here); ``spooled``
    adds ``--profile_dir`` and ``--trace_dir --trace_sample 1`` to all three
    processes; ``durable`` serves from a ``--workers 1 --durable_dir``
    server."""
    import argparse
    import json as _json

    from psana_ray_tpu_torch.obs import profiling as prof
    from psana_ray_tpu_torch.obs.collector import ClusterCollector
    from psana_ray_tpu_torch.obs.tracing import TRACER, configure_from_args, exchange_anchors

    turn_dir = os.path.join(work, tag)
    prof_dir, trace_dir = os.path.join(turn_dir, "prof"), os.path.join(turn_dir, "trace")
    flight_dir = os.path.join(turn_dir, "flight")
    mport = free_port()
    both = [] if hz is None else ["--profile_hz", hz]
    if spooled:
        both += ["--profile_dir", prof_dir, "--trace_dir", trace_dir, "--trace_sample", "1"]
    srv_args = ["--queue_size", str(TCP_QUEUE_SIZE), "--log_level", "WARNING", *both]
    if tag == "default":
        srv_args += ["--flight_dir", flight_dir]
    if durable:
        d, _ = durable_dir(root, "profiled", TCP_QUEUE_SIZE + DURABLE_RETAIN + 2)
        srv_args += ["--workers", "1", "--durable_dir", d]
    server = QueueServerCLI(root, *srv_args)
    config = pt.TransportConfig(address=server.address, queue_size=TCP_QUEUE_SIZE,
                                queue_name=OBS_QUEUE)
    peers = [f"127.0.0.1:{server.port}", f"http://127.0.0.1:{mport}"]
    collector = ClusterCollector(peers, interval_s=PROF_POLL_S, register=False)
    metrics = pt.PipelineMetrics(warmup=1)
    producer = client = monitor = sampler = None
    last, result = {}, {"tag": tag}

    def on_result(out, batch):
        last["out"], last["frames"], last["event_idx"] = out, batch.frames, batch.event_idx

    try:
        monitor = pt.open_queue(config, role="consumer")  # creates the queue, 40 frames
        client = pt.open_queue(config, role="consumer")
        if spooled:
            configure_from_args(argparse.Namespace(trace_dir=trace_dir, trace_sample=1,
                                                   flight_dir=None), "serving")
            exchange_anchors(monitor)
        if hz is None:
            sampler = prof.start_default_profiler(
                spool_dir=prof_dir if spooled else None, process="serving",
                frames_fn=lambda: metrics.staged_frames, bytes_fn=prof.wire_bytes)
        client.stream_open(TCP_STREAM_WINDOW)
        pt.reset_counters()
        collector.start()
        producer = ProducerCLI(root, npz, server.address, "--metrics_port", str(mport), *both)
        pipe = pt.InfeedPipeline(client, batch_size=BATCH, device=device,
                                 prefetch_depth=PREFETCH_DEPTH, batcher_buffers=BUFFERS,
                                 max_wait_s=60.0, metrics=metrics)
        t0 = time.monotonic()
        seen = pipe.run(step, on_result=on_result, block_until_ready=True)
        result["wall_s"] = time.monotonic() - t0
        counts = pt.counts()
        code, out = producer.wait()
        producer = None
        collector.stop()
        collector.poll_once()  # the server, after the run
        if sampler is not None:
            result["serving_threads"] = serving_threads(sampler)
            result["serving"] = prof_view(prof.profile_summary(), OBS_FRAMES)
            prof.stop_default_profiler()  # writes the spool when spooled
            sampler = None
        if tag == "default":
            result.update(console_and_dump(root, npz, server, flight_dir))
        stats = monitor.stats()
    finally:
        collector.stop()
        if sampler is not None:
            prof.stop_default_profiler()
        if spooled:
            TRACER.close()
        for c in (client, monitor):
            if c is not None:
                c.disconnect()
        if producer is not None:
            producer.proc.kill()
            producer.wait(timeout=30)
        srv_code, srv_out = server.stop()
        if durable:
            import shutil

            shutil.rmtree(d, ignore_errors=True)
    roots = (imported_roots(out) | imported_roots(srv_out)) & {"torch", "jax"}
    if seen != OBS_FRAMES or code != 0 or srv_code != 0 or roots:
        raise AssertionError(f"{tag}: consumed {seen} of {OBS_FRAMES}, producer exit {code}, "
                             f"server exit {srv_code}, imported {roots}: {out[-1500:]} "
                             f"{srv_out[-1500:]}")
    check_resnet_counts(counts, OBS_FRAMES // BATCH)
    states = {p.label: p for p in collector.peers()}
    srv_store, prod_store = collector.store(peers[0]), collector.store(peers[1])
    ev = {k: srv_store.last(f"evloop.{k}") for k in ("busy_frac", "busy_frac_ewma",
                                                     "dispatch_ms_ewma", "dispatch_ms_max",
                                                     "loops_total")}
    srv_frames = srv_store.last(f"queue_server.default/{OBS_QUEUE}.puts")
    summary = metrics.summary()
    result.update(
        fps=summary["fps"], frames=OBS_FRAMES, p50_batch_ms=summary["p50_ms"],
        host_batch_ms=summary["host_batch_ms"], launches=counts,
        server_queue={k: stats.get(k) for k in ("puts", "gets", "high_water")},
        queue_server=prof_view(states[peers[0]].profile, srv_frames),
        producer=prof_view(states[peers[1]].profile, prod_store.last("producer.frames_total")),
        server_worker=states[peers[0]].worker, evloop=ev,
        # the loop's dispatch a frame, two ways: the passes' EWMA times their
        # count, and the dispatch stage's on-CPU ms from the profiler
        evloop_dispatch_ms_per_frame=(ev["dispatch_ms_ewma"] * ev["loops_total"] / srv_frames
                                      if srv_frames and ev["loops_total"] else None),
        collector=collector.snapshot())
    if hz is None:
        if srv_store.last("prof.cpu_frac") is None or ev["busy_frac"] is None:
            raise AssertionError(f"{tag}: the collector's store of the server lacks prof.cpu_frac "
                                 f"or evloop.busy_frac: {sorted(srv_store.keys())[:60]}")
        for name in ("queue_server", "producer", "serving"):
            if result.get(name) is None:
                raise AssertionError(f"{tag}: no profile of the {name} process")
        attributed = result["queue_server"]["attributed"]
        if not durable and not attributed >= PROF_ATTRIBUTED:
            raise AssertionError(f"{tag}: {attributed} of the server's on-CPU samples billed "
                                 f"to known stages, below {PROF_ATTRIBUTED}")
    if spooled:
        result["spools"], result["merged"] = spooled_merge(
            pt, prof_dir, trace_dir, os.path.join(turn_dir, "merged_prof.json"))
        result["spool_bytes"] = {k: v["bytes"] for k, v in result["spools"].items()}
        srv_totals = result["spools"]["queue_server"]["stage_totals"]
        on = sum(t["on"] for t in srv_totals.values())
        result["queue_server_spool_attributed"] = (
            1.0 - srv_totals.get("untagged", {"on": 0})["on"] / on if on else None)
        if not result["queue_server_spool_attributed"] >= PROF_ATTRIBUTED:
            raise AssertionError(f"{tag}: the server's spool bills "
                                 f"{result['queue_server_spool_attributed']} to known stages")
    return result, last, counts


def phase_profiled_end_to_end(torch, pt, pool, consts, model, params, device, root):
    """Config 4 at full width (batch 32, ResNet-50 at width 64, K1–K3) from
    the producer CLI through the queue server CLI over ``tcp://127.0.0.1``
    to the serving pipeline here, in four turns of ``OBS_FRAMES`` frames:
    the profiler off everywhere, at its default 97 Hz in all three
    processes, with spools and every frame traced, and the default through
    a durable ``--workers 1`` server. Returns the turns' launch counts,
    summed."""
    import shutil

    step = make_step(torch, pt, consts, params)
    npz = observed_npz(root, pool)
    work = os.path.join(root, "build", "chip_smoke", f"profiled_{os.getpid()}")
    t_phase = time.monotonic()
    turns, lasts, total = {}, {}, {}
    try:
        for tag, hz, spooled, durable in PROF_TURNS:
            turns[tag], lasts[tag], counts = profiled_turn(torch, pt, step, device, root, npz,
                                                           work, tag, hz, spooled, durable)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    finally:
        os.remove(npz)
        shutil.rmtree(work, ignore_errors=True)
    base = lasts["off"]
    for tag, last in lasts.items():
        turns[tag].update(check_resnet_result(torch, pt, model, consts, last))
        if not torch.equal(last["event_idx"], base["event_idx"]):
            raise AssertionError(f"{tag}: the last batch holds other events than turn off's")
        diff = float((last["out"][0].float() - base["out"][0].float()).abs().max())
        turns[tag]["logits_max_abs_diff_vs_off"] = diff
        if diff > OBS_LOGIT_TOL:
            raise AssertionError(f"{tag}: logits differ from the unprofiled turn's by {diff}")
    emit("profiled_end_to_end", frames_per_turn=OBS_FRAMES, batch=BATCH,
         queue_size=TCP_QUEUE_SIZE, stream_window=TCP_STREAM_WINDOW,
         fps={tag: turns[tag]["fps"] for tag in turns},
         fps_ratio_vs_off={tag: turns[tag]["fps"] / turns["off"]["fps"] for tag in turns},
         turns=turns, phase_s=time.monotonic() - t_phase)
    return total


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


def flash_cost(bh: int, sq: int, sk: int, d: int = 128, causal: bool = False, elem: int = 2):
    """(bytes, ops) of K5: q, k, v read once and o (``elem`` bytes each:
    2 bf16, 4 f32) and lse (f32) written once; two products of 2*d
    operations per (query, key) pair: the function's work, not the
    D/128-fold recompute of s in the wide and f32 kernels."""
    nbytes = bh * (elem * sq * d + 2 * elem * sk * d + elem * sq * d + 4 * sq)
    return nbytes, 2.0 * 2 * d * bh * _flash_pairs(sq, sk, causal)


def issued_over_work(torch, tf, kernel: str, dtype, launch, ops: float):
    """The tensor-core operations one ``launch()`` of ``kernel`` (on
    operands of ``dtype``) issues over the function's ``ops``, read from
    the kernel's counting build
    (``build.counting``: every ``wgmma`` it runs adds 2 M N K to a device
    counter, so the loops it takes and the tiles it visits count, and a
    score tile formed twice counts twice). None for a kernel without one
    (the f32 pair, on ``mma.sync``). Above 1: the masked part of the causal
    diagonal's tiles, or products formed more than once."""
    from psana_ray_tpu_torch.kernels import build

    lib = tf.kernel_library(kernel, dtype)
    if lib not in build.COUNTED:
        return None
    with build.counting(lib) as take:
        launch()
        torch.cuda.synchronize()
        return take() / ops


def sdpa_backend(torch, q, k, v, causal):
    """The backend ``F.scaled_dot_product_attention`` picks for these
    inputs (its own dispatch, ``torch._fused_sdp_choice``), or None."""
    try:
        from torch.nn.attention import SDPBackend

        return SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=causal)).name
    except Exception:  # the query is private: its absence only loses the label
        return None


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


def flash_ok(errs, tol=FLASH_TOL) -> bool:
    return all(errs[key] <= tol[key] for key in tol)


def _dtype(torch, name):
    return {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}[name]


def tf32_once(torch, tf, plain, *args):
    """A plain attention function (``tf.attention_with_stats_plain`` or
    ``tf.attention_bwd_plain``) with each of its f32 matrix products as one
    TF32 pass (``torch.matmul`` under ``allow_tf32``): the control that the
    f32 kernels' three-product split must beat. A yardstick only: the
    port never runs it."""
    import contextlib

    @contextlib.contextmanager
    def one_pass():
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    full = tf._full_f32_matmul
    tf._full_f32_matmul = one_pass
    try:
        return plain(*args)
    finally:
        tf._full_f32_matmul = full


def flash_case(torch, F, tf, timer, gen, device, name, dtype, d, b, h, sq, sk, causal, iters):
    """One K5 case: the forward kernel for (dtype, head dim) against its
    plain version, the two controls rejected (three in f32: one TF32 pass
    too), both timers, the plain version, SDPA at the same dtype (and the
    backend it picked), the bound. bf16 and f16 are held alike."""
    half = dtype != "f32"
    tol = FLASH_TOL if half else FLASH_TOL_F32

    def mk(s):
        return torch.randn((b, h, s, d), generator=gen, device=device).to(_dtype(torch, dtype))

    q, k, v = mk(sq), mk(sk), mk(sk)
    o, lse = tf.launch_flash(q, k, v, causal)
    o_ref, lse_ref = tf.attention_with_stats_plain(q, k, v, causal)
    o_flat, lse_flat = flat_attention(torch, v, sq, causal)
    torch.cuda.synchronize()
    errs = flash_errors(o, lse, o_ref, lse_ref, lse_flat)
    kernel = tf.forward_kernel(q)
    if (not flash_ok(errs, tol) or not torch.isfinite(o.float()).all()
            or not torch.isfinite(lse).all()):
        raise AssertionError(f"{kernel} ({name}, {dtype}, D {d}) disagrees with its plain "
                             f"version: {errs}")
    controls = {"zeros": flash_errors(torch.zeros_like(o), torch.zeros_like(lse), o_ref,
                                      lse_ref, lse_flat),
                "flat": flash_errors(o_flat, lse_flat, o_ref, lse_ref, lse_flat)}
    if not half:
        controls["tf32_once"] = flash_errors(
            *tf32_once(torch, tf, tf.attention_with_stats_plain, q, k, v, causal), o_ref, lse_ref,
            lse_flat)
    passed = [c for c, e in controls.items() if flash_ok(e, tol)]
    if passed:
        raise AssertionError(f"{kernel} ({name}, {dtype}, D {d}): the check passes the "
                             f"{passed} control(s): {controls}")
    # the repeat check: a second launch gives the same o and lse bit for bit
    again = tf.launch_flash(q, k, v, causal)
    torch.cuda.synchronize()
    repeat = {"o_equal": bool(torch.equal(o, again[0])), "lse_equal": bool(torch.equal(lse, again[1]))}
    if not all(repeat.values()):
        raise AssertionError(f"{kernel} ({name}, {dtype}, D {d}): two launches disagree: {repeat}")
    del o, o_ref, lse, lse_ref, o_flat, lse_flat, again
    nbytes, ops = flash_cost(b * h, sq, sk, d, causal, elem=2 if half else 4)
    issued = issued_over_work(torch, tf, kernel, q.dtype, lambda: tf.launch_flash(q, k, v, causal),
                              ops)
    if issued is not None and not causal and issued > ISSUED_TOL:
        raise AssertionError(f"{kernel} ({name}, {dtype}, D {d}) issues {issued:.3f} of the "
                             f"function's tensor-core work")
    bms, by = bound_ms(nbytes, ops, BF16_OPS_PER_S if half else F32_SPLIT_OPS_PER_S)
    row = {
        "case": name, "dtype": dtype, "head_dim": d, "kernel": kernel,
        "launches_a_call": len(tf._bh_slices(b * h)),
        "shape_q": [b, h, sq, d], "sk": sk, "causal": causal,
        "max_abs_err_o": errs["o"], "max_abs_err_lse": errs["lse"],
        "rel_err_o": errs["o_rel"], "rel_err_lse": errs["lse_rel"], "controls": controls,
        "repeat": repeat, "issued_over_work": issued,
        "ms": timer.ms(lambda: tf.launch_flash(q, k, v, causal), iters=iters),
        "ms_cold": timer.ms_cold(lambda: tf.launch_flash(q, k, v, causal), iters=iters),
        "plain_ms": timer.ms(lambda: tf.attention_with_stats_plain(q, k, v, causal),
                             iters=3, warmup=1),
        "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
                               iters=iters),
        "library_backend": sdpa_backend(torch, q, k, v, causal),
        "bound_ms": bms, "bound_by": by, "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
    }
    if not half:  # the bound before the split: f32 on the CUDA cores
        row["bound_ms_cuda_cores"] = bound_ms(nbytes, ops, F32_OPS_PER_S)[0]
    row["tflops"] = ops / row["ms"] / 1e9
    return row


def xla_route_case(torch, F, tf, timer, gen, device, name, dtype, d, b, h, sq, sk, causal,
                   backward=False):
    """One shape the reference's gate refuses, on the card: forward (and,
    with ``backward``, the gradient with an lse cotangent) through
    ``attention_with_stats``, which takes the XLA route: no kernel launch,
    one route call a direction, and the plain versions' results bit for
    bit (the route is the plain formulation). Times: the route, SDPA at the
    same dtype (its forward, or its backward from a saved forward) and the
    bound of the function's work."""
    from psana_ray_tpu_torch import kernels

    def mk(*shape):
        return torch.randn(shape, generator=gen, device=device)

    q, k, v, do = (mk(b, h, s_, d).to(_dtype(torch, dtype)) for s_ in (sq, sk, sk, sq))
    dlse = mk(b, h, sq)
    if tf.attention_route(q.shape, k.shape) != "xla":
        raise AssertionError(f"{name}: the gate takes {tuple(q.shape)}; not an XLA-route case")
    leaves = [t.clone().requires_grad_(backward) for t in (q, k, v)]
    kernels.reset_counters()
    o, lse = tf.attention_with_stats(*leaves, causal=causal)
    if backward:
        torch.autograd.backward((o, lse), (do, dlse))
    torch.cuda.synchronize()
    counts, routes, variants = kernels.counts(), kernels.route_counts(), kernels.variant_counts()
    o, lse = o.detach(), lse.detach()
    o_ref, lse_ref = tf.attention_with_stats_plain(q, k, v, causal)
    same = {"o": bool(torch.equal(o, o_ref)), "lse": bool(torch.equal(lse, lse_ref))}
    key = tf.KERNEL_DTYPES[q.dtype]
    want_routes = {"attention_xla_route": 1, "attention_bwd_xla_route": int(backward)}
    want_v = {("attention_xla_route", key, d): 1}
    if backward:
        ref = tf.attention_bwd_plain(q, k, v, o, lse, do, causal, dlse)
        same.update({n: bool(torch.equal(t.grad, r)) for n, t, r in zip(("dq", "dk", "dv"), leaves,
                                                                        ref)})
        want_v[("attention_bwd_xla_route", key, d)] = 1
    if sum(counts.values()) or routes != want_routes or variants != want_v or not all(same.values()):
        raise AssertionError(f"{name}: the XLA route launched {counts}, counted {routes} "
                             f"{variants}, or differs from the plain version: {same}")
    if backward:
        nbytes, ops, _ = flash_bwd_cost(b * h, sq, sk, d, causal)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        route_ms = timer.ms(lambda: tf.attention_bwd_plain(q, k, v, o, lse, do, causal, dlse),
                            iters=3, warmup=1)
        library_ms = timer.ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                              iters=3, warmup=1)
    else:
        nbytes, ops = flash_cost(b * h, sq, sk, d, causal)
        route_ms = timer.ms(lambda: tf.attention_with_stats(q, k, v, causal), iters=3, warmup=1)
        library_ms = timer.ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
                              iters=3, warmup=1)
    bms, by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
    return {"case": name, "dtype": dtype, "head_dim": d, "route": "xla",
            "shape_q": [b, h, sq, d], "sk": sk, "causal": causal, "launches": counts,
            "route_calls": routes, "plain_bit_for_bit": same, "route_ms": route_ms,
            "library_ms": library_ms, "library_backend": sdpa_backend(torch, q, k, v, causal),
            "bound_ms": bms, "bound_by": by, "gflop": ops / 1e9, "mbytes": nbytes / 1e6}


def phase_flash(torch, F, tf, timer, device):
    """K5 against its plain version in each case of ``FLASH_CASES`` (bf16,
    head dim 128: ``flash_kernel``) and of ``VARIANT_CASES`` (the wide and
    f32 kernels, the f16 builds, more than 65535 batch x heads), and two
    controls that the same check must reject; then the XLA route in each
    case of ``XLA_CASES``. Results by case name, the variants' and the
    route's as ``case/dtype/head dim``."""
    gen = torch.Generator(device=device).manual_seed(0)
    results = {}
    cases = [(name, "bf16", 128, b, h, sq, sk, causal, 10)
             for name, b, h, sq, sk, causal in FLASH_CASES]
    cases += [(*c, VARIANT_ITERS) for c in VARIANT_CASES]
    for i, (name, dtype, d, b, h, sq, sk, causal, iters) in enumerate(cases):
        row = flash_case(torch, F, tf, timer, gen, device, name, dtype, d, b, h, sq, sk, causal,
                         iters)
        emit("flash_kernel", **row)
        results[name if i < len(FLASH_CASES) else f"{name}/{dtype}/{d}"] = row
    for name, dtype, d, b, h, sq, sk, causal in XLA_CASES:
        row = xla_route_case(torch, F, tf, timer, gen, device, name, dtype, d, b, h, sq, sk, causal)
        emit("flash_xla_route", **row)
        results[f"{name}/{dtype}/{d}"] = row
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


def flash_bwd_cost(bh: int, sq: int, sk: int, d: int = 128, causal: bool = False, elem: int = 2):
    """(bytes, ops, ops_7) of the backward: q, k, v and do (``elem`` bytes
    each) and lse and delta (f32) read once, dq, dk and dv written once; five
    products of 2*d operations per (query, key) pair (s, dp, dv, dk, dq),
    what the function needs and ``flash_bwd_kernel`` does, and ``ops_7``
    for the seven of a two-kernel design that computes s and dp twice (the
    TPU kernels' split, ``flash.py:284-287``)."""
    t_q, t_k = elem * bh * sq * d, elem * bh * sk * d
    nbytes = 2 * t_q + 2 * t_k + 2 * 4 * bh * sq + t_q + 2 * t_k
    ops = 2.0 * d * bh * _flash_pairs(sq, sk, causal)
    return nbytes, 5 * ops, 7 * ops


def bwd_errors(got, ref) -> dict:
    """``max|g - g_ref| / max|g_ref|`` of each of dq, dk, dv."""
    return {n: rel_err(r, g) for n, g, r in zip(("dq", "dk", "dv"), got, ref)}


def bwd_ok(errs, tol=BWD_TOL) -> bool:
    return all(errs[n] <= tol for n in ("dq", "dk", "dv"))


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


def flash_bwd_case(torch, F, tf, timer, gen, device, name, dtype, d, b, h, sq, sk, causal,
                   with_dlse, iters, full=True):
    """One K6/K7 case: the backward kernel for (dtype, head dim) against
    ``attention_bwd_plain``, two controls that the same check must reject
    (three in f32: the plain backward as one TF32 pass too),
    a repeat launch, the timers, the plain version and the bound; with
    ``full``, the errors of a backward that drops delta or ignores dlse
    (printed) and SDPA's backward at the same dtype. bf16 and f16 are held
    alike. Tensors are freed as soon as their check is done (the f32 case
    at 65,664 batch x heads holds 4.3 GB a tensor)."""
    half = dtype != "f32"
    tol = BWD_TOL if half else BWD_TOL_F32

    def mk(*shape):
        return torch.randn(shape, generator=gen, device=device)

    q, k, v, do = (mk(b, h, s_, d).to(_dtype(torch, dtype)) for s_ in (sq, sk, sk, sq))
    dlse = mk(b, h, sq) if with_dlse else None
    o, lse = tf.launch_flash(q, k, v, causal)
    got = tf.launch_flash_bwd(q, k, v, o, lse, do, causal, dlse)
    ref = tf.attention_bwd_plain(q, k, v, o, lse, do, causal, dlse)
    torch.cuda.synchronize()
    kernel = tf.backward_kernel(q)
    errs = bwd_errors(got, ref)
    abs_err = {n: float((g.float() - r.float()).abs().max())
               for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
    if not bwd_ok(errs, tol) or not all(bool(torch.isfinite(g.float()).all()) for g in got):
        raise AssertionError(f"{kernel} ({name}, {dtype}, D {d}) disagrees with its plain "
                             f"version: {errs}")
    controls = {"zeros": bwd_errors((torch.zeros_like(g) for g in got), ref),
                "flat": bwd_errors(flat_attention_bwd(torch, do, sk, causal), ref)}
    if not half:
        controls["tf32_once"] = bwd_errors(
            tf32_once(torch, tf, tf.attention_bwd_plain, q, k, v, o, lse, do, causal, dlse), ref)
    passed = [c for c, e in controls.items() if bwd_ok(e, tol)]
    if passed:
        raise AssertionError(f"{kernel} ({name}, {dtype}, D {d}): the check passes the "
                             f"{passed} control(s): {controls}")
    sens = {}
    if full:
        sens["drop_delta"] = bwd_errors(
            tf.attention_bwd_plain(q, k, v, torch.zeros_like(o), lse, do, causal), ref)
        if with_dlse:
            sens["ignore_dlse"] = bwd_errors(tf.attention_bwd_plain(q, k, v, o, lse, do, causal),
                                             ref)
    for e in sens.values():
        e["rejected"] = not bwd_ok(e, tol)
    dq_ulp = 2.0 ** (-8 if half else -16) * float(ref[0].float().abs().max())
    del ref
    # the repeat check: dk and dv identical; dq's f32 sums arrive in
    # another order each run, so two launches' f32 dq_acc (before the
    # rounding; dq itself in f32) agree within 2**-16 of its largest value,
    # and the head-dim-128 kernel's rounded dq (bf16 or f16) within 2**-8
    # of the reference's largest value (2**-16 in f32)
    delta = tf.flash_bwd_delta(o, do, dlse)
    accs, same_dk, same_dv = [], True, True
    for _ in range(2):
        acc, dk_, dv_ = tf.launch_flash_bwd_kernel(q, k, v, do, lse, delta, causal)
        same_dk &= bool(torch.equal(got[1], dk_))
        same_dv &= bool(torch.equal(got[2], dv_))
        accs.append(acc)
        del dk_, dv_
    again = tf.launch_flash_bwd(q, k, v, o, lse, do, causal, dlse)
    torch.cuda.synchronize()
    acc_scale = float(accs[0].abs().max())
    repeat = {"dk_equal": same_dk and bool(torch.equal(got[1], again[1])),
              "dv_equal": same_dv and bool(torch.equal(got[2], again[2])),
              "dq_acc_max_diff": float((accs[0] - accs[1]).abs().max()),
              "dq_acc_tol": 2.0 ** -16 * acc_scale,
              "dq_max_diff": float((got[0].float() - again[0].float()).abs().max()),
              "dq_ulp": dq_ulp}
    dq_gated = kernel != "flash_bwd_wide_kernel"  # its rounded dq: the dq_acc check above
    if not (repeat["dk_equal"] and repeat["dv_equal"] and acc_scale > 0.0
            and repeat["dq_acc_max_diff"] <= repeat["dq_acc_tol"]
            and (not dq_gated or repeat["dq_max_diff"] <= repeat["dq_ulp"])):
        raise AssertionError(f"{kernel} ({name}, {dtype}, D {d}): two launches disagree: "
                             f"{repeat}")
    del got, again, accs
    nbytes, ops, ops7 = flash_bwd_cost(b * h, sq, sk, d, causal, elem=2 if half else 4)
    issued = issued_over_work(
        torch, tf, kernel, q.dtype,
        lambda: tf.launch_flash_bwd_kernel(q, k, v, do, lse, delta, causal), ops)
    if issued is not None and not causal and issued > ISSUED_TOL:
        raise AssertionError(f"{kernel} ({name}, {dtype}, D {d}) issues {issued:.3f} of the "
                             f"function's tensor-core work")
    peak = BF16_OPS_PER_S if half else F32_SPLIT_OPS_PER_S
    bms, by = bound_ms(nbytes, ops, peak)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=device)

    def pair():  # what the backward launches: dq_acc zeroed, the kernel, the dq rounding (16-bit)
        acc = tf.launch_flash_bwd_kernel(q, k, v, do, lse, delta, causal)[0]
        return tf.launch_flash_bwd_dq_convert(acc, q.dtype) if half else acc

    ms = timer.ms(pair, iters=iters)
    row = {"case": name, "dtype": dtype, "head_dim": d, "kernel": kernel,
           "launches_a_call": len(tf._bh_slices(b * h)),
           "shape_q": [b, h, sq, d], "sk": sk, "causal": causal,
           "dlse": with_dlse, "rel_err": errs, "max_abs_err": abs_err, "controls": controls,
           "sensitivity": sens, "repeat": repeat, "issued_over_work": issued,
           "ms": ms, "ms_cold": timer.ms_cold(pair, iters=iters),
           # the kernel alone (adding into a dq_acc that is not re-zeroed) and the rounding alone
           "kernel_ms": timer.ms(
               lambda: tf.launch_flash_bwd_kernel(q, k, v, do, lse, delta, causal, dq_acc),
               iters=iters),
           "convert_ms": (timer.ms(lambda: tf.launch_flash_bwd_dq_convert(dq_acc, q.dtype),
                                   iters=iters) if half else None),
           "bound_ms": bms, "bound_by": by, "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
           "tflops": ops / ms / 1e9,
           "bound_ms_7_products": bound_ms(nbytes, ops7, peak)[0],
           "library_backend": sdpa_backend(torch, q, k, v, causal)}
    if not half:  # the bound before the split: f32 on the CUDA cores
        row["bound_ms_cuda_cores"] = bound_ms(nbytes, ops, F32_OPS_PER_S)[0]
    del dq_acc
    # the plain version computes dq, dk and dv in one call
    row["plain_ms"] = timer.ms(lambda: tf.attention_bwd_plain(q, k, v, o, lse, do, causal, dlse),
                               iters=3, warmup=1)
    row["library_ms"] = None
    if full:
        # the library yardstick, never called by the port: the backward of
        # F.scaled_dot_product_attention from a saved forward (dq, dk, dv)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        row["library_ms"] = timer.ms(
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), iters=iters)
    return row


def phase_flash_bwd(torch, F, tf, timer, device):
    """K6/K7 (the backward kernel for each dtype and head dim) against
    ``attention_bwd_plain`` in each case of ``BWD_CASES`` (bf16, head dim
    128: ``flash_bwd_kernel``) and of ``VARIANT_CASES`` with an lse
    cotangent (the wide and f32 kernels, the f16 builds, more than 65535
    batch x heads: there without the printed sensitivities and the SDPA
    yardstick, whose f32 tensors beside the case's would pass the card's
    80 GB); then the XLA route's
    backward in each case of ``XLA_CASES``. Results by case name, the
    variants' and the route's as ``case/dtype/head dim``."""
    gen = torch.Generator(device=device).manual_seed(1)
    results = {}
    cases = [(name, "bf16", 128, b, h, sq, sk, causal, with_dlse, 10)
             for name, b, h, sq, sk, causal, with_dlse in BWD_CASES]
    cases += [(*c, True, VARIANT_ITERS) for c in VARIANT_CASES]
    for i, (name, dtype, d, b, h, sq, sk, causal, with_dlse, iters) in enumerate(cases):
        row = flash_bwd_case(torch, F, tf, timer, gen, device, name, dtype, d, b, h, sq, sk,
                             causal, with_dlse, iters, full=not name.startswith("bh_"))
        emit("flash_bwd", **row)
        results[name if i < len(BWD_CASES) else f"{name}/{dtype}/{d}"] = row
    for name, dtype, d, b, h, sq, sk, causal in XLA_CASES:
        row = xla_route_case(torch, F, tf, timer, gen, device, name, dtype, d, b, h, sq, sk, causal,
                             backward=True)
        emit("flash_bwd_xla_route", **row)
        results[f"{name}/{dtype}/{d}"] = row
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


def variant_sum(variants, kernel, dtype=None) -> int:
    """Launches of ``kernel`` (in ``dtype``, or any) in a
    ``pt.variant_counts()`` tally."""
    return sum(n for (name, dt, _), n in variants.items()
               if name == kernel and dtype in (None, dt))


def add_counts(*tallies) -> dict:
    out = {}
    for tally in tallies:
        for key, n in tally.items():
            out[key] = out.get(key, 0) + n
    return out


def phase_vit_variant(torch, pt, tf, pool, consts, frame_shape, device, phase, dtype_name, heads):
    """The full-width ViT (patch 16, embed 512, depth 4) in ``dtype_name``
    with ``heads`` heads: served through the infeed at batch 2 for
    ``VARIANT_BATCHES`` timed batches (calibration to the model's dtype,
    the forward kernel of its dtype and head dim, every launch counted;
    where the reference's gate refuses the head dim, the XLA route: no
    kernel, every route call counted), the last batch's logits against the
    plain path (``rel_err < 1e-4`` in f32, ``< 0.05`` in bf16 and f16; on
    the XLA route, whose forward is the plain path's, against the same
    weights in f32, ``< 0.05``); then one train step's parity against the
    plain attention, and ``VARIANT_TRAIN_STEPS`` steps at batch 2 of the
    recipe's loss and optimizer. Returns the launch counts and the
    variants' tally of both runs (the route's calls under their own
    names)."""
    import numpy as np

    from psana_ray_tpu_torch.ops.fused_calib import fused_calibrate_plain

    dtype = _dtype(torch, dtype_name)
    f32 = dtype_name == "f32"
    tol = F32_REL_TOL if f32 else REL_TOL
    ped, gain, mask = consts
    params = pt.init_vit_params(frame_shape, seed=0)
    model = pt.vit_from_flax(params, num_heads=heads, dtype=dtype, device=device)
    tokens, width = model.embed.pos_embed.shape[1:]
    d = width // heads
    probe = torch.empty((1, heads, tokens, d), dtype=dtype, device="meta")
    xla = tf.attention_route(probe.shape, probe.shape) == "xla"
    fwd, bwd = (("attention_xla_route", "attention_bwd_xla_route") if xla
                else (tf.forward_kernel(probe), tf.backward_kernel(probe)))

    def plain_attn(q, k, v):
        return tf.attention_with_stats_plain(*(t.transpose(1, 2) for t in (q, k, v)))[0].transpose(1, 2)

    plain = pt.vit_from_flax(params, num_heads=heads, dtype=dtype, attn_fn=plain_attn,
                             device=device)
    step = make_vit_step(torch, pt, consts, model)
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
    pipe, wall = run_pipeline(torch, pt, pool, step, device, VARIANT_BATCHES, on_result,
                              batch=VIT_BATCH)
    serve_counts, serve_variants = pt.counts(), pt.variant_counts()
    serve_routes = pt.route_counts()
    peak_mem = torch.cuda.max_memory_allocated(device) / 2**30
    nb = WARMUP_BATCHES + pipe.metrics.batches.count
    want = {"calib_kernel": nb, **NO_RESNET, "conv_block_kernel": 0,
            "flash_kernel": 0 if xla else VIT_DEPTH * nb, **NO_BWD}
    want_routes = {"attention_xla_route": VIT_DEPTH * nb if xla else 0,
                   "attention_bwd_xla_route": 0}
    if (serve_counts != want or serve_routes != want_routes
            or serve_variants != {(fwd, dtype_name, d): VIT_DEPTH * nb}):
        raise AssertionError(f"{phase}: launch counts {serve_counts} {serve_routes} "
                             f"{serve_variants} over {nb} batches, expected {want} "
                             f"{want_routes} and {VIT_DEPTH * nb} of {fwd}")
    staging = check_staging(pt, pipe.metrics, nb, pool[0].nbytes, pipe.batcher)
    logits = last["out"]
    if tuple(logits.shape) != (VIT_BATCH, 2) or not torch.isfinite(logits).all():
        raise AssertionError(f"{phase}: bad logits {tuple(logits.shape)}")
    with torch.no_grad():
        if xla:  # the plain path is the served one: hold it against f32
            plain = pt.vit_from_flax(params, num_heads=heads, dtype=torch.float32, device=device)
        cal = fused_calibrate_plain(last["frames"], ped, gain, mask, threshold=10.0,
                                    out_dtype=torch.float32 if xla else dtype)
        ref = plain(cal)
    torch.cuda.synchronize()
    err = rel_err(ref, logits)
    if not err < tol:
        raise AssertionError(f"{phase}: logits disagree with the "
                             f"{'f32 model' if xla else 'plain path'}: rel_err {err}")
    summary = pipe.metrics.summary()
    emit(f"{phase}_serve", dtype=dtype_name, heads=heads, head_dim=d, kernel=fwd,
         route="xla" if xla else "kernel", logits_against="f32 model" if xla else "plain path",
         route_calls=serve_routes, batches=nb,
         timed_batches=summary["batches"], frames=summary["frames"], wall_s=wall,
         fps=summary["fps"], p50_batch_ms=summary["p50_ms"], p99_batch_ms=summary["p99_ms"],
         host_batch_ms=summary["host_batch_ms"], host_stage_ms=summary["host_stage_ms"],
         peak_mem_gib=peak_mem, launches=serve_counts,
         variants={"/".join(map(str, k)): n for k, n in serve_variants.items()}, **staging,
         logits_rel_err=err, logits_max_abs=float(ref.abs().max()),
         tokens_per_frame=model.embed.pos_embed.shape[1])
    del plain, ref, cal, pipe, last

    # training at batch 2: the labelled corpus calibrated to the model's dtype
    src = pt.SyntheticSource(num_events=1, detector_name=TRAIN_DETECTOR, seed=7, hit_fraction=0.5)
    frames, labels = pt.raw_hit_batch(src, 0, VARIANT_TRAIN_EVENTS)
    with torch.no_grad():
        xs = [pt.fused_calibrate(torch.from_numpy(frames[i:i + VIT_BATCH]).to(device), ped, gain,
                                 mask, threshold=10.0, out_dtype=dtype)
              for i in range(0, VARIANT_TRAIN_EVENTS, VIT_BATCH)]
    ys = [torch.from_numpy(labels[i:i + VIT_BATCH]).to(device)
          for i in range(0, VARIANT_TRAIN_EVENTS, VIT_BATCH)]
    valid = torch.ones(VIT_BATCH, dtype=torch.uint8, device=device)

    def grads(attn_fn):
        m = pt.vit_from_flax(params, num_heads=heads, dtype=dtype, attn_fn=attn_fn, device=device)
        loss = pt.masked_softmax_xent(m(xs[0]), ys[0], valid)
        loss.backward()
        return float(loss.detach()), {n: p.grad for n, p in m.named_parameters()}

    def compare(ref, got):
        errs = {n: rel_err(ref[n], got[n]) for n in ref}
        worst = max(errs, key=errs.get)
        whole = rel_err(torch.cat([ref[n].flatten() for n in ref]),
                        torch.cat([got[n].flatten() for n in ref]))
        return {"worst_leaf": worst, "worst_rel_err": errs[worst],
                "median_rel_err": float(np.median(list(errs.values()))), "whole_rel_err": whole}

    # the kernel path against the plain path, and (to tell the backward
    # kernel from the forward's rounding) against the kernel forward with
    # the plain backward; on the XLA route both directions are the plain
    # ones, so the path against the plain path alone
    loss_k, g_k = grads(None)
    loss_p, g_p = grads(reference_attention(torch, tf))
    parity = {"loss_kernel": loss_k, "loss_plain": loss_p,
              "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
              "kernel_vs_plain_path": compare(g_p, g_k)}
    if not xla:
        loss_f, g_f = grads(reference_attention(torch, tf, kernel_forward=True))
        parity.update(loss_kernel_forward=loss_f, backward_kernels=compare(g_f, g_k))
        del g_f
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(g).all()) for g in g_k.values())
    # f32: the two paths differ only in the order of their f32 sums
    ok = (parity["kernel_vs_plain_path"]["whole_rel_err"] < F32_REL_TOL
          and parity["loss_rel_err"] < F32_REL_TOL) if f32 else (
        parity["loss_rel_err"] <= REL_TOL
        and parity["kernel_vs_plain_path" if xla else "backward_kernels"]["worst_rel_err"] < REL_TOL)
    if not (ok and finite):
        raise AssertionError(f"{phase}: the train step disagrees with the plain attention: {parity}")
    del g_k, g_p

    model = pt.vit_from_flax(params, num_heads=heads, dtype=dtype, device=device)
    schedule = pt.warmup_cosine_decay_schedule(0.0, 6e-4, 2, VARIANT_TRAIN_STEPS, 1e-5)
    train_step = pt.make_train_step(model, pt.adamw(model.parameters(), schedule, 0.01),
                                    lambda lg, aux: pt.masked_softmax_xent(lg, *aux))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    pt.reset_counters()
    losses, stamps = [], [time.perf_counter()]
    for n in range(VARIANT_TRAIN_STEPS):
        losses.append(float(train_step(xs[n % len(xs)], (ys[n % len(ys)], valid))))
        stamps.append(time.perf_counter())
    train_counts, train_variants = pt.counts(), pt.variant_counts()
    train_routes = pt.route_counts()
    peak_train = torch.cuda.max_memory_allocated(device) / 2**30
    n = VIT_DEPTH * VARIANT_TRAIN_STEPS
    k = 0 if xla else n
    want = {"calib_kernel": 0, **NO_RESNET, "conv_block_kernel": 0, "flash_kernel": k,
            "flash_bwd_kernel": k, "flash_bwd_dq_convert": 0 if f32 else k}
    want_routes = {"attention_xla_route": n - k, "attention_bwd_xla_route": n - k}
    want_v = {(fwd, dtype_name, d): n, (bwd, dtype_name, d): n}
    if not (f32 or xla):
        want_v[("flash_bwd_dq_convert", dtype_name, d)] = n
    if train_counts != want or train_routes != want_routes or train_variants != want_v:
        raise AssertionError(f"{phase}: launch counts {train_counts} {train_routes} "
                             f"{train_variants} over {VARIANT_TRAIN_STEPS} steps, expected "
                             f"{want} {want_routes} {want_v}")
    if not np.all(np.isfinite(losses)) or not all(bool(torch.isfinite(p).all())
                                                  for p in model.parameters()):
        raise AssertionError(f"{phase}: training diverged: losses {losses}")
    step_ms = np.diff(stamps)[1:] * 1e3  # each step synchronised by its loss' float()
    emit(f"{phase}_train", dtype=dtype_name, heads=heads, head_dim=d, kernel=bwd,
         route="xla" if xla else "kernel", route_calls=train_routes, batch=VIT_BATCH,
         steps=VARIANT_TRAIN_STEPS, parity=parity, losses=losses,
         p50_step_ms=float(np.percentile(step_ms, 50)), mean_step_ms=float(step_ms.mean()),
         peak_mem_gib=peak_train, launches=train_counts,
         variants={"/".join(map(str, k)): v for k, v in train_variants.items()})
    return add_counts(serve_counts, train_counts), add_counts(serve_variants, train_variants)


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


# -- phases 6c, 6d, 6f and 17e: the producer and consumer programs -----------


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


def phase_lint(root):
    """Phase 1b: the linter over the port's tree and its protocol models,
    each in a child process that must import neither torch nor JAX."""
    def run(*args):
        t0 = time.monotonic()
        out = subprocess.run([sys.executable, "-X", "importtime", "-m", "psana_ray_tpu_torch.lint",
                              *args], cwd=root, capture_output=True, text=True, timeout=300)
        wall = time.monotonic() - t0
        heavy = imported_roots(out.stderr) & {"torch", "jax", "jaxlib", "psana_ray_tpu"}
        if out.returncode != 0 or heavy:
            raise AssertionError(f"lint {' '.join(args)}: exit {out.returncode}, imported "
                                 f"{sorted(heavy)}\n{out.stdout[-4000:]}\n{out.stderr[-2000:]}")
        return json.loads(out.stdout), wall

    full, wall = run("--json")
    files = len(list(pathlib.Path(root, "psana_ray_tpu_torch").rglob("*.py"))) + 1
    counts = full["counts_by_checker"]
    if (not full["clean"] or full["findings"] or len(full["checkers_run"]) != LINT_RULES
            or counts.get("allowlist-rot") or full["files_scanned"] != files):
        raise AssertionError(f"lint is not clean over the port's {files} files: {full}")
    model, model_wall = run("--model", "--json")
    models = model["models"]
    if (len(models) != LINT_MODELS or model["drift"]
            or any(not m["exhausted"] or m["violation"] for m in models)):
        raise AssertionError(f"lint --model: {model}")
    emit("lint", clean=True, files=full["files_scanned"], findings=len(full["findings"]),
         checkers=len(full["checkers_run"]), seconds=full["duration_s"], wall_s=wall,
         model_states=sum(m["states"] for m in models),
         models={m["model"]: m["states"] for m in models},
         model_seconds=sum(m["duration_s"] for m in models), model_wall_s=model_wall,
         imports_torch=False)


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


def passthrough(pt, root, npz, n_consumers, producer_args=(), consumer_args=(), address=None):
    """BASELINE config 1 through the two CLIs over a fresh ``shm://`` ring
    of ``CFG1_SLOTS`` default slots (or ``address``, a queue server's):
    ``n_consumers`` consumers start and wait on it, as long-running
    consumers do, and ``CONSUMER_LEAD_S`` later the producer replays
    ``npz`` (two shards) into it. Checks every exit code, each consumer's
    end-of-stream line, the frame count and that no process imported torch
    or JAX (unless ``consumer_args`` ask for a trace); returns the rates
    the status lines give, the ring's counters (shm) and the wall seconds
    from the producer's start."""
    import re

    name = f"chip_smoke_cfg1_{os.getpid()}_{time.monotonic_ns() % 10**6}"
    addr = ["--address", address or f"shm://{name}"]
    cmds = [cli_cmd("psana_ray_tpu_torch.producer", "--exp", f"replay:{npz}", "--num_shards", "2",
                    "--num_consumers", str(n_consumers), "--queue_size", str(CFG1_SLOTS), *addr,
                    *producer_args)]
    cmds += [cli_cmd("psana_ray_tpu_torch.consumer", str(c), "--quiet", "--status_interval", "1",
                     *addr, *consumer_args) for c in range(n_consumers)]
    ring = pt.ShmRingBuffer.create(name, maxsize=CFG1_SLOTS) if address is None else None
    try:
        out, wall = run_clis(root, cmds, lead_s=CONSUMER_LEAD_S)
        ring_stats = ring.stats() if ring is not None else None
    finally:
        if ring is not None:
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
            "ring": ring_stats and {k: ring_stats[k] for k in ("puts", "gets", "puts_rejected")},
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


def codec_check(pt, frames, energies, name="shuffle-rle"):
    """The wire codec on the replay file's frames in this process: each
    frame encoded as a connection that negotiated ``name`` sends it, then
    decoded as the receiver does, and held against the file. Returns the
    wire bytes over the raw bytes, the mean ms a frame of each side and
    the frames the codec could not shrink (sent raw)."""
    import numpy as np

    from psana_ray_tpu_torch.transport.codec import decode_payload, encode_for_wire, get_codec
    from psana_ray_tpu_torch.utils.bufpool import BufferPool

    codec = get_codec(name)
    pool = BufferPool()
    wire = raw = expanded = 0
    encode_s = decode_s = 0.0
    for i in range(len(frames)):
        rec = pt.FrameRecord(0, i, np.ascontiguousarray(frames[i]), float(energies[i]))
        t0 = time.perf_counter()
        parts, lease = encode_for_wire(rec, codec, pool)
        encode_s += time.perf_counter() - t0
        payload = b"".join(bytes(part) for part in parts)
        if lease is not None:
            lease.release()
        expanded += lease is None
        t0 = time.perf_counter()
        got = decode_payload(payload)
        decode_s += time.perf_counter() - t0
        if got.event_idx != i or not np.array_equal(got.panels, rec.panels):
            raise AssertionError(f"{name}: frame {i} differs after a round trip")
        wire += len(payload)
        raw += rec.nbytes
    n = len(frames)
    return {"codec": name, "frames": n, "wire_over_raw": wire / raw, "expanded": expanded,
            "encode_ms_per_frame": encode_s * 1e3 / n, "decode_ms_per_frame": decode_s * 1e3 / n}


_CRC = r"consumer (\d+): rank=(\d+) idx=(\d+) crc32=([0-9a-f]{8})"
_CODEC = r"consumer \d+: wire codec (\S+)"


def phase_passthrough_tcp(pt, root, npz):
    """Config 1 over ``tcp://``: the queue server CLI, the producer CLI
    replaying ``passthrough_cli``'s ``.npz`` in two shards, two consumer
    CLIs with ``--stream`` started first; plain, then ``--wire_codec
    shuffle-rle`` on the producer and both consumers. No process of the
    four may import torch or JAX. The consumers run at ``--log_level
    DEBUG``, so each logs its connection's codec and the CRC-32 of every
    frame it received: every event must arrive once, and the CRC-32 of
    the frames' CRCs in event order must equal the file's. Then the codec
    alone on the file's frames: its wire bytes over raw bytes and its ms
    a frame each way."""
    import re
    import zlib

    import numpy as np

    with np.load(npz, mmap_mode="r") as f:
        frames, energies = f["frames"], f["photon_energy"]
        crcs = [zlib.crc32(np.ascontiguousarray(frames[i])) for i in range(len(frames))]
        codec = codec_check(pt, frames, energies)
    want = 0
    for c in crcs:
        want = zlib.crc32(c.to_bytes(4, "little"), want)
    server = QueueServerCLI(root, "--queue_size", str(CFG1_SLOTS), "--log_level", "WARNING")
    runs = {}
    try:
        for tag, flags, negotiated in (("plain", (), "None"),
                                       ("shuffle_rle", ("--wire_codec", "shuffle-rle"),
                                        "shuffle-rle")):
            queue = ("--queue_name", f"cfg1_{tag}")
            r = passthrough(pt, root, npz, 2, producer_args=(*flags, *queue),
                            consumer_args=("--stream", "--log_level", "DEBUG", *flags, *queue),
                            address=server.address)
            received = {}
            for _, text in r.pop("outputs")[1:]:
                codecs = re.findall(_CODEC, text)
                if codecs != [negotiated]:
                    raise AssertionError(f"passthrough_tcp {tag}: a consumer negotiated {codecs}")
                for m in re.finditer(_CRC, text):
                    idx = int(m.group(3))
                    if idx in received:
                        raise AssertionError(f"passthrough_tcp {tag}: event {idx} arrived twice")
                    received[idx] = int(m.group(4), 16)
            got = 0
            for i in range(len(crcs)):
                got = zlib.crc32(received.get(i, 0).to_bytes(4, "little"), got)
            bad = [i for i in range(len(crcs)) if received.get(i) != crcs[i]]
            if len(received) != len(crcs) or got != want:
                raise AssertionError(f"passthrough_tcp {tag}: {len(received)} of {len(crcs)} "
                                     f"events, CRC {got} against the file's {want}; events "
                                     f"missing or differing: {bad[:16]}")
            r["crc32"] = got
            runs[tag] = r
    finally:
        code, out = server.stop()
    loaded = sorted(imported_roots(out) & {"torch", "jax", "psana_ray_tpu"})
    if code != 0 or loaded:
        raise AssertionError(f"passthrough_tcp: server exit {code}, imported {loaded}; "
                             f"server: {out[-2000:]}")
    emit("passthrough_tcp", events=CFG1_EVENTS, consumers=2, shards=2, queue_size=CFG1_SLOTS,
         server_imported=loaded, crc32=want, codec=codec, **runs)


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
    age = time.monotonic() - STARTED
    with trace(logdir) as path:
        traced, traced_wall = run()
    counts = pt.counts()
    check_resnet_counts(counts, 2 * TRACE_BATCHES)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    # every launch and copy the host made has its record on the device
    on_device = {e["args"].get("correlation") for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    missing = [e["name"] for e in events if e.get("cat") == "cuda_runtime"
               and (e["name"].startswith("cudaLaunchKernel") or e["name"] == "cudaMemcpyAsync")
               and e.get("args", {}).get("correlation") not in on_device]
    modes = [int(m.group(1)) for k in kernels if (m := re.search(r"conv_sm90_kernel<\d+, (\d)>", k))]
    found = {
        "stage.device_put": ranges.count("stage.device_put"),
        "stage.dispatch": ranges.count("stage.dispatch"),
        "K1": sum("calib_cluster_kernel" in k or "calib_two_pass_kernel" in k for k in kernels),
        "K2": modes.count(0), "K3": modes.count(2) + modes.count(3),
        "without_device_record": len(missing),
    }
    want = {"stage.device_put": TRACE_BATCHES, "stage.dispatch": TRACE_BATCHES,
            "K1": TRACE_BATCHES, "K2": 32 * TRACE_BATCHES, "K3": 16 * TRACE_BATCHES,
            "without_device_record": 0}
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
    emit("stage_trace", process_age_s=age, batches=TRACE_BATCHES,
         trace_bytes=os.path.getsize(path), found=found,
         kernel_names=names, p50_batch_ms=plain["p50_ms"], p50_batch_ms_traced=traced["p50_ms"],
         wall_s=plain_wall, wall_s_traced=traced_wall, launches=counts,
         cli_trace_bytes=os.path.getsize(cli_traces[0]), cli_consumer_imported=cli["imported"][1],
         cli_frames_per_s=cli["frames_per_s"])
    return counts


def phase_producer_cli_sfx(pt, root, served, tcp=False):
    """Config 3 through the two programs a user runs: the producer CLI
    replays ``peaknet_train``'s 16 held-out RAW events over ``shm://`` into
    the SFX CLI (in-process: the card's machine has no h5py), whose peak
    sets must equal ``peaknet_train``'s bit for bit, with exactly one
    ``calib_kernel`` and ``UNET_LAUNCHES`` ``conv_block_kernel`` a batch.
    With ``tcp`` the events go producer CLI -> queue server CLI -> SFX
    CLI instead, the producer compressing with ``shuffle-rle`` and the SFX
    CLI's connection negotiating no codec, so the server hands it plain
    frames."""
    import tempfile

    import numpy as np

    from psana_ray_tpu_torch import sfx

    src = pt.SyntheticSource(run=PEAKNET_EVAL_RUN, num_events=PEAKNET_EVAL_EVENTS,
                             detector_name=DETECTOR, seed=0)
    events = list(src.iter_indexed_events(pt.RetrievalMode.RAW))
    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    name = f"chip_smoke_cli_sfx_{os.getpid()}"
    server = None
    if tcp:
        server = QueueServerCLI(root, "--log_level", "WARNING")
        address, extra = server.address, ("--wire_codec", "shuffle-rle")
    else:
        check_shm_room(CFG1_SLOTS * pt.ShmRingBuffer.DEFAULT_SLOT_BYTES)
        address, extra = f"shm://{name}", ()
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
             "--address", address, "--queue_size", str(CFG1_SLOTS), *extra],
            cwd=root, env={**os.environ, "PYTHONPATH": root}, stdout=log,
            stderr=subprocess.STDOUT, text=True)
        try:
            args = sfx.parse_args([
                "--address", address, "--serving_params", served["params"],
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
            if server is not None:
                server_code, server_out = server.stop()
            else:
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
    if server is not None and server_code != 0:
        raise AssertionError(f"the queue server exited {server_code}: {server_out[-2000:]}")
    if rc != 0 or produced != 0 or launches != want or not same:
        raise AssertionError(f"producer CLI -> SFX CLI ({address}): exit codes {produced}, {rc}; "
                             f"launches {launches} (expected {want}); peak sets equal to "
                             f"peaknet_train's: {same}; producer: {tail}")
    emit("producer_cli_sfx_tcp" if tcp else "producer_cli_sfx", events=len(sink.sets),
         peaks=int(sum(s.n for s in sink.sets)), peak_sets_equal_peaknet_train=same,
         launches=launches, wall_s=wall, transport=address.split(":")[0],
         producer_codec=extra[1] if extra else None)
    return launches


# -- phases 6r and 17g: the serving gateway and autotune ----------------------

TUNED_FRAMES = 384  # tuned_end_to_end: epix10k2M f32 RAW frames a turn (3.3 GB, the pool cycled)
TUNED_CFG1_FRAMES = 320  # tuned_end_to_end: the config-1 turn's frames (--max_steps)
TUNED_QUEUE_SIZE = 16  # tuned_end_to_end: the named queue's depth on the durable server
TUNE_FLAGS = ("--autotune_interval", "0.25", "--history_interval", "0.1")
TUNED_TURNS = (("on", ("--wire_codec", "none")), ("observe", ()), ("off", ()))
GW_POINTS = (1, 2, 4, 8, 16, 32)  # gateway_end_to_end: the operating points
# the SLO: this many times a B32 dispatch's measured time (the host copies
# into the pinned arena, the H2D copy and K1–K3), what an admitted frame
# waits for and what the policy's EWMA learns. At 8 a quarter share (t1,
# t2) fits one B32 batch ahead inside the 0.9 budget and t0's half three,
# as the JAX package's acceptance sizes it (bench.py: 300 ms over B8's
# 35 ms)
GW_SLO_X = 8.0
GW_WEIGHTS = {"t0": 2, "t1": 1, "t2": 1}  # tenants by shard_rank
GW_OVERLOAD = 2.0  # offered load over the measured capacity
GW_OVERLOAD_S = 5.0  # seconds of bursts
GW_PERIOD_S = 0.2  # a burst's period: its frames put at once, then a pause
GW_BUFFERS = 2  # pinned arenas a batch size
GW_IDLE_FRAMES = 24  # the idle run's frames


def federate_poller(port, interval_s=0.25):
    """Poll ``/federate`` on ``port`` on a thread until ``stop()``; keeps
    the last payload's ``metrics`` (what a process's registry held last
    before it exited)."""
    import urllib.request

    last, done = {}, threading.Event()

    def run():
        while not done.wait(interval_s):
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/federate",
                                            timeout=2) as r:
                    last["metrics"] = json.loads(r.read())["metrics"]
            except (OSError, ValueError):
                pass

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def stop():
        done.set()
        thread.join(timeout=10)
        return last.get("metrics", {})

    return stop


def server_metrics(port):
    """The queue server's registry over its 'N' metrics RPC."""
    from psana_ray_tpu_torch.transport.tcp import TcpQueueClient

    c = TcpQueueClient("127.0.0.1", port)
    try:
        return c.cluster_rpc({"op": "metrics"})["metrics"]
    finally:
        c.disconnect()


def knob_table(source):
    """A process's ``autotune`` source cut to what the phase prints: its
    counters and each knob's final value, actuations and reverts."""
    if not source:
        return None
    out = {k: source.get(k) for k in ("mode", "decisions_total", "guardrail_trips_total",
                                      "observed_total", "ticks_total", "pinned_total")}
    out["knobs"] = {k: {f: v[f] for f in ("current", "pinned", "actuations_total",
                                          "reverts_total", "kept_total")}
                    for k, v in source.items() if isinstance(v, dict)}
    return out


def tuned_turn(pt, root, npz, calib, served, mode, producer_args):
    """One turn of ``tuned_end_to_end``: a ``--workers 1 --durable_dir``
    queue server CLI, the producer CLI replaying ``npz`` into its named
    queue and the SFX CLI in this process, all three with ``--autotune
    mode``. Returns the peak sets, the SFX's metrics summary and launches,
    and each process's ``autotune`` source."""
    import tempfile

    from psana_ray_tpu_torch import sfx
    from psana_ray_tpu_torch.obs.registry import MetricsRegistry
    from psana_ray_tpu_torch.obs.timeseries import stop_default_history

    # an earlier phase's sampler, stopped, stays the process's default: the
    # SFX CLI's history would then take no samples and its tuner starve
    stop_default_history()
    d, _ = durable_dir(root, f"tuned_{mode}", TUNED_QUEUE_SIZE + DURABLE_RETAIN + 2)
    tune = ("--autotune", mode, *TUNE_FLAGS)
    server = QueueServerCLI(root, "--workers", "1", "--durable_dir", d, "--log_level", "WARNING",
                            *tune)
    mport = free_port()
    queue = f"tuned_{mode}"
    log = tempfile.TemporaryFile("w+")
    producer = subprocess.Popen(
        cli_cmd("psana_ray_tpu_torch.producer", "--exp", f"replay:{npz}", "--address",
                server.address, "--queue_name", queue, "--queue_size", str(TUNED_QUEUE_SIZE),
                "--metrics_port", str(mport), *tune, *producer_args),
        cwd=root, env={**os.environ, "PYTHONPATH": root}, stdout=log, stderr=subprocess.STDOUT,
        text=True)
    poll = federate_poller(mport)
    sink, metrics = PeakSink(), pt.PipelineMetrics(warmup=1)
    srv_tuned = None
    try:
        args = sfx.parse_args([
            "--address", server.address, "--queue_name", queue, "--serving_params",
            served["params"], "--output", os.path.join(d, "x.cxi"), "--mode", "quality",
            "--calib_npz", calib, "--batch", str(SFX_BATCH), "--log_level", "WARNING", *tune])
        pt.reset_counters()
        t0 = time.monotonic()
        rc = sfx.run(args, writer=sink, metrics=metrics)
        wall = time.monotonic() - t0
        launches = pt.counts()
        sfx_tuned = MetricsRegistry.default().snapshot().get("autotune")
        produced = producer.wait(timeout=120)
        prod_tuned = poll().get("autotune")
        if mode != "off":
            srv_tuned = server_metrics(server.port).get("autotune")
    finally:
        poll()
        stop_default_history()  # the SFX CLI's sampler: the next turn starts its own
        MetricsRegistry.default().unregister("autotune")
        if producer.poll() is None:
            producer.kill()
            producer.wait(timeout=30)
        code, out = server.stop()
        log.seek(0)
        prod_out = log.read()
        log.close()
        import shutil

        shutil.rmtree(d, ignore_errors=True)
    roots = (imported_roots(prod_out) | imported_roots(out)) & {"torch", "jax"}
    if rc != 0 or produced != 0 or code != 0 or roots:
        raise AssertionError(f"tuned {mode}: SFX exit {rc}, producer {produced}, server {code}, "
                             f"imported {roots}: {prod_out[-1500:]} {out[-1500:]}")
    return {"sets": sink.sets, "summary": metrics.summary(), "wall_s": wall,
            "launches": launches, "autotune": {"sfx": sfx_tuned, "producer": prod_tuned,
                                               "queue_server": srv_tuned}}


def tuned_cfg1(pt, root, npz):
    """The config-1 turn of ``tuned_end_to_end``: the producer CLI
    (``--max_steps``) into a ``--workers 1 --durable_dir`` queue server CLI
    and one consumer CLI with ``--stream --autotune on`` at DEBUG, which
    logs every frame's CRC-32. Returns the CRCs by event, the consumer's
    ``autotune`` source from its ``/federate`` and its frames/s."""
    import re

    d, _ = durable_dir(root, "tuned_cfg1", TUNED_QUEUE_SIZE + DURABLE_RETAIN + 2)
    server = QueueServerCLI(root, "--workers", "1", "--durable_dir", d, "--log_level", "WARNING")
    mport = free_port()
    queue = ("--queue_name", "tuned_cfg1")
    poll = None
    try:
        cmds = [cli_cmd("psana_ray_tpu_torch.producer", "--exp", f"replay:{npz}", "--address",
                        server.address, "--queue_size", str(TUNED_QUEUE_SIZE), "--max_steps",
                        str(TUNED_CFG1_FRAMES), *queue),
                cli_cmd("psana_ray_tpu_torch.consumer", "0", "--address", server.address,
                        "--stream", "--log_level", "DEBUG", "--metrics_port", str(mport),
                        "--autotune", "on", "--autotune_interval", "0.1",
                        "--history_interval", "0.1", *queue)]
        poll = federate_poller(mport)
        (pc, pout), (cc, cout) = run_clis(root, cmds, lead_s=CONSUMER_LEAD_S)[0]
        tuned = poll()
        poll = None
    finally:
        if poll is not None:
            poll()
        code, out = server.stop()
        import shutil

        shutil.rmtree(d, ignore_errors=True)
    roots = (imported_roots(pout) | imported_roots(cout) | imported_roots(out)) & {"torch",
                                                                                 "jax"}
    if pc != 0 or cc != 0 or code != 0 or roots:
        raise AssertionError(f"tuned cfg1: producer {pc}, consumer {cc}, server {code}, "
                             f"imported {roots}: {cout[-1500:]} {out[-1500:]}")
    crcs = {}
    for m in re.finditer(_CRC, cout):
        idx = int(m.group(3))
        if idx in crcs:
            raise AssertionError(f"tuned cfg1: event {idx} arrived twice")
        crcs[idx] = int(m.group(4), 16)
    end = re.search(_END, cout)
    return crcs, tuned.get("autotune"), float(end.group(4)) if end else None


def phase_tuned_end_to_end(pt, pool, root, served):
    """Config 3 under autotune in every process: the producer CLI replays
    ``TUNED_FRAMES`` RAW frames (the pool cycled) into a ``--workers 1
    --durable_dir`` queue server CLI over ``tcp://127.0.0.1``, which the
    SFX CLI (in-process) serves through K1 and K4 with ``peaknet_train``'s
    tree, in three turns: ``--autotune on`` (the producer with an
    explicit ``--wire_codec none``, which pins its codec knob), ``observe``
    and ``off``. Then config 1 with ``--stream --autotune on`` on the
    consumer CLI. Returns the turns' launch counts, summed."""
    import zlib

    import numpy as np

    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    npz = os.path.join(work, f"tuned_{os.getpid()}.npz")
    calib = os.path.join(work, f"tuned_calib_{os.getpid()}.npz")
    frames = np.empty((TUNED_FRAMES, *pool[0].shape), pool[0].dtype)
    for i in range(TUNED_FRAMES):
        frames[i] = pool[i % len(pool)]
    write_replay(npz, frames, [10.0] * TUNED_FRAMES)
    pool_crcs = [zlib.crc32(np.ascontiguousarray(p)) for p in pool]
    crcs = [pool_crcs[i % len(pool)] for i in range(TUNED_CFG1_FRAMES)]
    del frames
    ped, gain, mask = served["calib"]
    np.savez(calib, pedestal=ped, gain=gain, mask=mask)
    t_phase = time.monotonic()
    turns, total = {}, {}
    try:
        for mode, producer_args in TUNED_TURNS:
            turns[mode] = tuned_turn(pt, root, npz, calib, served, mode, producer_args)
            for k, v in turns[mode]["launches"].items():
                total[k] = total.get(k, 0) + v
        cfg1_crcs, cfg1_tuned, cfg1_fps = tuned_cfg1(pt, root, npz)
    finally:
        for path in (npz, calib):
            if os.path.exists(path):
                os.remove(path)
    nb = -(-TUNED_FRAMES // SFX_BATCH)
    want = {**dict.fromkeys(total, 0), "calib_kernel": nb, "conv_block_kernel": UNET_LAUNCHES * nb}
    failures = []
    base = {s.event_idx: s for s in turns["off"]["sets"]}
    for mode, turn in turns.items():
        idx = sorted(s.event_idx for s in turn["sets"])
        if idx != list(range(TUNED_FRAMES)):
            failures.append(f"{mode}: {len(idx)} events written, not each of {TUNED_FRAMES} once")
        elif any(not (np.array_equal(s.y, base[s.event_idx].y)
                      and np.array_equal(s.x, base[s.event_idx].x)
                      and np.array_equal(s.intensity, base[s.event_idx].intensity))
                 for s in turn["sets"]):
            failures.append(f"{mode}: peak sets differ from turn off's")
        if turn["launches"] != want:
            failures.append(f"{mode}: launches {turn['launches']}, expected {want}")
    for proc, src in turns["on"]["autotune"].items():
        if not src or src.get("decisions_total", 0) < 1:
            failures.append(f"on: the {proc}'s autotune source shows no resolved probe: "
                            f"{knob_table(src)}")
    for proc, src in turns["observe"]["autotune"].items():
        moved = {k: v["actuations_total"] for k, v in (src or {}).items()
                 if isinstance(v, dict) and v["actuations_total"]}
        if not src or moved:
            failures.append(f"observe: the {proc}'s knobs moved {moved} (source {bool(src)})")
    sfx_obs = turns["observe"]["autotune"]["sfx"] or {}
    if (sfx_obs.get("drain_chunk", {}).get("current") != SFX_BATCH
            or sfx_obs.get("drain_poll_s", {}).get("current") != 0.01):
        failures.append(f"observe: the SFX drain dials left their start: {knob_table(sfx_obs)}")
    codec = (turns["on"]["autotune"]["producer"] or {}).get("wire_codec_on", {})
    if codec.get("pinned") != 1 or codec.get("actuations_total") != 0:
        failures.append(f"on: the producer's pinned wire_codec_on moved or was not pinned: {codec}")
    sw = (cfg1_tuned or {}).get("stream_window", {})
    bad = [i for i in range(TUNED_CFG1_FRAMES) if cfg1_crcs.get(i) != crcs[i]]
    if not sw.get("actuations_total") or bad or len(cfg1_crcs) != TUNED_CFG1_FRAMES:
        failures.append(f"cfg1: stream_window {sw}; {len(cfg1_crcs)} of {TUNED_CFG1_FRAMES} "
                        f"frames, CRC-32 differing at {bad[:16]}")
    if failures:
        raise AssertionError("tuned_end_to_end: " + "; ".join(failures))
    emit("tuned_end_to_end", frames_per_turn=TUNED_FRAMES, batch=SFX_BATCH,
         features=list(SFX_FEATURES), queue_size=TUNED_QUEUE_SIZE, server="--workers 1 "
         "--durable_dir", flags=list(TUNE_FLAGS),
         fps={m: t["summary"]["fps"] for m, t in turns.items()},
         p50_batch_ms={m: t["summary"]["p50_ms"] for m, t in turns.items()},
         wall_s={m: t["wall_s"] for m, t in turns.items()},
         peaks={m: int(sum(s.n for s in t["sets"])) for m, t in turns.items()},
         launches={m: t["launches"] for m, t in turns.items()},
         autotune={m: {p: knob_table(s) for p, s in t["autotune"].items()}
                   for m, t in turns.items() if m != "off"},
         cfg1={"frames": TUNED_CFG1_FRAMES, "crc32_intact": True, "consumer_fps": cfg1_fps,
               "autotune": knob_table(cfg1_tuned)},
         phase_s=time.monotonic() - t_phase)
    return total


def gateway_dispatch(torch, pt, consts, params, device, last, counts):
    """``make_batch_dispatch`` over pinned arenas (``GW_BUFFERS`` a batch
    size) into config 4's step: each batch goes to the card in one H2D
    copy from its arena, the copy's event fenced on the arena, then K1 ->
    ResNet-50 (K2, K3); the dispatch waits for the logits, so the gateway
    times the whole dispatch. ``last[b]`` keeps batch size b's last
    frames on the card and its logits; ``counts`` the batches and frames
    each size carried."""
    from psana_ray_tpu_torch.infeed.batcher import host_arena
    from psana_ray_tpu_torch.infeed.pipeline import pinned_arena
    from psana_ray_tpu_torch.serving import make_batch_dispatch

    ped, gain, mask = consts
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None

    def consume(batch):
        arena = batch.arena
        src = arena.tensors[0] if arena.tensors else torch.from_numpy(batch.frames)
        if cuda:
            with torch.cuda.stream(stream):
                x = src.to(device, non_blocking=True)
                fence = torch.cuda.Event()
                fence.record(stream)
            arena.fence = fence  # the batcher waits on it before refilling the arena
            torch.cuda.current_stream(device).wait_stream(stream)
        else:
            x = src.clone()
        cal = pt.fused_calibrate(x, ped, gain, mask, threshold=10.0, out_dtype=torch.bfloat16)
        logits = pt.resnet_fused_infer(params, pt.panels_to_nhwc(cal))
        if cuda:
            torch.cuda.synchronize(device)
        b = batch.batch_size
        last[b] = (x, logits, batch.num_valid)
        n, f = counts.get(b, (0, 0))
        counts[b] = (n + 1, f + batch.num_valid)

    return make_batch_dispatch(consume, n_buffers=GW_BUFFERS,
                               new_arena=pinned_arena if cuda else host_arena)


def gw_records(pt, pool, shard, n, start=0):
    """``n`` records of shard ``shard``: the pool's RAW frames, cycled,
    each viewing its pool array (no copy until a batcher's)."""
    return [pt.FrameRecord(shard, start + i, pool[(start + i) % len(pool)], 10.0)
            for i in range(n)]


def phase_gateway_end_to_end(torch, pt, pool, consts, model, params, device, root):
    """Config 4 (ResNet-50, width 64, frozen affines, K1–K3) behind the
    serving gateway. The device time of each operating point (H2D from a
    pinned buffer, K1, the ResNet) seeds ``SloPolicy``; B32 dispatches
    through ``make_batch_dispatch`` measure the capacity, and the SLO is
    ``GW_SLO_X`` times one of them. (a) Overload: three
    shard threads put frames into a ring in bursts at ``GW_OVERLOAD`` times
    the capacity, ``serve_queue`` admits them as tenants t0:t1:t2 at
    weights 2:1:1, a ``StallDetector`` bound, and an autotune registry
    with the gateway noted ticks beside it (c). (b) Idle: the producer CLI
    -> queue server CLI -> ``serve_queue`` on a tenanted client with one
    credit, every frame at B1. Returns the launch counts of (a) and (b)."""
    import numpy as np

    from psana_ray_tpu_torch.autotune import AutotuneDaemon, HillClimber, Objective
    from psana_ray_tpu_torch.autotune.knobs import (
        KnobRegistry,
        drain_chunk_knob,
        drain_poll_knob,
    )
    from psana_ray_tpu_torch.infeed.batcher import DrainControl
    from psana_ray_tpu_torch.obs.stall import StallDetector
    from psana_ray_tpu_torch.obs.timeseries import start_default_history, stop_default_history
    from psana_ray_tpu_torch.ops.fused_calib import fused_calibrate_plain
    from psana_ray_tpu_torch.serving import GatewayTelemetry, ServingGateway, SloPolicy
    from psana_ray_tpu_torch.transport.tcp import TcpQueueClient
    from psana_ray_tpu_torch.utils.bufpool import WIRE

    ped, gain, mask = consts
    t_phase = time.monotonic()
    # the device time of each operating point: H2D from pinned memory + K1 + ResNet
    host = torch.from_numpy(np.stack([pool[i % len(pool)] for i in range(max(GW_POINTS))]))
    if device.type == "cuda":
        host = host.pin_memory()
    device_ms = {}
    for b in GW_POINTS:
        src = host[:b]

        def run(src=src):
            x = src.to(device, non_blocking=True)
            cal = pt.fused_calibrate(x, ped, gain, mask, threshold=10.0,
                                     out_dtype=torch.bfloat16)
            return pt.resnet_fused_infer(params, pt.panels_to_nhwc(cal))

        device_ms[b] = Timer(torch, device).ms_cold(run, iters=5)
    del host
    points = tuple((b, device_ms[b]) for b in GW_POINTS)

    last, per_size = {}, {}
    dispatch = gateway_dispatch(torch, pt, consts, params, device, last, per_size)
    # every point once through the dispatch path (its arenas pinned), then
    # B32 dispatches timed: the capacity, host copies included
    for b in GW_POINTS:
        dispatch(gw_records(pt, pool, 0, b), b)
    t0 = time.monotonic()
    n_cap = 6
    for k in range(n_cap):
        dispatch(gw_records(pt, pool, 0, 32, 32 * k), 32)
    capacity_fps = 32 * n_cap / (time.monotonic() - t0)
    slo_ms = GW_SLO_X * 32 / capacity_fps * 1000.0
    arenas = [a for bt in dispatch.batchers.values() for a in bt.pool]
    pinned_bytes = sum(t.numel() * t.element_size() for a in arenas for t in a.tensors or ())
    all_pinned = all(a.tensors and all(t.is_pinned() for t in a.tensors) for a in arenas)

    # (a) overload, with (c) the registry beside it; each dispatch's wall
    # time is kept (one slow dispatch moves the policy's table for long)
    dispatch_times = []

    def timed(records, b):
        t = time.perf_counter()
        dispatch(records, b)
        dispatch_times.append((b, (time.perf_counter() - t) * 1e3))

    gw = ServingGateway(timed, policy=SloPolicy(slo_ms=slo_ms, operating_points=points),
                        weights=GW_WEIGHTS)
    ring = pt.RingBuffer(maxsize=100_000)  # references to the pool's arrays
    detector = StallDetector(poll_interval_s=0.25, full_threshold_s=1.0,
                             idle_threshold_s=5.0).watch("overload", ring)
    detector.bind_gateway(gw)
    control = DrainControl(chunk=32, poll_s=0.01)
    registry = KnobRegistry()
    registry.register(drain_chunk_knob(control))
    registry.register(drain_poll_knob(control))
    registry.note_gateway(gw)
    stop_default_history()  # an earlier phase's sampler, stopped, would starve the tuner
    start_default_history(interval_s=0.1)
    tuner = AutotuneDaemon(HillClimber(registry, Objective("gateway.completed_total",
                                                           window_s=2.0),
                                       guardrails=[], hold_ticks=2, settle_ticks=1,
                                       cooldown_ticks=2), interval_s=0.1)
    per_tenant_fps = GW_OVERLOAD * capacity_fps / len(GW_WEIGHTS)
    per_burst = max(1, int(per_tenant_fps * GW_PERIOD_S))
    bursts = int(GW_OVERLOAD_S / GW_PERIOD_S)
    put = {}

    def shard(rank):
        recs = gw_records(pt, pool, rank, per_burst * bursts)
        t_start = time.monotonic()
        for k in range(bursts):
            for rec in recs[k * per_burst:(k + 1) * per_burst]:
                ring.put(rec)
            time.sleep(max(0.0, t_start + (k + 1) * GW_PERIOD_S - time.monotonic()))
        put[rank] = len(recs)
        ring.put(pt.EndOfStream(producer_rank=rank, total_events=len(recs), shards_done=1,
                                total_shards=len(GW_WEIGHTS)))

    threads = [threading.Thread(target=shard, args=(r,), daemon=True)
               for r in range(len(GW_WEIGHTS))]
    for size in per_size:
        per_size[size] = (0, 0)
    torch.cuda.synchronize()
    pt.reset_counters()
    detector.start()
    tuner.start()
    t0 = time.monotonic()
    try:
        for t in threads:
            t.start()
        gw.serve_queue(ring, tenant_of=lambda r: f"t{r.shard_rank}", max_wait_s=60.0)
        elapsed = time.monotonic() - t0
    finally:
        tuner.stop()
        detector.stop()
        for t in threads:
            t.join(timeout=60)
        stop_default_history()
    overload_counts = pt.counts()
    s = gw.telemetry.stats()
    by_path = gw.telemetry.shed_by_path()
    completed_seen = sum(f for _, f in per_size.values())
    dispatches = sum(n for n, _ in per_size.values())
    offered = sum(put.values())
    goodput = gw.telemetry.tenant_goodput()
    good_total = max(1, sum(goodput.values()))
    knobs = registry.snapshot()
    overload = {
        "offered": offered, "offered_fps": offered / elapsed, "capacity_fps": capacity_fps,
        "admitted": s["admitted_total"], "completed": s["completed_total"],
        "shed": s["shed_total"], "shed_by_path": by_path, "backlog_left": gw.backlog(),
        "goodput_fps": s["goodput_total"] / elapsed,
        "goodput_over_capacity": s["goodput_total"] / elapsed / capacity_fps,
        "p99_admitted_ms": {t: s[t]["p99_ms"] for t in GW_WEIGHTS if t in s},
        "slo_ms": slo_ms, "slo_attainment": s["slo_attainment"],
        "tenant_goodput_share": {t: goodput.get(t, 0) / good_total for t in GW_WEIGHTS},
        "weight_share": {t: w / sum(GW_WEIGHTS.values()) for t, w in GW_WEIGHTS.items()},
        "dispatches_by_size": {str(b): per_size.get(b, (0, 0))[0] for b in GW_POINTS},
        "degraded_episodes": s["escalations"], "restores": s["restores"],
        "stall_events": [e.kind for e in detector.events],
        "policy_service_ms": gw.policy.snapshot()["service_ms"], "elapsed_s": elapsed,
        "dispatch_ms": {str(b): {"n": len(ts), "p50": float(np.median(ts)), "max": max(ts)}
                        for b in GW_POINTS
                        for ts in [[ms for size, ms in dispatch_times if size == b]] if ts},
    }
    registry_row = {"drain_chunk_actuations": knobs["drain_chunk"]["actuations_total"],
                    "drain_poll_s_actuations": knobs["drain_poll_s"]["actuations_total"],
                    "eligible": registry.eligible(),
                    "decisions": tuner.controller.decisions}
    failures = []
    if not (s["offered_total"] == offered == s["completed_total"] + s["shed_total"]
            and gw.backlog() == 0):
        failures.append(f"overload: offered {offered} (counted {s['offered_total']}) against "
                        f"completed {s['completed_total']} + shed {s['shed_total']}, backlog "
                        f"{gw.backlog()}")
    if not (s["admitted_total"] == s["completed_total"] + by_path["deadline"]
            and completed_seen == s["completed_total"]):
        failures.append(f"overload: admitted {s['admitted_total']}, completed "
                        f"{s['completed_total']} (the device saw {completed_seen}), shed at "
                        f"dequeue {by_path['deadline']}")
    if s["shed_total"] != sum(by_path.values()):
        failures.append(f"overload: shed {s['shed_total']} against its paths {by_path}")
    want = {**dict.fromkeys(overload_counts, 0), "calib_kernel": dispatches,
            "conv1x1_kernel": 16 * dispatches, "conv3x3_kernel": 16 * dispatches,
            "back_kernel": 16 * dispatches}
    if overload_counts != want:
        failures.append(f"overload: launches {overload_counts}, expected {want}")
    if knobs["drain_chunk"]["actuations_total"] != 0 or "drain_chunk" in registry.eligible():
        failures.append(f"registry: drain_chunk actuated with a gateway noted: {registry_row}")

    # (b) idle, over TCP: one credit, so one frame a pop and every dispatch at B1
    work = os.path.join(root, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    npz = os.path.join(work, f"gateway_idle_{os.getpid()}.npz")
    write_replay(npz, np.stack([pool[i % len(pool)] for i in range(GW_IDLE_FRAMES)]),
                 [10.0] * GW_IDLE_FRAMES)
    server = QueueServerCLI(root, "--log_level", "WARNING")
    sizes = {}
    idle_dispatch = gateway_dispatch(torch, pt, consts, params, device, last, sizes)
    idle = ServingGateway(idle_dispatch, policy=SloPolicy(slo_ms=slo_ms, operating_points=points),
                          telemetry=GatewayTelemetry(register=False))
    client = producer = None
    try:
        client = TcpQueueClient("127.0.0.1", server.port, namespace="default",
                                queue_name="gateway_idle", tenant="idle", tenant_weight=1)
        client.stream_open(1)
        producer = subprocess.Popen(
            cli_cmd("psana_ray_tpu_torch.producer", "--exp", f"replay:{npz}", "--address",
                    server.address, "--queue_name", "gateway_idle", "--queue_size", "8"),
            cwd=root, env={**os.environ, "PYTHONPATH": root}, stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT)
        c0 = WIRE.stats()["copies_total"]
        pt.reset_counters()
        t0 = time.monotonic()
        idle.serve_queue(client, tenant_of=lambda r: "idle", max_wait_s=60.0)
        idle_s = time.monotonic() - t0
        idle_counts = pt.counts()
        copies = (WIRE.stats()["copies_total"] - c0) / GW_IDLE_FRAMES
        produced = producer.wait(timeout=60)
    finally:
        if client is not None:
            client.disconnect()
        if producer is not None and producer.poll() is None:
            producer.kill()
            producer.wait(timeout=30)
        code, out = server.stop()
        os.remove(npz)
    si = idle.telemetry.stats()
    idle_row = {"frames": GW_IDLE_FRAMES, "completed": si["completed_total"],
                "shed": si["shed_total"], "dispatches_by_size": {str(b): n for b, (n, _)
                                                                 in sizes.items()},
                "host_copies_per_frame": copies, "p99_ms": si.get("idle", {}).get("p99_ms"),
                "frames_per_s": GW_IDLE_FRAMES / idle_s}
    if (produced != 0 or code != 0 or si["completed_total"] != GW_IDLE_FRAMES
            or set(sizes) != {1} or copies != 1.0):
        failures.append(f"idle: producer {produced}, server {code}, {idle_row}")
    nb = sum(n for n, _ in sizes.values())
    want = {**dict.fromkeys(idle_counts, 0), "calib_kernel": nb, "conv1x1_kernel": 16 * nb,
            "conv3x3_kernel": 16 * nb, "back_kernel": 16 * nb}
    if idle_counts != want:
        failures.append(f"idle: launches {idle_counts}, expected {want}")

    # each operating point's last batch against the plain path on its frames
    errs = {}
    for b in GW_POINTS:
        x, logits, n = last[b]
        cal = fused_calibrate_plain(x, ped, gain, mask, out_dtype=torch.bfloat16)
        with torch.no_grad():
            ref = model(pt.panels_to_nhwc(cal))
        torch.cuda.synchronize()
        errs[str(b)] = rel_err(ref[:n], logits[:n])
        if not (errs[str(b)] < REL_TOL and torch.isfinite(logits).all()):
            failures.append(f"B{b}: last batch's logits rel_err {errs[str(b)]}")
    if failures:
        raise AssertionError("gateway_end_to_end: " + "; ".join(failures))
    emit("gateway_end_to_end", operating_points=list(GW_POINTS), device_ms=device_ms,
         b32_dispatch_ms=32 / capacity_fps * 1000.0, slo_ms=slo_ms,
         slo_x_b32_dispatch=GW_SLO_X, capacity_fps=capacity_fps,
         pinned_arena_bytes=pinned_bytes, arenas_pinned=all_pinned, buffers_per_size=GW_BUFFERS,
         weights=GW_WEIGHTS, overload=overload, idle=idle_row, registry=registry_row,
         logits_rel_err=errs, phase_s=time.monotonic() - t_phase)
    return {k: overload_counts[k] + idle_counts[k] for k in overload_counts}


# -- phases 20-22 ----------------------------------------------------------

VIT_PARALLEL_BATCHES = 8  # timed batches of each vit_parallel form, after 2 warm-up
VIT_PARALLEL_MICROBATCHES = 2
VIT_MOE_EXPERTS = 4
REMAT_STEPS = 3  # timed train steps of each remat setting, after 1 warm-up


def check_counts(counts, want, what):
    """``counts`` (the kernels' launches) against ``want`` for each named
    kernel, and 0 for every other."""
    full = {name: want.get(name, 0) for name in counts}
    if counts != full:
        raise AssertionError(f"{what}: launch counts {counts}, expected {full}")


def step_times(torch, fn, n, warmup=2):
    """CUDA-event ms of ``n`` calls of ``fn`` after ``warmup`` (each call
    synchronised), and the peak memory of the timed calls in GiB."""
    import numpy as np

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(n):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return {"p50_ms": float(np.percentile(times, 50)), "min_ms": float(min(times)),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def phase_multichip(torch, pt, timer, pool, consts, src, device):
    """The five legs of ``dryrun_multichip`` on the one-rank NCCL group this
    process holds, then config 4 through ``make_infer_step`` on a one-wide
    ``data`` axis at batch 32 against the ``end_to_end`` step on the same
    frames."""
    import numpy as np

    from psana_ray_tpu_torch.parallel import compat

    pt.reset_counters()
    compat.reset_collectives()
    t0 = time.monotonic()
    legs = pt.dryrun_multichip(1)
    legs_s = time.monotonic() - t0
    leg_counts, leg_variants = pt.counts(), pt.variant_counts()
    # the ViT legs run in f32 (the reference's dtype): flash_f32_kernel and
    # flash_bwd_f32_kernel, no dq rounding launch
    missing = [k for k in ("calib_kernel", "conv1x1_kernel", "conv3x3_kernel", "back_kernel",
                           "flash_kernel", "flash_bwd_kernel") if not leg_counts[k]]
    missing += [k for k in ("flash_f32_kernel", "flash_bwd_f32_kernel")
                if not variant_sum(leg_variants, k)]
    if missing or variant_sum(leg_variants, "flash_f32_kernel") != leg_counts["flash_kernel"]:
        raise AssertionError(f"the dry run's legs launched no {missing}, or not only f32 "
                             f"attention: {leg_counts} {leg_variants}")
    emit("multichip_legs", seconds=legs_s, launches=leg_counts,
         variants={"/".join(map(str, k)): n for k, n in leg_variants.items()},
         collectives=legs.pop("collectives"), legs=legs)

    params = pt.pack_fused(pt.resnet_from_flax(
        pt.init_resnet_params(in_channels=src.spec.panels, seed=0), device=device))
    ped, gain, mask = consts

    def serve(frames):
        cal = pt.fused_calibrate(frames, ped, gain, mask, threshold=10.0,
                                 out_dtype=torch.bfloat16)
        return pt.resnet_fused_infer(params, pt.panels_to_nhwc(cal))

    mesh = pt.create_mesh(("data",), (1,), device_type=device.type)
    infer = pt.make_infer_step(serve, mesh)
    frames = torch.from_numpy(np.stack(pool[:BATCH])).to(device)
    step = make_step(torch, pt, consts, params)
    with torch.no_grad():
        want = step(pt.Batch(frames, *(torch.zeros(BATCH, device=device) for _ in range(4)),
                             num_valid=BATCH))[0]
        compat.reset_collectives()
        pt.reset_counters()
        got = infer(frames)
        torch.cuda.synchronize()
        counts = pt.counts()
        collectives = compat.collective_counts()
    check_resnet_counts(counts, 1)
    if tuple(got.shape) != (BATCH, 2) or not torch.equal(got, want):
        raise AssertionError(f"make_infer_step's logits differ from the end_to_end step's: "
                             f"max |diff| {float((got.float() - want.float()).abs().max())}")
    emit("multichip_infer_step", batch=BATCH, mesh={"data": 1}, logits_equal=True,
         launches=counts, collectives=collectives,
         infer_step_ms=timer.ms_cold(lambda: infer(frames), iters=5),
         end_to_end_step_ms=timer.ms_cold(lambda: serve(frames), iters=5))
    return {k: leg_counts[k] + counts[k] for k in counts}, leg_variants


MH_EXTRA = 5  # multihost: frames past 3 full batches (an uneven tail on purpose)
MH_LEGS = (("epix10k2M", 2 * BATCH - 24), ("jungfrau4M", 2 * JUNGFRAU_BATCH + 4))  # frames
MH_STALL_S = 0.5  # multihost: the silent leg's stall timeout


def _mh_produce(pt, ring, frames, n):
    """A producer thread puts ``n`` frames (``frames`` cycled) and one EOS."""
    events = ((i, frames[i % len(frames)], 10.0) for i in range(n))
    thread = threading.Thread(target=pt.produce, args=(events, ring), kwargs={"timeout": 120.0},
                              daemon=True)
    thread.start()
    return thread


def _mh_order(rounds):
    """The fixed round-robin: each leg, in order, while it has rounds."""
    left, order = dict(rounds), []
    while any(left.values()):
        for name in rounds:
            if left[name]:
                order.append(name)
                left[name] -= 1
    return order


def phase_multihost(torch, pt, pool, consts, src, device):
    """Config 4 through ``GlobalStreamConsumer`` on the one-rank NCCL group:
    ``3 * BATCH + MH_EXTRA`` frames in 4 rounds, the logits equal to the
    ``end_to_end`` step's; then epix10k2M (ResNet-50) and jungfrau4M (K1)
    through ``MultiDetectorGlobalConsumer`` in the fixed order, and the
    same two beside a silent third leg, whose ``StreamStalled`` is raised
    after the healthy legs finish."""
    import numpy as np

    from psana_ray_tpu_torch.infeed import multihost as mh
    from psana_ray_tpu_torch.ops.fused_calib import fused_calibrate_plain
    from psana_ray_tpu_torch.parallel import compat

    t_phase = time.monotonic()
    params = pt.pack_fused(pt.resnet_from_flax(
        pt.init_resnet_params(in_channels=src.spec.panels, seed=0), device=device))
    ped, gain, mask = consts

    def serve(frames):
        cal = pt.fused_calibrate(frames, ped, gain, mask, threshold=10.0,
                                 out_dtype=torch.bfloat16)
        return pt.resnet_fused_infer(params, pt.panels_to_nhwc(cal))

    mesh = pt.create_mesh(("data",), (1,), device_type=device.type)
    infer = pt.make_infer_step(serve, mesh)
    frame_shape = tuple(src.spec.frame_shape)

    # 1. one stream, an uneven tail
    n_frames = 3 * BATCH + MH_EXTRA
    ring = pt.RingBuffer(maxsize=3 * BATCH)
    thread = _mh_produce(pt, ring, pool, n_frames)
    seen, stamps = [], []
    consumer = pt.GlobalStreamConsumer(ring, local_batch_size=BATCH, mesh=mesh,
                                       frame_shape=frame_shape, frame_dtype=pool[0].dtype)
    torch.cuda.synchronize()
    compat.reset_collectives()
    pt.reset_counters()
    t0 = time.monotonic()
    n_local = consumer.run(lambda b: infer(b.frames), block_until_ready=True,
                           on_result=lambda out, g: (seen.append((out, g)),
                                                     stamps.append(time.monotonic())))
    wall = time.monotonic() - t0
    counts = pt.counts()
    collectives = compat.collective_counts()
    thread.join(timeout=60)
    ring.close()
    check_resnet_counts(counts, 4)
    if n_local != n_frames or len(seen) != 4:
        raise AssertionError(f"{n_local} frames in {len(seen)} rounds, expected {n_frames} in 4")
    step = make_step(torch, pt, consts, params)
    with torch.no_grad():
        for out, g in seen:
            frames = g.frames.to_local()
            want = step(pt.Batch(frames, *(torch.zeros(BATCH, device=device) for _ in range(4)),
                                 num_valid=BATCH))[0]
            got = out.to_local()
            if tuple(got.shape) != (BATCH, 2) or not torch.equal(got[:g.num_valid],
                                                                 want[:g.num_valid]):
                raise AssertionError("GlobalStreamConsumer's logits differ from the end_to_end "
                                     "step's on the same frames")
    rounds_ms = [1e3 * (b - a) for a, b in zip([t0] + stamps, stamps)]
    g = seen[-1][1]
    mh.global_valid(g)  # warm
    t1 = time.perf_counter()
    for _ in range(20):
        mh.global_valid(g)
    valid_ms = 1e3 * (time.perf_counter() - t1) / 20
    del seen
    # a round's host parts, measured apart (the median of 3): the batcher's
    # copies of 32 frames into a fresh pageable arena, and the copy of
    # that batch to the card (make_global_Batch, synchronous)
    recs = [pt.FrameRecord(0, i, pool[i % len(pool)], 10.0) for i in range(BATCH)]
    assemble, h2d = [], []
    for _ in range(3):
        t1 = time.perf_counter()
        fb = pt.FrameBatcher(BATCH)
        local = [fb.push(rec) for rec in recs][-1]
        t2 = time.perf_counter()
        mh.make_global_Batch(local, mesh)
        torch.cuda.synchronize()
        assemble.append(1e3 * (t2 - t1))
        h2d.append(1e3 * (time.perf_counter() - t2))
    parts = {"assemble_ms": float(np.median(assemble)), "h2d_ms": float(np.median(h2d)),
             "step_ms": consumer.metrics.summary()["p50_ms"], "valid_count_ms": valid_ms}

    # 2. two detectors, streams of different lengths, the fixed order
    jsrc = pt.SyntheticSource(num_events=4, detector_name="jungfrau4M", seed=0)
    jpool = [jsrc.event(i, pt.RetrievalMode.RAW)[0] for i in range(4)]
    jconsts = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
        jsrc.pedestal(), jsrc.spec.adu_gain * jsrc.gain_map(), jsrc.create_bad_pixel_mask()))
    jinfer = pt.make_infer_step(lambda f: pt.fused_calibrate(f, *jconsts, threshold=10.0), mesh)
    batches = {"epix10k2M": BATCH, "jungfrau4M": JUNGFRAU_BATCH}
    frames_of = {"epix10k2M": pool, "jungfrau4M": jpool}
    steps = {"epix10k2M": lambda b: infer(b.frames), "jungfrau4M": lambda b: jinfer(b.frames)}

    def two_legs(silent):
        rings = {det: pt.RingBuffer(maxsize=3 * batches[det]) for det, _ in MH_LEGS}
        threads = [_mh_produce(pt, rings[det], frames_of[det], n) for det, n in MH_LEGS]
        legs = {det: pt.GlobalStreamConsumer(rings[det], local_batch_size=batches[det], mesh=mesh,
                                             frame_shape=frames_of[det][0].shape,
                                             frame_dtype=frames_of[det][0].dtype)
                for det, _ in MH_LEGS}
        if silent:  # a live producer that sends nothing: no data, no EOS
            legs["silent"] = pt.GlobalStreamConsumer(
                pt.RingBuffer(maxsize=4), local_batch_size=JUNGFRAU_BATCH, mesh=mesh,
                frame_shape=jpool[0].shape, stall_timeout_s=MH_STALL_S)
        order, got, last = [], {}, {}

        def on_result(name, out, g):
            order.append(name)
            got[name] = got.get(name, 0) + g.num_valid
            last[name] = (out, g)

        torch.cuda.synchronize()
        pt.reset_counters()
        t = time.monotonic()
        stalled = None
        try:
            counts = pt.MultiDetectorGlobalConsumer(legs).run(
                {**steps, "silent": steps["jungfrau4M"]}, on_result=on_result,
                block_until_ready=True)
        except pt.StreamStalled as e:  # expected of the silent leg only
            if not silent:
                raise
            stalled, counts = str(e), None
        seconds = time.monotonic() - t
        launches = pt.counts()
        for th in threads:
            th.join(timeout=60)
        want = {det: n for det, n in MH_LEGS}
        rounds = {det: -(-n // batches[det]) for det, n in MH_LEGS}
        if (got != want or (counts is not None and counts != want) or order != _mh_order(rounds)
                or (silent and stalled is None)):
            raise AssertionError(f"legs {got} (run {counts}) in order {order}, stalled "
                                 f"{stalled!r}: expected {want} in {_mh_order(rounds)}")
        check_counts(launches, {"calib_kernel": sum(rounds.values()),
                                **{k: 16 * rounds["epix10k2M"] for k in
                                   ("conv1x1_kernel", "conv3x3_kernel", "back_kernel")}},
                     "multihost legs")
        out, g = last["jungfrau4M"]
        frames = g.frames.to_local()
        err = calib_err(torch, out.to_local(), fused_calibrate_plain(frames, *jconsts,
                                                                     threshold=10.0),
                        "jungfrau4M leg")
        return {"order": "".join(d[0] for d in order), "frames": got, "seconds": seconds,
                "jungfrau_max_abs_err": err, "stalled": stalled}, launches

    legs2, legs2_counts = two_legs(silent=False)
    legs3, legs3_counts = two_legs(silent=True)
    emit("multihost", frames=n_local, rounds=len(stamps), batch=BATCH, mesh={"data": 1},
         logits_equal=True, wall_s=wall,
         round_ms={"p50": float(np.percentile(rounds_ms, 50)),
                   "p90": float(np.percentile(rounds_ms, 90)), "all": rounds_ms},
         valid_count_ms=valid_ms, round_parts=parts, collectives=collectives, launches=counts,
         host_bytes=consumer.metrics.bytes.count, two_detectors=legs2,
         two_detectors_launches=legs2_counts, stalled_leg=legs3,
         stalled_leg_launches=legs3_counts, stall_timeout_s=MH_STALL_S,
         phase_s=time.monotonic() - t_phase)
    return {k: counts[k] + legs2_counts[k] + legs3_counts[k] for k in counts}


def phase_vit_parallel(torch, pt, tf, pool, consts, frame_shape, device):
    """The full-width ViT (8,448 tokens, embed 512, 4 heads of 128, depth
    4, bf16) served at batch 2 through ``ulysses_attention(impl="flash")``,
    ``ring_flash_attention``, ``vit_pipelined_apply`` (2 microbatches) and
    ``moe_experts=4`` on one-wide meshes, each against its plain-attention
    forward on the same calibrated frames."""
    import functools

    import numpy as np

    from psana_ray_tpu_torch.parallel import compat
    from psana_ray_tpu_torch.parallel.moe import pick_group_size

    ped, gain, mask = consts

    def plain_attn(q, k, v):
        o = tf.attention_with_stats_plain(*(t.transpose(1, 2) for t in (q, k, v)))[0]
        return o.transpose(1, 2)

    with torch.no_grad():
        x = pt.fused_calibrate(torch.from_numpy(np.stack(pool[:VIT_BATCH])).to(device), ped, gain,
                               mask, threshold=10.0, out_dtype=torch.bfloat16)
    dense = pt.init_vit_params(frame_shape, seed=0)
    scanned = pt.init_vit_params(frame_shape, seed=0, scan_trunk=True)
    moe = pt.init_vit_params(frame_shape, seed=0, moe_experts=VIT_MOE_EXPERTS)
    tokens = dense["embed"]["pos_embed"].shape[1]
    sp = pt.create_mesh(("data", "seq"), (1, 1), device_type=device.type)
    pp = pt.create_mesh(("data", "pipe"), (1, 1), device_type=device.type)
    scan_model = pt.vit_from_flax(scanned, device=device)
    forms = {
        "ulysses_flash": (pt.vit_from_flax(dense, device=device, attn_fn=functools.partial(
            pt.ulysses_attention, mesh=sp, seq_axis="seq", data_axis="data", impl="flash")),
            dense, VIT_DEPTH),
        "ring_flash": (pt.vit_from_flax(dense, device=device, attn_fn=functools.partial(
            pt.ring_flash_attention, mesh=sp, seq_axis="seq", data_axis="data")),
            dense, VIT_DEPTH),
        "pipelined": (lambda x: pt.vit_pipelined_apply(
            scan_model, x, pp, data_axis="data", microbatches=VIT_PARALLEL_MICROBATCHES),
            dense, VIT_DEPTH * VIT_PARALLEL_MICROBATCHES),
        "moe": (pt.vit_from_flax(moe, device=device), moe, VIT_DEPTH),
    }
    if pick_group_size(tokens, 512) >= tokens:
        raise AssertionError("the MoE's grouped dispatch is not active")
    totals = {}
    for name, (fn, tree, per_batch) in forms.items():
        with torch.no_grad():
            ref = pt.vit_from_flax(tree, device=device, attn_fn=plain_attn)(x)
            compat.reset_collectives()
            pt.reset_counters()
            timing = step_times(torch, lambda: fn(x), VIT_PARALLEL_BATCHES)
            counts = pt.counts()
            collectives = compat.collective_counts()
            got = fn(x)
        torch.cuda.synchronize()
        calls = VIT_PARALLEL_BATCHES + 2
        check_counts(counts, {"flash_kernel": per_batch * calls}, f"vit_parallel {name}")
        err = rel_err(ref, got)
        if tuple(got.shape) != (VIT_BATCH, 2) or not err < REL_TOL:
            raise AssertionError(f"vit_parallel {name}: rel_err {err} against the plain path")
        emit("vit_parallel", form=name, batch=VIT_BATCH, tokens=tokens, calls=calls,
             launches=counts, collectives=collectives, logits_rel_err=err,
             logits_max_abs=float(ref.abs().max()),
             moe_group_size=pick_group_size(tokens, 512) if name == "moe" else None,
             **timing)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        del ref, got
    # the ring-flash gradient: K5's lse enters the hop combine, so the
    # backward runs K6/K7 with an lse cotangent; against K5's forward with
    # the plain backward, so that only the backward differs
    grads = {}
    compat.reset_collectives()
    for name, attn in (("ring_flash", forms["ring_flash"][0].trunk.block0.attn_fn),
                       ("plain", reference_attention(torch, tf, kernel_forward=True))):
        model = pt.vit_from_flax(dense, device=device, attn_fn=attn)
        pt.reset_counters()
        model(x).float().pow(2).sum().backward()
        torch.cuda.synchronize()
        if name == "ring_flash":
            counts = pt.counts()
            check_counts(counts, {"flash_kernel": VIT_DEPTH, "flash_bwd_kernel": VIT_DEPTH,
                                  "flash_bwd_dq_convert": VIT_DEPTH}, "ring_flash gradient")
            for k, v in counts.items():
                totals[k] += v
        grads[name] = {k: p.grad for k, p in model.named_parameters()}
    errs = {k: rel_err(grads["plain"][k], grads["ring_flash"][k]) for k in grads["plain"]}
    worst = max(errs, key=errs.get)
    if not errs[worst] < REL_TOL:
        raise AssertionError(f"ring_flash gradient: {worst} rel_err {errs[worst]}")
    emit("vit_parallel_ring_flash_grad", batch=VIT_BATCH, tokens=tokens,
         grad_worst_leaf=worst, grad_worst_rel_err=errs[worst],
         grad_median_rel_err=float(np.median(list(errs.values()))),
         collectives=compat.collective_counts())
    return totals


def phase_remat(torch, pt, tf, pool, consts, frame_shape, device):
    """One ViT training step at batch 4 with ``remat=False`` and
    ``remat=True`` from the same weights (step ms, peak GiB, the gradients'
    largest relative difference), and K6/K7 against
    ``attention_bwd_plain`` at the step's shape."""
    import numpy as np

    ped, gain, mask = consts
    params = pt.init_vit_params(frame_shape, seed=0)
    with torch.no_grad():
        x = pt.fused_calibrate(torch.from_numpy(np.stack(pool[:TRAIN_BATCH])).to(device), ped,
                               gain, mask, threshold=10.0, out_dtype=torch.bfloat16)
    aux = (torch.arange(TRAIN_BATCH, device=device) % 2,
           torch.ones(TRAIN_BATCH, dtype=torch.uint8, device=device))
    from psana_ray_tpu_torch.parallel import compat

    runs, grads, totals = {}, {}, {}
    compat.reset_collectives()
    for remat in (False, True):
        model = pt.vit_from_flax(params, device=device)
        # learning rate 0: every step sees the same weights, so the steps'
        # gradients are one gradient
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        step = pt.make_train_step(model, opt, lambda lg, a: pt.masked_softmax_xent(lg, *a),
                                  remat=remat)
        pt.reset_counters()
        timing = step_times(torch, lambda: step(x, aux), REMAT_STEPS, warmup=1)
        counts = pt.counts()
        n = REMAT_STEPS + 1
        fwd = VIT_DEPTH * n * (2 if remat else 1)  # the recomputed forward runs K5 again
        check_counts(counts, {"flash_kernel": fwd, "flash_bwd_kernel": VIT_DEPTH * n,
                              "flash_bwd_dq_convert": VIT_DEPTH * n}, f"remat={remat}")
        grads[remat] = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
        runs["remat" if remat else "plain"] = {**timing, "launches": counts}
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        del model, opt, step
    diff = {k: rel_err(grads[False][k], grads[True][k]) for k in grads[False]}
    worst = max(diff, key=diff.get)
    if not diff[worst] < REL_TOL or not all(bool(torch.isfinite(g).all())
                                            for g in grads[True].values()):
        raise AssertionError(f"remat gradients differ from the plain step's: {worst} {diff[worst]}")
    gen = torch.Generator(device=device).manual_seed(3)
    tokens = params["embed"]["pos_embed"].shape[1]
    q, k, v, do = (torch.randn(TRAIN_BATCH, 4, tokens, 128, generator=gen, device=device)
                   .bfloat16() for _ in range(4))
    o, lse = tf.launch_flash(q, k, v)
    errs = bwd_errors(tf.launch_flash_bwd(q, k, v, o, lse, do),
                      tf.attention_bwd_plain(q, k, v, o, lse, do))
    torch.cuda.synchronize()
    if not bwd_ok(errs):
        raise AssertionError(f"K6/K7 disagree with attention_bwd_plain: {errs}")
    emit("remat", batch=TRAIN_BATCH, steps=REMAT_STEPS, **runs,
         peak_ratio=runs["remat"]["peak_gib"] / runs["plain"]["peak_gib"],
         step_ratio=runs["remat"]["p50_ms"] / runs["plain"]["p50_ms"],
         grad_worst_leaf=worst, grad_worst_rel_err=diff[worst],
         grad_median_rel_err=float(np.median(list(diff.values()))), bwd_rel_err=errs,
         collectives=compat.collective_counts())
    return totals


def phase_multi_device(torch, pt, tf, timer, pool, consts, src, device):
    """Phases 20-22 (and 20b) on a one-rank NCCL group (``TCPStore`` on a
    free localhost port), destroyed after them. Returns the launch counts
    and the dry run's tally by variant (its ViT legs run in f32)."""
    import torch.distributed as dist

    from psana_ray_tpu_torch.parallel import compat

    from psana_ray_tpu_torch.parallel import mesh

    mesh.init_process_group(0, 1, mesh.free_port(), device=device)
    try:
        emit("nccl_group", backend=compat.backend_of(None), world_size=dist.get_world_size(),
             nccl_version=str(torch.cuda.nccl.version()))
        multichip, variants = phase_multichip(torch, pt, timer, pool, consts, src, device)
        multihost = phase_multihost(torch, pt, pool, consts, src, device)
        vit_parallel = phase_vit_parallel(torch, pt, tf, pool, consts, src.spec.frame_shape,
                                          device)
        remat = phase_remat(torch, pt, tf, pool, consts, src.spec.frame_shape, device)
    finally:
        dist.destroy_process_group()
    counts = {k: multichip[k] + multihost[k] + vit_parallel.get(k, 0) + remat.get(k, 0)
              for k in multichip}
    return counts, variants


def phase_profiler_loss(torch, device, root):
    """A defect of ``torch.profiler`` on the card's machine, measured, not
    gated: a capture of ``LOSS_MARKERS`` host-to-device copies of distinct
    sizes, one every 2 ms, each synchronised, and which of them have a
    device record in the exported trace. Late in a process that captured
    before, the first milliseconds' records go missing (their runtime
    calls stay); ``tools/profiler_capture_probe.py`` maps it by process
    age and capture start."""
    import shutil

    from psana_ray_tpu_torch.utils.trace import trace

    unit = 16384 * 4
    src = [torch.ones((k + 1) * unit // 4).pin_memory() for k in range(LOSS_MARKERS)]
    dst = [torch.empty_like(t, device=device) for t in src]
    torch.cuda.synchronize()
    logdir = os.path.join(root, "build", "chip_smoke", "trace_loss")
    shutil.rmtree(logdir, ignore_errors=True)
    age = time.monotonic() - STARTED
    with trace(logdir) as path:
        t0 = time.perf_counter()
        for k in range(LOSS_MARKERS):
            while time.perf_counter() - t0 < k * 0.002:
                pass
            dst[k].copy_(src[k], non_blocking=True)
            torch.cuda.synchronize()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    shutil.rmtree(logdir, ignore_errors=True)
    sizes = {e["args"].get("bytes") for e in events if e.get("cat") == "gpu_memcpy"}
    lost = [k for k in range(LOSS_MARKERS) if (k + 1) * unit not in sizes]
    calls = sum(e.get("cat") == "cuda_runtime" and e["name"] == "cudaMemcpyAsync"
                for e in events)
    emit("profiler_loss", process_age_s=age, markers=LOSS_MARKERS, runtime_calls=calls,
         lost=lost, lost_ms=[2.0 * k for k in lost])


def phase_build_f32(info):
    """``flash_f32.cu``'s kernels: registers and spills from ``-Xptxas -v``
    (a spill fails the run), and their machine code from ``cuobjdump
    -sass``: every product is a TF32 tensor-core instruction (``HMMA`` or
    ``HGMMA`` with a TF32 operand; the kernels' three-product split), so a
    kernel without them fails the run too. Counts by opcode, FFMA beside."""
    import re

    from psana_ray_tpu_torch.kernels import build

    rows = [{k: r.get(k) for k in ("function", "registers", "spill_stores", "spill_loads")}
            for r in info["ptxas"] if r["lib"] == "flash_f32"]
    cuobjdump = os.path.join(os.path.dirname(build._find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", os.path.join(info["dir"], "libflash_f32.so")],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    tf32 = {}  # TF32 tensor-core opcodes by kernel
    func = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            continue
        m = re.search(r"\b(H(?:G)?MMA\S*TF32\S*)", line)
        if m and func:
            ops = tf32.setdefault(func, {})
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    for r in rows:
        r["tf32_tensor_core"] = tf32.get(r["function"], {})
    emit("build_f32", kernels=rows, ffma=len(re.findall(r"\bFFMA\b", sass)), sass_bytes=len(sass))
    if (len(rows) != 4 or any(r["spill_stores"] + r["spill_loads"] for r in rows)
            or not all(r["tf32_tensor_core"] for r in rows)):
        raise AssertionError(f"flash_f32.cu: spills, or a kernel without TF32 tensor-core "
                             f"instructions: {rows}")


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
    phase_lint(root)

    info = build.build(counted=True)  # the counting builds for flash_kernel and flash_bwd
    emit("build", seconds=info["seconds"], dir=info["dir"], ptxas=info["ptxas"])
    # the wgmma kernels, the attention ones in their bf16 and f16 builds:
    # none may spill or serialize its wgmma; those of conv_sm90.cu and
    # flash.cu move 384 threads' 168 registers to their consumers with
    # setmaxnreg, so each must launch with exactly 168 (flash_bwd_kernel and
    # the wide kernels run 256 threads without setmaxnreg, and the dq
    # rounding pass of flash_bwd.cu is no wgmma kernel)
    wgmma_libs = ("conv_sm90", "flash", "flash_bwd", "flash_wide", "flash_bwd_wide",
                  *build.F16_LIBS)
    sm90 = [r for r in info["ptxas"] if r["lib"] in wgmma_libs
            and "dq_convert" not in r["function"]]
    emit("build_sm90", libraries={lib: sum(r["lib"] == lib for r in sm90) for lib in wgmma_libs},
         registers={lib: sorted({r.get("registers") for r in sm90 if r["lib"] == lib})
                    for lib in wgmma_libs},
         spills=sum(r["spill_stores"] + r["spill_loads"] for r in sm90),
         wgmma_serialized=[r["function"] for r in sm90 if r["wgmma_serialized"]],
         setmaxnreg_ignored=[r["function"] for r in sm90 if r["setmaxnreg_ignored"]])
    if ({r["lib"] for r in sm90} != set(wgmma_libs)
            or any(r["spill_stores"] + r["spill_loads"] or r["wgmma_serialized"]
                   or r["setmaxnreg_ignored"]
                   or (r["lib"] in ("conv_sm90", "flash", "flash_f16") and r.get("registers") != 168)
                   for r in sm90)):
        raise AssertionError(f"the wgmma kernels spill, serialize or lose setmaxnreg: {sm90}")
    phase_build_f32(info)
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
    shm_counts = phase_shm_end_to_end(torch, pt, pool, consts, model, params, device)
    npz = phase_passthrough_cli(pt, src, pool, root)
    try:
        phase_passthrough_tcp(pt, root, npz)
        tcp_counts, tcp = phase_tcp_end_to_end(torch, pt, pool, consts, model, params,
                                               device, root)
        durable_counts = phase_durable_end_to_end(torch, pt, pool, consts, model, params,
                                                  device, root, tcp["relay_gbytes_per_s"])
        failover_counts = phase_durable_failover(torch, pt, pool, consts, model, params,
                                                 device, root)
        phase_passthrough_durable(pt, root, npz)
        cluster_counts = phase_cluster_end_to_end(torch, pt, pool, consts, model, params,
                                                  device, root, tcp)
        cluster_failover_counts = phase_cluster_failover(torch, pt, pool, consts, model,
                                                         params, device, root)
        phase_passthrough_cluster(pt, root, npz)
        repl_counts = phase_replicated_end_to_end(torch, pt, pool, consts, model, params,
                                                  device, root)
        repl_failover_counts = phase_replicated_failover(torch, pt, pool, consts, model,
                                                         params, device, root)
        # the process's first profiler capture, after the TCP phases
        trace_counts = phase_stage_trace(torch, pt, pool, consts, params, device, root, npz)
    finally:
        os.remove(npz)
    phase_profile(torch, pt, pool, consts, params, device)
    phase_tcp_profile(torch, pt, pool, consts, params, device, root)
    observed_counts = phase_observed_end_to_end(torch, pt, pool, consts, model, params, device,
                                                root)
    profiled_counts = phase_profiled_end_to_end(torch, pt, pool, consts, model, params, device,
                                                root)
    gateway_counts = phase_gateway_end_to_end(torch, pt, pool, consts, model, params, device,
                                              root)
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
    del train
    variant_runs = {phase: phase_vit_variant(torch, pt, tf, pool, consts, src.spec.frame_shape,
                                             device, phase, dtype, heads)
                    for phase, dtype, heads in VIT_VARIANTS}
    phase_narrow(torch, pt, device)
    peaknet_counts, peaknet, served = phase_peaknet_train(torch, pt, pool, calib_np, device,
                                                          root)
    phase_peaknet_train_profile(torch, pt, peaknet, pool, calib_np, device)
    del peaknet
    fanin_counts = phase_fanin(torch, pt, device)
    cli_counts = phase_sfx_cli(torch, pt, device, root, served)
    cli_sfx_counts = phase_producer_cli_sfx(pt, root, served)
    cli_sfx_tcp_counts = phase_producer_cli_sfx(pt, root, served, tcp=True)
    tuned_counts = phase_tuned_end_to_end(pt, pool, root, served)
    fold_counts = phase_resnet_fold(torch, pt, pool, consts, device)
    md_counts, md_variants = phase_multi_device(torch, pt, tf, timer, pool, consts, src, device)
    phase_profiler_loss(torch, device, root)

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
                     + cli_sfx_counts["calib_kernel"] + tcp_counts["calib_kernel"]
                     + cli_sfx_tcp_counts["calib_kernel"] + durable_counts["calib_kernel"]
                     + failover_counts["calib_kernel"] + cluster_counts["calib_kernel"]
                     + cluster_failover_counts["calib_kernel"] + repl_counts["calib_kernel"]
                     + repl_failover_counts["calib_kernel"]
                     + observed_counts["calib_kernel"] + profiled_counts["calib_kernel"]
                     + gateway_counts["calib_kernel"] + tuned_counts["calib_kernel"]
                     + md_counts["calib_kernel"]
                     + sum(c["calib_kernel"] for c, _ in variant_runs.values())),
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
            "launches": (counts[name] + shm_counts[name] + fold_counts[name] + trace_counts[name]
                         + tcp_counts[name] + durable_counts[name] + failover_counts[name]
                         + cluster_counts[name] + cluster_failover_counts[name]
                         + repl_counts[name] + repl_failover_counts[name]
                         + observed_counts[name] + profiled_counts[name]
                         + gateway_counts[name] + md_counts[name]),
            "max_abs_err": agg["max_abs_err"], "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"], "bound_by": agg["bound_by"],
            "library_ms": agg["library_ms"],
        })
    kernels.append({
        "name": "conv_block_kernel", "route": "cuda", "source": f"{csrc}/conv_sm90.cu",
        "replaces": "psana_ray_tpu/models/pallas_unet.py:55",
        "launches": (sfx_counts["conv_block_kernel"] + peaknet_counts["conv_block_kernel"]
                     + cli_counts["conv_block_kernel"] + cli_sfx_counts["conv_block_kernel"]
                     + cli_sfx_tcp_counts["conv_block_kernel"]
                     + tuned_counts["conv_block_kernel"]),
        "max_abs_err": conv_block["max_abs_err"],
        "ms": conv_block["ms"], "plain_ms": conv_block["plain_ms"],
        "bound_ms": conv_block["bound_ms"], "bound_by": conv_block["bound_by"],
        "library_ms": conv_block["library_ms"],
    })
    # launches by Hopper kernel: the bf16 head-dim-128 ViT's phases launch
    # only flash_kernel and flash_bwd_kernel; the dry run's f32 ViT legs and
    # the vit_f32, vit_wide and vit_f16 phases are tallied by variant
    # (vit_heads8 takes the XLA route and launches none)
    variants = add_counts(md_variants, *(v for _, v in variant_runs.values()))
    md_f32 = {k: variant_sum(md_variants, k) for k in ("flash_f32_kernel", "flash_bwd_f32_kernel")}
    f = flash["serving"]  # one batch of the main path: VIT_DEPTH launches at this shape
    kernels.append({
        "name": "flash_kernel", "route": "cuda", "source": f"{csrc}/flash.cu",
        "replaces": "psana_ray_tpu/parallel/flash.py:155",
        "launches": (vit_counts["flash_kernel"] + train_counts["flash_kernel"]
                     + md_counts["flash_kernel"] - md_f32["flash_f32_kernel"]),
        "max_abs_err": max(r["max_abs_err_o"] for r in flash.values()
                           if r.get("kernel") == "flash_kernel" and r["dtype"] == "bf16"),
        "ms": VIT_DEPTH * f["ms"], "plain_ms": VIT_DEPTH * f["plain_ms"],
        "bound_ms": VIT_DEPTH * f["bound_ms"], "bound_by": f["bound_by"],
        "library_ms": VIT_DEPTH * f["library_ms"],
    })
    # the wide, f32 and f16 forwards: one batch of their ViT at the serving
    # shape (f16: the f16 build of flash_kernel, row flash_kernel_f16)
    for name, source, key, dt in (("flash_wide_kernel", "flash_wide.cu", "serving/bf16/256", "bf16"),
                                  ("flash_f32_kernel", "flash_f32.cu", "serving/f32/128", "f32"),
                                  ("flash_kernel", "flash.cu", "serving/f16/128", "f16")):
        r = flash[key]
        kernels.append({
            "name": f"{name}_f16" if dt == "f16" else name, "route": "cuda",
            "source": f"{csrc}/{source}",
            "replaces": "psana_ray_tpu/parallel/flash.py:155",
            "launches": variant_sum(variants, name, dt),
            "max_abs_err": max(x["max_abs_err_o"] for x in flash.values()
                               if x.get("kernel") == name and x["dtype"] == dt),
            "ms": VIT_DEPTH * r["ms"], "plain_ms": VIT_DEPTH * r["plain_ms"],
            "bound_ms": VIT_DEPTH * r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": VIT_DEPTH * r["library_ms"],
        })
    # K6 and K7 are one kernel in each variant: both rows give the pair's
    # numbers (one train step: VIT_DEPTH launches at the training shape), and
    # the SDPA backward (dq, dk and dv in one call) is given once, with K6
    for name, source, key, dt in (
            ("flash_bwd_kernel", "flash_bwd.cu", "training", "bf16"),
            ("flash_bwd_wide_kernel", "flash_bwd_wide.cu", "serving/bf16/256", "bf16"),
            ("flash_bwd_f32_kernel", "flash_f32.cu", "serving/f32/128", "f32"),
            ("flash_bwd_kernel", "flash_bwd.cu", "serving/f16/128", "f16")):
        tb = flash_bwd[key]
        launches = (train_counts["flash_bwd_kernel"] + md_counts["flash_bwd_kernel"]
                    - md_f32["flash_bwd_f32_kernel"] if (name, dt) == ("flash_bwd_kernel", "bf16")
                    else variant_sum(variants, name, dt))
        for line, grads in ((314, ("dk", "dv")), (354, ("dq",))):
            kernels.append({
                "name": f"{name}_f16" if dt == "f16" else name, "route": "cuda",
                "source": f"{csrc}/{source}",
                "replaces": f"psana_ray_tpu/parallel/flash.py:{line}",
                "launches": launches,
                "max_abs_err": max(r["max_abs_err"][g] for r in flash_bwd.values()
                                   if r.get("kernel") == name and r["dtype"] == dt
                                   for g in grads),
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
