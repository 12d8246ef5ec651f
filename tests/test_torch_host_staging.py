"""The port's consumer host plane: ``push_view``, batch arenas and their
fences, the pipeline's copy counts, and the shm-fed slice against the
JAX package's pipeline.

On the CPU the arenas are plain numpy (pinning needs a card), so the
fence is checked with a stub event; ``tests/test_torch_gpu.py`` holds the
pinned arenas on the card. The slice test feeds the same RAW frames
through a shm ring into the JAX package's ``InfeedPipeline`` (its Pallas
calibration and fused ResNet in interpret mode) and into the port's
``InfeedPipeline`` (the plain versions of the kernels), and holds the
logits to the fused nets' bound, ``rel_err < 0.05``.
"""

import os
import platform
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from psana_ray_tpu_torch.infeed import FrameBatcher, InfeedPipeline, PipelineMetrics  # noqa: E402
from psana_ray_tpu_torch.infeed import batches_from_queue  # noqa: E402
from psana_ray_tpu_torch.producer import produce  # noqa: E402
from psana_ray_tpu_torch.records import EndOfStream, FrameRecord  # noqa: E402
from psana_ray_tpu_torch.transport import EMPTY, RingBuffer, ShmRingBuffer  # noqa: E402
from psana_ray_tpu_torch.utils import enable_large_alloc_reuse  # noqa: E402

REL_TOL = 0.05


def _name(tag):
    return f"staging_{tag}_{os.getpid()}_{time.monotonic_ns() % 10**9}"


def _rec(i, shape=(2, 3, 4)):
    return FrameRecord(0, i, np.full(shape, i + 1, np.float32), 8.0 + i)


class _OrderLease:
    """A lease that records what the batch arena held when it was released."""

    def __init__(self, batcher, log):
        self.batcher, self.log = batcher, log

    def release(self):
        arena = self.batcher._cur or self.batcher.pool[(self.batcher._pool_i - 1) % 2]
        self.log.append(float(arena.arrays[0].reshape(-1)[0]))


def test_push_view_releases_the_lease_after_the_copy():
    b = FrameBatcher(batch_size=2, n_buffers=2)
    log = []
    rec = _rec(6)
    object.__setattr__(rec, "lease", _OrderLease(b, log))
    assert b.push_view(rec) is None
    assert log == [7.0]  # the arena already held the frame when the lease went back
    assert rec.lease is None
    bad = _rec(1, shape=(2, 3, 5))  # a push that raises still releases
    object.__setattr__(bad, "lease", _OrderLease(b, log))
    with pytest.raises(ValueError, match="locked shape"):
        b.push_view(bad)
    assert len(log) == 2 and bad.lease is None
    assert b.push_view(_rec(2)).copied_bytes == 2 * _rec(0).nbytes  # owned records: no lease


class _StubEvent:
    def __init__(self, arena):
        self.arena, self.seen = arena, []

    def synchronize(self):
        self.seen.append(float(self.arena.arrays[0].reshape(-1)[0]))


def test_the_batcher_waits_on_an_arenas_fence_before_writing_it():
    b = FrameBatcher(batch_size=1, n_buffers=2)
    first = b.push(_rec(0))
    fence = _StubEvent(first.arena)
    first.arena.fence = fence  # the prefetcher's copy out of this arena
    assert b.push(_rec(1)).arena is not first.arena
    assert fence.seen == []
    third = b.push(_rec(2))
    assert third.arena is first.arena and third.frames is first.frames
    assert fence.seen == [1.0]  # waited while the arena still held event 0
    assert third.frames[0, 0, 0, 0] == 3.0 and first.arena.fence is None


def test_leftover_views_are_materialized_before_they_go_back():
    """After the completing EOS, frames popped with it go back to the ring.
    Here a producer takes the slot the EOS freed, so the ring's next free
    slot is the leftover's own: the put succeeds only because the
    leftover was copied out of its slot (materialized) first."""
    ring = ShmRingBuffer.create(_name("leftover"), maxsize=2, slot_bytes=4096)
    try:
        assert ring.put(EndOfStream()) and ring.put(_rec(1))

        class Refilling:
            def __init__(self):
                self.refilled = False

            def get_batch_view(self, n, timeout=None):
                items = ring.get_batch_view(n, timeout=timeout)
                if items and not self.refilled:
                    self.refilled = True
                    assert ring.put(_rec(9))  # into the EOS's slot
                return items

            def __getattr__(self, name):
                return getattr(ring, name)

        assert list(batches_from_queue(Refilling(), batch_size=4)) == []
        assert ring._slot_leases == 0
        back = []
        while (item := ring.get()) is not EMPTY:
            back.append(item.event_idx)
        assert back == [9, 1]
    finally:
        ring.destroy()


def test_the_buffer_floor_still_holds():
    with pytest.raises(ValueError, match="prefetch_depth \\+ 4"):
        InfeedPipeline(RingBuffer(4), batch_size=2, device="cpu", prefetch_depth=3,
                       batcher_buffers=6)
    with InfeedPipeline(RingBuffer(4), batch_size=2, device="cpu", prefetch_depth=3,
                        batcher_buffers=7) as pipe:
        assert pipe.batcher.n_buffers == 7


def test_cpu_arenas_are_numpy_and_the_host_copies_each_frame_once():
    q = RingBuffer(64)
    n, b = 22, 4
    produce(((i, np.full((2, 8, 8), i, np.float32), 1.0) for i in range(n)), q)
    pipe = InfeedPipeline(q, batch_size=b, device="cpu", batcher_buffers=6,
                          metrics=PipelineMetrics(warmup=2))
    seen = []
    assert pipe.run(lambda batch: seen.extend(batch.event_idx[batch.valid.bool()].tolist())) == n
    assert sorted(seen) == list(range(n))
    pool = pipe.batcher.pool
    assert len(pool) == 6 and all(a.tensors is None and isinstance(a.arrays[0], np.ndarray)
                                  for a in pool)
    s = pipe.metrics.summary()
    assert s["batches"] == 6 - 2 and s["frames"] == n - 2 * b  # warm-up batches left out
    assert s["host_frame_bytes_per_frame"] == 2 * 8 * 8 * 4 and s["arena_copies"] == 0
    assert pipe.metrics.staged == 4 and pipe.metrics.staged_frames == n


class _Sink:
    max_peaks = 64

    def __init__(self):
        self.sets = []

    def append(self, sets):
        self.sets.extend(sets)


def test_sfx_run_reuses_its_pooled_arenas():
    """``SfxPipeline.run`` stages through ``PREFETCH_DEPTH + 4`` pooled
    arenas (numpy on the CPU): a stream of more batches than arenas writes
    what the serial ``process_batch`` writes, batch by batch."""
    import psana_ray_tpu_torch as pt
    from psana_ray_tpu_torch import sfx

    src = pt.SyntheticSource(num_events=20, detector_name="smoke_a", seed=3)
    events = list(src.iter_indexed_events("raw"))
    calib = (src.pedestal(), src.spec.adu_gain * src.gain_map(), src.create_bad_pixel_mask())
    tree = pt.init_peaknet_tpu_params((8, 16), seed=0)
    cfg = pt.SfxConfig(batch_size=2)
    ring = RingBuffer(len(events) + 1)
    produce(events, ring)
    piped, serial = _Sink(), _Sink()
    pipe = pt.SfxPipeline(tree, piped, calib=calib, config=cfg, device="cpu")
    assert pipe.run(ring) == len(events)
    assert pipe.batcher.n_buffers == sfx.PREFETCH_DEPTH + 4 == 6
    assert len(pipe.batcher.pool) == 6 < len(events) // cfg.batch_size
    one = pt.SfxPipeline(tree, serial, calib=calib, config=cfg, device="cpu")
    batcher = FrameBatcher(cfg.batch_size)
    for idx, data, energy in events:
        out = batcher.push(FrameRecord(0, idx, data, energy))
        if out is not None:
            one.process_batch(out)
    assert [s.event_idx for s in piped.sets] == [s.event_idx for s in serial.sets] == list(
        range(len(events)))
    for s, t in zip(piped.sets, serial.sets):
        np.testing.assert_array_equal(s.y, t.y)
        np.testing.assert_array_equal(s.x, t.x)
        np.testing.assert_array_equal(s.intensity, t.intensity)
    assert sum(len(s.y) for s in piped.sets) > 0


def test_enable_large_alloc_reuse_applies_on_glibc():
    if platform.libc_ver()[0] != "glibc":
        pytest.skip("glibc's mallopt only")
    assert enable_large_alloc_reuse() is True


# -- the slice: a shm ring into each package's pipeline ----------------------

STAGES = (1, 1, 1, 1)


def _rel_err(ref, got):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-3))


def test_shm_fed_slice_matches_the_jax_pipeline():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import psana_ray_tpu_torch as pt
    from psana_ray_tpu import records as ref_records
    from psana_ray_tpu.infeed.pipeline import InfeedPipeline as JaxPipeline
    from psana_ray_tpu.models import panels_to_nhwc as jax_panels_to_nhwc
    from psana_ray_tpu.models.pallas_resnet import resnet_fused_infer as jax_infer
    from psana_ray_tpu.ops.pallas_calib import fused_calibrate as jax_calibrate
    from psana_ray_tpu.transport.shm_ring import ShmRingBuffer as RefShmRing

    rng = np.random.default_rng(9)
    n, b, p, h, w = 6, 4, 2, 32, 32
    ped = (100.0 + 3.0 * rng.standard_normal((p, h, w))).astype(np.float32)
    gain = (1.0 + 0.02 * rng.standard_normal((p, h, w))).astype(np.float32)
    mask = (rng.random((p, h, w)) > 0.01).astype(np.uint8)
    raw = (ped + 35.0 * rng.poisson(0.1, (n, p, h, w)) * gain
           + rng.normal(0, 2.5, (n, p, h, w))).astype(np.float32)
    params = pt.init_resnet_params(in_channels=p, stage_sizes=STAGES, width=16, seed=0)

    # the JAX package's pipeline, fed from its own shm ring
    ref_ring = RefShmRing.create(_name("jax"), maxsize=8, slot_bytes=64 * 1024)
    jparams = {"params": jax.tree.map(jnp.asarray, params)}
    jconsts = tuple(jnp.asarray(a) for a in (ped, gain, mask))

    def jax_step(batch):
        cal = jax_calibrate(batch.frames, *jconsts, threshold=10.0, out_dtype=jnp.bfloat16,
                            interpret=True)
        return jax_infer(jparams, jax_panels_to_nhwc(cal), stage_sizes=STAGES, interpret=True)

    want = {}
    try:
        for i in range(n):
            assert ref_ring.put(ref_records.FrameRecord(0, i, raw[i], 9.0))
        assert ref_ring.put(ref_records.EndOfStream(total_events=n))

        def keep_ref(out, batch):
            for row, idx in enumerate(np.asarray(batch.event_idx)[:batch.num_valid]):
                want[int(idx)] = np.asarray(out)[row]

        JaxPipeline(ref_ring, batch_size=b).run(jax_step, on_result=keep_ref)
    finally:
        ref_ring.destroy()

    # the port's pipeline, fed by the port's ring
    ring = ShmRingBuffer.create(_name("port"), maxsize=8, slot_bytes=64 * 1024)
    model = pt.resnet_from_flax(params, STAGES, device="cpu")
    packed = pt.pack_fused(model)
    consts = tuple(torch.from_numpy(a) for a in (ped, gain, mask))

    def step(batch):
        cal = pt.fused_calibrate(batch.frames, *consts, threshold=10.0, out_dtype=torch.bfloat16)
        return pt.resnet_fused_infer(packed, pt.panels_to_nhwc(cal), STAGES)

    got = {}
    try:
        produce(((i, raw[i], 9.0) for i in range(n)), ring)

        def keep(out, batch):
            for row, idx in enumerate(batch.event_idx[:batch.num_valid].tolist()):
                got[idx] = out[row].numpy()

        pipe = InfeedPipeline(ring, batch_size=b, device="cpu", batcher_buffers=6)
        assert pipe.run(step, on_result=keep) == n
        assert ring._slot_leases == 0 and ring.stats()["bytes_copied_out"] == 0
    finally:
        ring.destroy()
    assert sorted(want) == sorted(got) == list(range(n))
    ref, ours = np.stack([want[i] for i in range(n)]), np.stack([got[i] for i in range(n)])
    assert np.isfinite(ours).all() and ours.shape == (n, 2)
    err = _rel_err(ref, ours)
    print(f"logits rel_err {err}")  # observed values: pytest -rP
    assert err < REL_TOL
