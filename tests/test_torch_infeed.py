"""The port's host plane: source, records, ring, producer loop, batcher and
the infeed pipeline on the CPU.

The synthetic source must give bit-identical frames and constants to the
JAX package's for the same seed; the rest is held to the JAX package's
semantics (EOS coverage, close, padding, prefetch-depth guard).
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference package below imports it

from psana_ray_tpu.sources.synthetic import SyntheticSource as JaxSource  # noqa: E402
from psana_ray_tpu_torch.infeed import (  # noqa: E402
    Batch,
    DevicePrefetcher,
    FrameBatcher,
    InfeedPipeline,
    PipelineMetrics,
    StopStream,
    batches_from_queue,
    drive_step,
)
from psana_ray_tpu_torch.producer import produce  # noqa: E402
from psana_ray_tpu_torch.records import EndOfStream, EosTally, FrameRecord  # noqa: E402
from psana_ray_tpu_torch.sources import DETECTORS, RetrievalMode, SyntheticSource, shard_indices  # noqa: E402
from psana_ray_tpu_torch.transport import EMPTY, RingBuffer, TransportClosed  # noqa: E402


@pytest.mark.parametrize("seed", [0, 11])
def test_synthetic_source_is_bit_identical_to_jax_package(seed):
    kw = dict(detector_name="epix10k2M", num_events=3, seed=seed)
    ours, ref = SyntheticSource(**kw), JaxSource(**kw)
    np.testing.assert_array_equal(ours.pedestal(), ref.pedestal())
    np.testing.assert_array_equal(ours.gain_map(), ref.gain_map())
    np.testing.assert_array_equal(ours.create_bad_pixel_mask(), ref.create_bad_pixel_mask())
    for idx, mode in ((0, RetrievalMode.RAW), (2, RetrievalMode.CALIB)):
        (a, ea), (b, eb) = ours.event(idx, mode), ref.event(idx, mode)
        assert a.dtype == b.dtype and a.shape == (16, 352, 384)
        np.testing.assert_array_equal(a, b)
        assert ea == eb


def test_synthetic_source_integer_dtype_and_shards_match():
    kw = dict(detector_name="jungfrau4M", num_events=4, seed=5, dtype="uint16",
              num_shards=2, shard_rank=1)
    ours, ref = SyntheticSource(**kw), JaxSource(**kw)
    assert list(ours.shard_event_indices()) == list(ref.shard_event_indices()) == [1, 3]
    for (i, a, ea), (j, b, eb) in zip(ours.iter_indexed_events("raw"),
                                      ref.iter_indexed_events("raw")):
        assert i == j and ea == eb and a.dtype == np.uint16
        np.testing.assert_array_equal(a, b)


def test_detector_specs_and_shards():
    assert DETECTORS["epix10k2M"].frame_shape == (16, 352, 384)
    assert DETECTORS["jungfrau4M"].frame_shape == (8, 512, 1024)
    parts = [shard_indices(10, r, 3) for r in range(3)]
    assert sorted(np.concatenate(parts).tolist()) == list(range(10))
    with pytest.raises(ValueError):
        shard_indices(10, 3, 3)
    with pytest.raises(ValueError, match="unknown detector"):
        SyntheticSource(detector_name="cspad")


# -- ring ------------------------------------------------------------------


def test_ring_put_get_and_sentinels():
    q = RingBuffer(maxsize=2)
    assert q.get() is EMPTY
    assert q.put(1) and q.put(2)
    assert q.put(3) is False  # full: backpressure, nothing dropped
    assert q.size() == 2
    assert q.get() == 1
    assert q.get_batch(5) == [2]
    assert q.get_wait(timeout=0.01) is EMPTY
    assert q.get_batch(5, timeout=0.01) == []
    assert q.put_wait(4, timeout=0.01) and q.put_wait(5, timeout=0.01)
    assert q.put_wait(6, timeout=0.01) is False
    with pytest.raises(ValueError):
        RingBuffer(maxsize=0)


def test_ring_close_wakes_waiters():
    q = RingBuffer(maxsize=1)
    errs = []

    def waiter():
        try:
            q.get_wait(timeout=10.0)
        except TransportClosed as e:
            errs.append(e)

    t = threading.Thread(target=waiter)
    t.start()
    q.close()
    t.join(timeout=5.0)
    assert not t.is_alive() and len(errs) == 1
    assert q.closed
    for op in (lambda: q.put(1), q.get, lambda: q.get_batch(1), lambda: q.put_wait(1, 0.01)):
        with pytest.raises(TransportClosed):
            op()


# -- records, producer ---------------------------------------------------------


def test_frame_record_adds_panel_axis():
    rec = FrameRecord(0, 3, np.zeros((4, 5), np.float32), 9.5)
    assert rec.panels.shape == (1, 4, 5) and rec.nbytes == 80
    with pytest.raises(ValueError):
        FrameRecord(0, 0, np.zeros(3), 1.0)


def test_eos_tally_needs_every_shard():
    tally = EosTally()
    assert not tally.process(EndOfStream(producer_rank=0, total_shards=2))
    assert not tally.process(EndOfStream(producer_rank=0, total_shards=2))  # sibling's copy
    q = RingBuffer(4)
    assert tally.flush_duplicates(q) == 1 and isinstance(q.get(), EndOfStream)
    assert tally.process(EndOfStream(producer_rank=1, total_shards=2))


def test_produce_puts_events_then_one_eos():
    q = RingBuffer(16)
    src = SyntheticSource(detector_name="epix10k2M", num_events=2, seed=1)
    small = ((i, d[:2, :8, :8], e) for i, d, e in src.iter_indexed_events("raw"))
    assert produce(small, q, shard_rank=0) == 2
    items = q.get_batch(10)
    assert [r.event_idx for r in items[:2]] == [0, 1]
    assert isinstance(items[2], EndOfStream) and items[2].total_events == 2


def test_produce_times_out_on_a_full_queue():
    q = RingBuffer(1)
    with pytest.raises(TimeoutError):
        produce(((i, np.zeros((1, 2, 2)), 1.0) for i in range(3)), q, timeout=0.05)


# -- batcher ------------------------------------------------------------------


def _rec(i, shape=(2, 4, 4)):
    return FrameRecord(0, i, np.full(shape, i + 1, np.float32), 8.0 + i)


def test_batcher_pads_the_tail():
    b = FrameBatcher(batch_size=2)
    out = [b.push(_rec(i)) for i in range(5)]
    full = [o for o in out if o is not None]
    assert len(full) == 2 and all(o.num_valid == 2 for o in full)
    assert b.pending == 1
    tail = b.flush()
    assert tail.num_valid == 1 and tail.batch_size == 2
    assert tail.valid.tolist() == [1, 0]
    assert np.all(tail.frames[1] == 0) and tail.event_idx.tolist() == [4, 0]
    assert b.flush() is None
    with pytest.raises(ValueError, match="locked shape"):
        b.push(_rec(9, shape=(2, 4, 5)))


def test_batcher_pool_reuses_buffers():
    b = FrameBatcher(batch_size=1, n_buffers=2)
    first, second, third = (b.push(_rec(i)) for i in range(3))
    assert third.frames is first.frames and second.frames is not first.frames


def test_batches_from_queue_waits_for_every_shard():
    q = RingBuffer(32)
    for i in range(3):
        q.put(_rec(i))
    q.put(EndOfStream(producer_rank=0, total_shards=2))
    q.put(_rec(3))
    q.put(EndOfStream(producer_rank=1, total_shards=2))
    batches = list(batches_from_queue(q, batch_size=3, poll_interval_s=0.01))
    assert [bt.num_valid for bt in batches] == [3, 1]
    assert batches[-1].valid.tolist() == [1, 0, 0]


def test_batches_from_queue_flushes_on_close_and_on_starvation():
    q = RingBuffer(8)
    q.put(_rec(0))
    it = batches_from_queue(q, batch_size=4, poll_interval_s=0.01, max_wait_s=0.05)
    (tail,) = list(it)
    assert tail.num_valid == 1
    q.put(_rec(1))
    it = batches_from_queue(q, batch_size=4, poll_interval_s=0.01)
    first = []

    def drain():
        first.extend(it)

    t = threading.Thread(target=drain)
    t.start()
    deadline = time.monotonic() + 5.0
    while q.size() and time.monotonic() < deadline:  # the record is in the batcher
        time.sleep(0.005)
    q.close()
    t.join(timeout=5.0)
    assert [bt.num_valid for bt in first] == [1]


# -- pipeline --------------------------------------------------------------------


def test_pipeline_on_cpu_delivers_exactly_the_events_produced():
    q = RingBuffer(8)
    src = SyntheticSource(detector_name="epix10k2M", num_events=1, seed=2)
    frame = src.event(0, "raw")[0][:4, :16, :16]
    n = 11
    t = threading.Thread(
        target=produce, args=(((i, frame + i, 9.0) for i in range(n)), q), daemon=True)
    t.start()
    seen = []

    def step(batch):
        assert isinstance(batch.frames, torch.Tensor) and batch.frames.device.type == "cpu"
        valid = batch.valid.bool()
        seen.extend(batch.event_idx[valid].tolist())
        return batch.frames.sum()

    pipe = InfeedPipeline(q, batch_size=4, device="cpu", prefetch_depth=2)
    assert pipe.run(step, block_until_ready=True) == n
    t.join(timeout=5.0)
    assert sorted(seen) == list(range(n))
    s = pipe.metrics.summary()
    assert s["frames"] == n and s["batches"] == 3 and s["p50_ms"] >= 0
    assert s["bytes"] == 3 * 4 * frame.nbytes
    assert pipe.metrics.staged == 3 and s["host_batch_ms"] >= 0 and s["host_stage_ms"] >= 0


def test_pipeline_stop_stream_ends_early():
    q = RingBuffer(64)
    for i in range(20):
        q.put(_rec(i))
    q.put(EndOfStream())

    def step(batch):
        if batch.event_idx[0] >= 4:
            raise StopStream

    pipe = InfeedPipeline(q, batch_size=2, device="cpu")
    assert pipe.run(step) == 4


def test_prefetch_depth_dial_and_buffer_guard():
    with pytest.raises(ValueError, match="prefetch_depth \\+ 4"):
        InfeedPipeline(RingBuffer(4), batch_size=2, device="cpu", prefetch_depth=2,
                       batcher_buffers=5)
    with InfeedPipeline(RingBuffer(4), batch_size=2, device="cpu", prefetch_depth=2,
                        batcher_buffers=8) as pipe:
        assert pipe.set_prefetch_depth(10) == 4  # clipped to batcher_buffers - 4
        assert pipe.prefetch_depth == 4
        assert pipe.set_prefetch_depth(0) == 1
    with pytest.raises(ValueError):
        DevicePrefetcher(iter([]), device="cpu", prefetch_depth=0)


def test_prefetcher_surfaces_source_errors_in_the_consumer():
    def source():
        yield Batch(np.zeros((1, 1, 2, 2), np.float32), np.ones(1, np.uint8),
                    np.zeros(1, np.int32), np.zeros(1, np.int64), np.zeros(1, np.float32))
        raise OSError("detector went away")

    pf = DevicePrefetcher(source(), device="cpu")
    assert next(pf).num_valid == 1
    with pytest.raises(OSError, match="went away"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InfeedPipeline(RingBuffer(4), batch_size=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DevicePrefetcher(iter([]), device="cuda")


def test_drive_step_records_latency():
    m = PipelineMetrics()
    batch = Batch(torch.zeros(2, 1, 2, 2), torch.ones(2), torch.zeros(2), torch.zeros(2),
                  torch.zeros(2), num_valid=2)
    assert drive_step(m, lambda b: 7, batch) == 7
    assert m.frames == 2 and m.bytes == 32 and len(m.latencies_s) == 1
