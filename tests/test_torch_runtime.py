"""The port's ProducerRuntime and DataReader against the JAX package's.

Every case of ``tests/test_runtime.py`` that needs no TCP, on the port
over ``auto`` (the in-process registry) and over ``shm://`` (a ring
made small for the test): every event once with EOS last, one EOS a
consumer, ``max_steps``, the host-side mask, a queue that dies
mid-stream, disjoint shards, the reader's errors, EOS coverage across
two runtimes, two consumers of two runtimes, a sibling's EOS held
against a full queue, ``stop`` leaving frames for siblings, the sender's
partial batch accepts, and the launcher topology from Open MPI, PMI and
Slurm. Then the two packages' runtimes on one config give the same
records, bit for bit.
"""

import os
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from psana_ray_tpu_torch.config import (  # noqa: E402
    MaskConfig,
    PipelineConfig,
    RetrievalMode,
    SourceConfig,
    TransportConfig,
)
from psana_ray_tpu_torch.consumer import DataReader, DataReaderError  # noqa: E402
from psana_ray_tpu_torch.producer import ProducerRuntime, parse_arguments  # noqa: E402
from psana_ray_tpu_torch.records import EndOfStream, EosTally, FrameRecord, is_eos  # noqa: E402
from psana_ray_tpu_torch.transport import (  # noqa: E402
    EMPTY,
    Registry,
    RingBuffer,
    ShmRingBuffer,
)

DETECTOR = "smoke_a"  # the IMAGE mosaic of one event is [1, 32, 128] f32, 16 KiB
SLOT_BYTES = 64 * 1024


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    Registry.reset_default()
    yield
    Registry.reset_default()


class Stream:
    """One named queue over ``auto`` or ``shm://``: its address, and the
    handles a test makes, attaches and kills. An shm ring is made here,
    with small slots, before a runtime opens it (a producer attaches to a
    ring that exists), and destroyed after the test."""

    def __init__(self, kind: str):
        self.kind = kind
        self.name = f"rt_{os.getpid()}_{time.monotonic_ns() % 10**9}"
        self.address = f"shm://{self.name}" if kind == "shm" else "auto"
        self._handles = []

    def config(self, num_events=12, num_consumers=1, queue_size=64, **src_kw):
        if self.kind == "shm" and not self._handles:
            self.create(queue_size)
        return PipelineConfig(
            source=SourceConfig(exp="synthetic", run=1, detector_name=DETECTOR,
                                num_events=num_events, **src_kw),
            transport=TransportConfig(address=self.address, num_consumers=num_consumers,
                                      queue_size=queue_size),
        )

    def create(self, maxsize):
        if self.kind == "auto":
            return Registry.default().get_or_create(
                "default", "shared_queue", lambda: RingBuffer(maxsize))
        ring = ShmRingBuffer.create(self.name, maxsize=maxsize, slot_bytes=SLOT_BYTES)
        self._handles.append(ring)
        return ring

    def attach(self):
        if self.kind == "auto":
            return Registry.default().resolve("default", "shared_queue", retries=1,
                                              interval_s=0.1)
        ring = ShmRingBuffer.attach(self.name, retries=1, interval_s=0.1)
        self._handles.append(ring)
        return ring

    def reader(self, **kw) -> DataReader:
        return DataReader(address=self.address, **kw)

    def kill(self):
        if self.kind == "auto":
            Registry.default().destroy("default", "shared_queue")
        else:
            self.attach().close()

    def drain(self, timeout=0.5):
        q = self.attach()
        return list(iter(lambda: q.get_wait(timeout=timeout), EMPTY))

    def cleanup(self):
        if self._handles:
            self._handles[0].destroy()
        for h in self._handles[1:]:
            h.disconnect()


@pytest.fixture(params=["auto", "shm"])
def stream(request):
    s = Stream(request.param)
    yield s
    s.cleanup()


def _frame(i):
    return FrameRecord(0, i, np.zeros((1, 2, 2), np.float32), 1.0)


class TestProducerRuntime:
    def test_end_to_end_all_events_then_eos(self, stream):
        rt = ProducerRuntime(stream.config(num_events=10), num_local_shards=2)
        rt.run(block=False)
        got, eos = [], []
        with stream.reader() as reader:
            while True:
                item = reader.read_wait(timeout=5.0)
                if item is None:
                    pytest.fail("starved before EOS")
                if is_eos(item):
                    eos.append(item)
                    break
                got.append(item)
        rt.join()
        assert sorted(r.event_idx for r in got) == list(range(10))  # each once, EOS last
        assert len(eos) == 1
        assert rt.metrics.frames.count == 10

    def test_eos_per_consumer(self, stream):
        rt = ProducerRuntime(stream.config(num_events=4, num_consumers=3), num_local_shards=1)
        rt.run(block=True)
        q = stream.attach()
        items = [q.get_wait(timeout=1.0) for _ in range(7)]
        assert sum(is_eos(i) for i in items) == 3

    def test_max_steps(self, stream):
        rt = ProducerRuntime(stream.config(num_events=100, max_steps=5), num_local_shards=1)
        rt.run(block=True)
        assert rt.metrics.frames.count == 5

    def test_mask_applied_host_side(self, stream, tmp_path):
        path = tmp_path / "mask.npy"
        np.save(path, np.zeros((2, 16, 128), np.uint8))  # every pixel bad
        cfg = stream.config(num_events=2)
        cfg = PipelineConfig(source=cfg.source, mask=MaskConfig(manual_mask_path=str(path)),
                             transport=cfg.transport)
        ProducerRuntime(cfg, num_local_shards=1).run(block=True)
        with stream.reader() as reader:
            rec = reader.read_wait(timeout=2.0)
        assert rec.panels.shape == (2, 16, 128) and rec.panels.sum() == 0

    def test_queue_death_mid_stream_exits_cleanly(self, stream):
        cfg = stream.config(num_events=5000, queue_size=2)
        rt = ProducerRuntime(cfg, num_local_shards=1)
        rt.bootstrap()
        rt.run(block=False)
        time.sleep(0.2)
        stream.kill()
        rt.join()  # returns: neither raises nor hangs

    def test_sharded_ranks_disjoint(self, stream):
        rt = ProducerRuntime(stream.config(num_events=9), num_local_shards=3)
        rt.run(block=True)
        by_rank = {}
        for r in stream.drain():
            if not is_eos(r):
                by_rank.setdefault(r.shard_rank, []).append(r.event_idx)
        assert set(by_rank) == {0, 1, 2}
        assert sorted(sum(by_rank.values(), [])) == list(range(9))


class TestDataReaderParity:
    def test_context_manager_and_nonblocking_read(self, stream):
        stream.create(8)
        with stream.reader() as reader:
            assert reader.read() is None  # empty
            assert reader.size() == 0

    def test_missing_queue_raises_reader_error(self, stream):
        cfg = TransportConfig(rendezvous_retries=2, rendezvous_interval_s=0.01)
        with pytest.raises(DataReaderError, match="could not find"):
            stream.reader(queue_name="nope", config=cfg).connect()

    def test_dead_queue_maps_to_reader_error(self, stream):
        q = stream.create(8)
        reader = stream.reader().connect()
        q.close()
        with pytest.raises(DataReaderError):
            reader.read()
        reader.close()

    def test_unconnected_read_raises(self, stream):
        with pytest.raises(DataReaderError, match="not connected"):
            stream.reader().read()

    def test_iteration_stops_at_eos(self, stream):
        q = stream.create(16)
        for i in range(3):
            q.put(_frame(i))
        q.put(EndOfStream())
        with stream.reader() as reader:
            seen = [r.event_idx for r in reader]
        assert seen == [0, 1, 2]

    def test_streaming_ignored_and_replay_refused(self, stream):
        stream.create(8)
        with stream.reader(streaming=True) as reader:
            assert reader.read() is None
        with pytest.raises(DataReaderError, match="does not support replay"):
            stream.reader(replay_from="begin").connect()


class TestMultiRuntimeEos:
    """Two producer runtimes on one queue: a consumer gets every event of
    both before it stops, even when one finishes far earlier."""

    def _two_runtimes(self, stream, num_events, delay_b=0.0, num_consumers=1):
        stream.create(256)
        cfgs = [stream.config(num_events=num_events, num_consumers=num_consumers)
                for _ in range(2)]
        rts = [ProducerRuntime(cfgs[i], num_local_shards=1, shard_rank_offset=i,
                               total_shards=2) for i in range(2)]
        rts[0].run(block=False)

        def _delayed():
            time.sleep(delay_b)
            rts[1].run(block=True)

        tb = threading.Thread(target=_delayed, daemon=True)
        tb.start()
        return rts, tb

    def test_consumer_waits_for_slow_producer(self, stream):
        rts, tb = self._two_runtimes(stream, num_events=10, delay_b=0.5)
        with stream.reader() as reader:
            got = [r.event_idx for r in reader]
        rts[0].join()
        tb.join()
        assert sorted(got) == list(range(10))

    def test_eos_records_carry_coverage(self, stream):
        rts, tb = self._two_runtimes(stream, num_events=4)
        rts[0].join()
        tb.join()
        eos = [i for i in stream.drain() if is_eos(i)]
        assert {e.producer_rank for e in eos} == {0, 1}
        assert all(e.total_shards == 2 and e.shards_done == 1 for e in eos)

    def test_two_consumers_two_runtimes(self, stream):
        rts, tb = self._two_runtimes(stream, num_events=12, delay_b=0.3, num_consumers=2)
        results = {}

        def consume(cid):
            with stream.reader() as reader:
                results[cid] = [r.event_idx for r in reader]

        threads = [threading.Thread(target=consume, args=(c,), daemon=True) for c in range(2)]
        for t in threads:
            t.start()
        join_s = 30.0 * max(1.0, 4.0 / (os.cpu_count() or 1))
        deadline = time.monotonic() + join_s
        for t in threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))
        assert not any(t.is_alive() for t in threads), (
            f"competing consumers starved past the {join_s:.0f}s join deadline")
        rts[0].join()
        tb.join()
        assert sorted(results[0] + results[1]) == list(range(12))  # no loss, no duplicate


class TestEosNeverDropped:
    def test_duplicate_eos_held_when_queue_full(self, stream):
        q = stream.create(1)
        tally = EosTally()
        tally.observe(EndOfStream(producer_rank=0, shards_done=1, total_shards=2))
        dup = EndOfStream(producer_rank=0, shards_done=1, total_shards=2)
        assert not tally.process(dup)  # a duplicate, the stream not complete
        while q.put(_frame(9)):  # fill the queue (an shm ring has at least 2 slots)
            pass
        full = q.size()
        tally.flush_duplicates(q)  # cannot place it yet
        assert q.size() == full
        q.get()  # a slot frees
        tally.flush_duplicates(q)
        items = [q.get() for _ in range(full)]
        assert is_eos(items[-1])  # the marker survived for the sibling

    def test_iter_records_stop_leaves_frames_for_siblings(self, stream):
        q = stream.create(16)
        for i in range(6):
            q.put(_frame(i))
        q.put(EndOfStream())
        seen = []
        with stream.reader() as reader:
            for rec in reader.iter_records(stop=lambda: len(seen) >= 3):
                seen.append(rec.event_idx)
        assert seen == [0, 1, 2]
        assert q.size() == 4  # 3 frames and the EOS left for siblings


class TestShardTopology:
    def test_explicit_flags_win(self, monkeypatch):
        from psana_ray_tpu_torch.producer import shard_topology

        monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "3")
        monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "4")
        _, args = parse_arguments(
            ["--num_shards", "2", "--shard_rank_offset", "10", "--total_shards", "20"])
        assert shard_topology(args) == (10, 20)

    def test_mpi_env_derives_topology(self, monkeypatch):
        from psana_ray_tpu_torch.producer import shard_topology

        monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "2")
        monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "4")
        _, args = parse_arguments(["--num_shards", "2"])
        assert shard_topology(args) == (4, 8)  # rank * local, world * local

    def test_pmi_env(self, monkeypatch):
        from psana_ray_tpu_torch.producer import shard_topology

        monkeypatch.delenv("OMPI_COMM_WORLD_RANK", raising=False)
        monkeypatch.setenv("PMI_RANK", "1")
        monkeypatch.setenv("PMI_SIZE", "2")
        _, args = parse_arguments(["--num_shards", "3"])
        assert shard_topology(args) == (3, 6)

    def test_slurm_env(self, monkeypatch):
        from psana_ray_tpu_torch.producer import shard_topology

        for var in ("OMPI_COMM_WORLD_RANK", "PMI_RANK"):
            monkeypatch.delenv(var, raising=False)
        monkeypatch.setenv("SLURM_PROCID", "1")
        monkeypatch.setenv("SLURM_NTASKS", "3")
        _, args = parse_arguments([])
        assert shard_topology(args) == (1, 3)

    def test_no_launcher_single_process(self, monkeypatch):
        from psana_ray_tpu_torch.producer import shard_topology

        for var in ("OMPI_COMM_WORLD_RANK", "PMI_RANK", "SLURM_PROCID"):
            monkeypatch.delenv(var, raising=False)
        _, args = parse_arguments(["--num_shards", "3"])
        assert shard_topology(args) == (0, 3)

    def test_matches_the_jax_package(self, monkeypatch):
        from psana_ray_tpu.producer import parse_arguments as jax_parse
        from psana_ray_tpu.producer import shard_topology as jax_topology
        from psana_ray_tpu_torch.producer import shard_topology

        for env in ({"OMPI_COMM_WORLD_RANK": "2", "OMPI_COMM_WORLD_SIZE": "5"},
                    {"PMI_RANK": "4", "PMI_SIZE": "6"}, {"SLURM_PROCID": "0"}, {}):
            for var in ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE", "PMI_RANK", "PMI_SIZE",
                        "SLURM_PROCID", "SLURM_NTASKS"):
                monkeypatch.delenv(var, raising=False)
            for k, v in env.items():
                monkeypatch.setenv(k, v)
            argv = ["--num_shards", "3"]
            assert shard_topology(parse_arguments(argv)[1]) == jax_topology(jax_parse(argv)[1])


class TestBatchedSender:
    def test_sender_retries_partial_batch_accept(self):
        from psana_ray_tpu_torch.producer import _Sender
        from psana_ray_tpu_torch.transport import BackoffPolicy
        from psana_ray_tpu_torch.utils.metrics import PipelineMetrics

        class BatchRing(RingBuffer):  # a RingBuffer with put_batch
            def put_batch(self, items):
                n = 0
                for it in items:
                    if not self.put(it):
                        break
                    n += 1
                return n

        q = BatchRing(maxsize=4)
        sender = _Sender(q, BackoffPolicy(0.001, 0.002, 0.0), threading.Event(),
                         PipelineMetrics(), 8)
        recs = [_frame(i) for i in range(8)]
        drained = []

        def drain_later():
            time.sleep(0.05)
            while len(drained) < 8:
                drained.append(q.get_wait(timeout=1.0))

        t = threading.Thread(target=drain_later)
        t.start()
        for r in recs:
            assert sender.send(r)
        assert sender.flush()
        t.join()
        assert [r.event_idx for r in drained] == list(range(8))  # FIFO kept
        assert sender.metrics.frames.count == 8

    def test_per_event_puts_without_put_batch(self):
        from psana_ray_tpu_torch.producer import _Sender
        from psana_ray_tpu_torch.transport import BackoffPolicy
        from psana_ray_tpu_torch.utils.metrics import PipelineMetrics

        q = RingBuffer(maxsize=8)
        sender = _Sender(q, BackoffPolicy(), threading.Event(), PipelineMetrics(), 16)
        assert sender.batch_size == 1
        assert sender.send(_frame(0)) and q.size() == 1


def test_backoff_policy_matches_the_jax_envelope():
    import random

    from psana_ray_tpu.transport.backoff import BackoffPolicy as JaxBackoff
    from psana_ray_tpu_torch.transport import BackoffPolicy

    slept = []
    ours = BackoffPolicy(sleep=slept.append, rng=random.Random(3))
    theirs = JaxBackoff(sleep=lambda s: None, rng=random.Random(3))
    got = [ours.wait() for _ in range(8)]
    assert got == [theirs.wait() for _ in range(8)] == slept
    assert ours.retries == theirs.retries == 5  # frozen once 0.1 * 2**r reaches the 2 s cap
    ours.reset()
    assert ours.retries == 0 and 0.1 <= ours.delay() < 0.6


# -- the two packages' runtimes on one config ------------------------------


def _run_and_collect(runtime_cls, config_mod, registry, mode, wire_dtype, mask_path):
    # the detector's bad-pixel mask is [P, H, W]: it does not broadcast
    # against the 2-D IMAGE mosaic (in either package), so IMAGE takes the
    # manual mask alone
    cfg = config_mod.PipelineConfig(
        source=config_mod.SourceConfig(exp="synthetic", run=3, detector_name=DETECTOR,
                                       num_events=24, mode=mode),
        mask=config_mod.MaskConfig(uses_bad_pixel_mask=mode != RetrievalMode.IMAGE,
                                   manual_mask_path=mask_path),
        transport=config_mod.TransportConfig(queue_size=64, num_consumers=2,
                                             wire_dtype=wire_dtype),
    )
    rt = runtime_cls(cfg, registry=registry, num_local_shards=2)
    rt.run(block=True)
    q = registry.resolve("default", "shared_queue", retries=1, interval_s=0.1)
    items = []
    while q.size():
        items.append(q.get())
    markers = [i for i in items if hasattr(i, "shards_done")]  # either package's EndOfStream
    frames = sorted((i for i in items if not hasattr(i, "shards_done")),
                    key=lambda r: (r.shard_rank, r.event_idx))
    eos = sorted((e.producer_rank, e.total_events, e.shards_done, e.total_shards)
                 for e in markers)
    return frames, eos, rt.metrics.frames.count


@pytest.mark.parametrize("mode", RetrievalMode.ALL)
@pytest.mark.parametrize("wire_dtype", ["", "uint16"])
def test_runtime_records_equal_the_jax_runtime(mode, wire_dtype, tmp_path):
    from psana_ray_tpu import config as jax_config
    from psana_ray_tpu.producer import ProducerRuntime as JaxRuntime
    from psana_ray_tpu.transport import Registry as JaxRegistry
    from psana_ray_tpu_torch import config as port_config

    shape = (1, 32, 128) if mode == RetrievalMode.IMAGE else (2, 16, 128)
    manual = np.random.default_rng(5).random(shape) > 0.1
    mask_path = str(tmp_path / "manual.npy")
    np.save(mask_path, manual)
    theirs = _run_and_collect(JaxRuntime, jax_config, JaxRegistry(), mode, wire_dtype, mask_path)
    ours = _run_and_collect(ProducerRuntime, port_config, Registry(), mode, wire_dtype, mask_path)
    (tf, te, tn), (of, oe, on) = theirs, ours
    assert len(of) == len(tf) == 24 and on == tn == 24
    assert oe == te == [(0, -1, 2, 2), (0, -1, 2, 2)]  # one a consumer, covering both shards
    for a, b in zip(of, tf):
        assert (a.shard_rank, a.event_idx, a.photon_energy) == (b.shard_rank, b.event_idx,
                                                                 b.photon_energy)
        assert a.panels.dtype == b.panels.dtype and a.panels.shape == b.panels.shape
        assert a.panels.tobytes() == b.panels.tobytes()
    assert of[0].panels.dtype == (np.uint16 if wire_dtype else np.float32)
    assert not np.all(of[0].panels == 0)  # the mask left pixels
