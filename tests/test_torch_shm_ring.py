"""The port's wire format and shared-memory ring, against the JAX package's.

The wire bytes of both packages are compared byte for byte, for untraced
(v2) and traced (v3) frames, and each package decodes the other's. One
ring is shared between the packages' processes in both directions: a
producer process of one package writes, the other package attaches and
drains it zero-copy. The rest mirrors the JAX package's
``tests/test_shm_ring.py`` on the port's own ring: the queue contract,
void slots, close, wedge detection and drain.

The ring's library is the port's own ``native/shmring.cpp``, which
``g++`` builds into ``build/torch_native/`` at first use.
"""

import ctypes
import multiprocessing as mp
import os
import signal
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from psana_ray_tpu import records as ref_records  # noqa: E402
from psana_ray_tpu.obs.tracing import TraceContext  # noqa: E402
from psana_ray_tpu.transport.shm_ring import ShmRingBuffer as RefShmRing  # noqa: E402
from psana_ray_tpu_torch import records  # noqa: E402
from psana_ray_tpu_torch.obs.tracing import TraceContext as PortTraceContext  # noqa: E402
from psana_ray_tpu_torch.infeed import batches_from_queue  # noqa: E402
from psana_ray_tpu_torch.producer import produce_synthetic  # noqa: E402
from psana_ray_tpu_torch.sources import SyntheticSource  # noqa: E402
from psana_ray_tpu_torch.transport import (  # noqa: E402
    EMPTY,
    ShmRingBuffer,
    TransportClosed,
    TransportWedged,
)
from psana_ray_tpu_torch.transport.codec import (  # noqa: E402
    TAG_COMPRESSED,
    TAG_PICKLE,
    TAG_RECORD,
    TAG_VOID,
    decode_payload,
)
from psana_ray_tpu_torch.transport.shm_ring import _load_lib  # noqa: E402
from torch_parity import _no_lingering_child  # noqa: E402,F401 (autouse)

SPAWN = mp.get_context("spawn")


def _name(tag: str) -> str:
    return f"torch_{tag}_{os.getpid()}_{time.monotonic_ns() % 10**9}"


@pytest.fixture
def ring():
    r = ShmRingBuffer.create(_name("ring"), maxsize=8, slot_bytes=256 * 1024)
    yield r
    r.destroy()


# -- the wire format ---------------------------------------------------------

FRAMES = {
    "f32": lambda rng: rng.normal(100, 10, (3, 8, 16)).astype(np.float32),
    "uint16": lambda rng: rng.integers(0, 65535, (4, 5, 7)).astype(np.uint16),
    "2d": lambda rng: rng.normal(0, 1, (12, 10)).astype(np.float32),
}


def _ref_bytes(rec) -> bytes:
    buf = bytearray(ref_records.encoded_size(rec))
    n = ref_records.encode_into(rec, buf)
    assert n == len(buf)
    return bytes(buf)


@pytest.mark.parametrize("traced", [False, True], ids=["v2", "v3"])
@pytest.mark.parametrize("kind", sorted(FRAMES))
def test_wire_bytes_match_the_reference(kind, traced):
    panels = FRAMES[kind](np.random.default_rng(len(kind)))
    ctx = TraceContext(trace_id=0x1234_5678_9ABC, origin_host="node7", origin_pid=4242) if traced else None
    ref = ref_records.FrameRecord(5, 77, panels, 9.5, timestamp=1234.25, trace=ctx)
    ours = records.FrameRecord(5, 77, panels, 9.5, timestamp=1234.25,
                               trace=PortTraceContext(trace_id=ctx.trace_id, origin_host="node7",
                                                      origin_pid=4242) if traced else None)
    ref_wire = _ref_bytes(ref)
    assert records.encoded_size(ours) == len(ref_wire)
    assert ours.to_bytes() == ref_wire
    assert records.parse_frame_header(ref_wire)[6] == (3 if traced else 2)

    got = records.decode(ref_wire)  # the reference's bytes, the port's decoder
    assert (got.shard_rank, got.event_idx, got.photon_energy, got.timestamp) == (5, 77, 9.5, 1234.25)
    assert got.panels.dtype == panels.dtype and got.panels.shape == ref.panels.shape
    np.testing.assert_array_equal(got.panels, ref.panels)
    assert got.trace == ours.trace  # the port decodes a TraceContext
    assert (got.trace.pack() if traced else None) == (ctx.pack() if traced else None)

    back = ref_records.decode(ours.to_bytes())  # and the other way round
    assert back.equals(ref) and back.timestamp == 1234.25
    assert back.trace == ctx


def test_eos_wire_matches_the_reference():
    eos = records.EndOfStream(producer_rank=3, total_events=11, shards_done=2, total_shards=4)
    ref = ref_records.EndOfStream(producer_rank=3, total_events=11, shards_done=2, total_shards=4)
    assert eos.to_bytes() == ref.to_bytes()
    assert records.encoded_size(eos) == ref_records.encoded_size(ref)
    assert records.decode(ref.to_bytes()) == eos
    back = ref_records.decode(eos.to_bytes())
    assert (back.producer_rank, back.total_events, back.shards_done, back.total_shards) == (3, 11, 2, 4)
    v1 = ref_records._EOS_HEADER_V1.pack(ref_records._EOS_MAGIC, 1, 2, 5)
    assert records.decode(v1) == records.EndOfStream(2, 5, 1, 1)


class _Lease:
    def __init__(self):
        self.released = 0

    def release(self):
        self.released += 1


def test_decode_with_a_lease_is_zero_copy():
    panels = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    buf = bytearray(records.FrameRecord(0, 1, panels, 2.0).to_bytes())
    lease = _Lease()
    rec = records.decode(memoryview(buf), lease=lease)
    assert np.shares_memory(rec.panels, np.frombuffer(buf, np.uint8)) and rec.lease is lease
    owned = rec.materialize()
    assert lease.released == 1 and owned.lease is None and rec.lease is None
    assert not np.shares_memory(owned.panels, np.frombuffer(buf, np.uint8))
    np.testing.assert_array_equal(owned.panels, panels)
    assert owned.materialize() is owned
    rec.release()  # idempotent
    assert lease.released == 1
    eos_lease = _Lease()  # an EOS never keeps its buffer
    assert isinstance(records.decode(records.EndOfStream().to_bytes(), lease=eos_lease),
                      records.EndOfStream)
    assert eos_lease.released == 1
    with pytest.raises(ValueError, match="magic"):
        records.decode(b"\0" * 48)
    # a trace context adds its 25 packed bytes to the wire size
    traced = records.FrameRecord(0, 0, panels, 1.0, trace=PortTraceContext(trace_id=9))
    assert records.encoded_size(traced) - records.encoded_size(owned) == 25


def test_payload_tags_match_the_reference():
    from psana_ray_tpu.transport import codec as ref_codec

    assert (TAG_RECORD, TAG_PICKLE, TAG_VOID, TAG_COMPRESSED) == (
        ref_codec.TAG_RECORD, ref_codec.TAG_PICKLE, ref_codec.TAG_VOID, ref_codec.TAG_COMPRESSED)
    item = {"any": [1, 2]}
    assert decode_payload(ref_codec.encode_payload(item)) == item
    rec = records.FrameRecord(1, 2, np.ones((1, 2, 2), np.uint16), 3.0)
    got = decode_payload(TAG_RECORD + rec.to_bytes())
    assert got.equals(rec)
    lease = _Lease()
    with pytest.raises(ConnectionError, match="corrupt compressed"):  # codec id 0: none
        decode_payload(TAG_COMPRESSED + b"\0" * 16, lease=lease)
    assert lease.released == 1
    with pytest.raises(ValueError, match="unknown payload tag"):
        decode_payload(b"Z")


# -- one ring, both packages, two processes ----------------------------------


def _ref_frame(i: int) -> np.ndarray:
    return np.full((2, 6, 8), float(i), np.float32) + np.arange(8, dtype=np.float32)


def _reference_producer(name: str, n: int) -> None:
    """The JAX package's producer side: every third frame traced (v3)."""
    ring = RefShmRing.attach(name, retries=50, interval_s=0.1)
    try:
        for i in range(n):
            ctx = TraceContext(trace_id=i + 1, origin_pid=os.getpid()) if i % 3 == 0 else None
            rec = ref_records.FrameRecord(1, i, _ref_frame(i), 7.0 + i, timestamp=float(i),
                                          trace=ctx)
            assert ring.put_wait(rec, timeout=60)
        assert ring.put_wait(ref_records.EndOfStream(producer_rank=1, total_events=n), timeout=60)
    finally:
        ring.disconnect()


def _drain_views(ring, timeout=60.0):
    """Every item up to and including the EOS, frames copied out of their
    slots and released."""
    out = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for item in ring.get_batch_view(8, timeout=0.05):
            if getattr(item, "lease", None) is not None:
                owned = item.materialize()
                assert item.lease is None
                item = owned
            out.append(item)
        if out and type(out[-1]).__name__ == "EndOfStream":
            return out
    raise AssertionError(f"no EOS after {timeout} s ({len(out)} items)")


def test_reference_producer_process_feeds_the_port_consumer():
    name, n = _name("ref2port"), 13
    owner = RefShmRing.create(name, maxsize=4, slot_bytes=64 * 1024)
    try:
        proc = SPAWN.Process(target=_reference_producer, args=(name, n))
        proc.start()
        ring = ShmRingBuffer.attach(name, retries=50, interval_s=0.1)
        items = _drain_views(ring)
        proc.join(timeout=60)
        assert proc.exitcode == 0
        assert ring._slot_leases == 0 and ring.stats()["bytes_copied_out"] == 0
        ring.disconnect()
    finally:
        owner.destroy()
    *frames, eos = items
    assert eos == records.EndOfStream(producer_rank=1, total_events=n)
    assert [f.event_idx for f in frames] == list(range(n))
    for f in frames:
        i = f.event_idx
        np.testing.assert_array_equal(f.panels, _ref_frame(i))
        assert (f.shard_rank, f.photon_energy, f.timestamp) == (1, 7.0 + i, float(i))
        want = TraceContext(trace_id=i + 1, origin_pid=proc.pid).pack() if i % 3 == 0 else None
        assert (f.trace.pack() if f.trace is not None else None) == want


def test_port_producer_process_feeds_the_reference_consumer():
    name, n, pool = _name("port2ref"), 11, 4
    owner = ShmRingBuffer.create(name, maxsize=4, slot_bytes=64 * 1024)
    try:
        produced = SPAWN.Value("q", 0)
        proc = SPAWN.Process(target=produce_synthetic, args=(name, "smoke_a", n, pool),
                             kwargs=dict(seed=5, dtype="uint16", produced=produced))
        proc.start()
        ref = RefShmRing.attach(name, retries=50, interval_s=0.1)
        items = _drain_views(ref)
        proc.join(timeout=60)
        assert proc.exitcode == 0 and produced.value == n
        ref.disconnect()
    finally:
        owner.destroy()
    *frames, eos = items
    assert isinstance(eos, ref_records.EndOfStream) and eos.total_events == n
    src = SyntheticSource(num_events=pool, detector_name="smoke_a", seed=5, dtype="uint16")
    assert [f.event_idx for f in frames] == list(range(n))
    for f in frames:
        panels, energy = src.event(f.event_idx % pool, "raw")
        assert f.panels.dtype == np.uint16 and f.photon_energy == energy
        np.testing.assert_array_equal(f.panels, panels)


def test_port_batcher_drains_a_reference_ring_zero_copy():
    name, n = _name("refbatch"), 10
    owner = RefShmRing.create(name, maxsize=8, slot_bytes=64 * 1024)
    try:
        proc = SPAWN.Process(target=_reference_producer, args=(name, n))
        proc.start()
        ring = ShmRingBuffer.attach(name, retries=50, interval_s=0.1)
        batches = list(batches_from_queue(ring, batch_size=4, n_buffers=6, max_wait_s=60))
        proc.join(timeout=60)
        assert proc.exitcode == 0
        assert ring._slot_leases == 0 and ring.stats()["bytes_copied_out"] == 0
        ring.disconnect()
    finally:
        owner.destroy()
    assert [b.num_valid for b in batches] == [4, 4, 2]
    got = np.concatenate([b.frames[:b.num_valid] for b in batches])
    np.testing.assert_array_equal(got, np.stack([_ref_frame(i) for i in range(n)]))


# -- the port's ring: the queue contract --------------------------------------


def test_fifo_and_typed_empty(ring):
    assert ring.get() is EMPTY
    assert ring.put({"a": 1}) and ring.put({"b": 2})
    assert ring.get() == {"a": 1}
    assert ring.get() == {"b": 2}
    assert ring.get() is EMPTY


def test_full_returns_false(ring):
    n = 0
    while ring.put(n):
        n += 1
    assert n == ring.maxsize == ring.size()
    assert ring.stats()["puts_rejected"] >= 1
    assert ring.get() == 0  # nothing lost, order kept


def test_frame_record_payload_and_copied_bytes(ring):
    panels = np.arange(2 * 8 * 16, dtype=np.float32).reshape(2, 8, 16)
    ring.put(records.FrameRecord(3, 41, panels, 9.7))
    out = ring.get()
    assert isinstance(out, records.FrameRecord) and out.lease is None
    assert (out.shard_rank, out.event_idx) == (3, 41)
    np.testing.assert_array_equal(out.panels, panels)
    assert ring.stats()["bytes_copied_out"] == panels.nbytes
    ring.put(records.EndOfStream(total_events=42))
    assert ring.get() == records.EndOfStream(total_events=42)


def test_get_view_holds_the_slot_until_release():
    r = ShmRingBuffer.create(_name("view"), maxsize=2, slot_bytes=4096)
    try:
        for i in range(2):
            assert r.put(records.FrameRecord(0, i, np.full((1, 4, 4), i, np.float32), 1.0))
        view = r.get_view()
        assert view.lease is not None and r._slot_leases == 1
        assert r.put(records.EndOfStream()) is False  # its slot is still claimed
        np.testing.assert_array_equal(view.panels, 0)
        view.release()
        assert r._slot_leases == 0 and r.put(records.EndOfStream())
        dropped = r.get_view()  # a dropped record frees its slot on GC
        del dropped
        assert r._slot_leases == 0
        assert r.get_view() == records.EndOfStream()
    finally:
        r.destroy()


def test_oversized_message_rejected(ring):
    with pytest.raises(ValueError, match="slot size"):
        ring.put(records.FrameRecord(0, 0, np.zeros((4, 256, 256), np.float32), 1.0))
    assert ring.size() == 0


def test_close_raises_on_both_sides(ring):
    ring.put(1)
    ring.close()
    assert ring.closed
    with pytest.raises(TransportClosed):
        ring.put(2)
    with pytest.raises(TransportClosed):
        ring.get()


def test_get_wait_timeout_and_get_batch(ring):
    t0 = time.monotonic()
    assert ring.get_wait(timeout=0.05) is EMPTY
    assert time.monotonic() - t0 >= 0.04
    assert ring.get_batch(4, timeout=0.01) == []
    for i in range(6):
        ring.put(i)
    assert ring.get_batch(4, timeout=0.1) == [0, 1, 2, 3]
    assert ring.get_batch_view(4, timeout=0.1) == [4, 5]
    assert ring.put_wait(7, timeout=0.1) and ring.get_wait(timeout=0.1) == 7


def _port_producer(name, n, shard_rank):
    ring = ShmRingBuffer.attach(name, retries=50, interval_s=0.1)
    for i in range(shard_rank, n, 2):
        rec = records.FrameRecord(shard_rank, i, np.full((1, 16, 16), float(i), np.float32), 1.0)
        assert ring.put_wait(rec, timeout=60)
    ring.disconnect()


def test_two_producer_processes_one_consumer():
    name = _name("xproc")
    ring = ShmRingBuffer.create(name, maxsize=4, slot_bytes=64 * 1024)
    try:
        n = 20
        procs = [SPAWN.Process(target=_port_producer, args=(name, n, r)) for r in range(2)]
        for p in procs:
            p.start()
        got = []
        deadline = time.monotonic() + 60
        while len(got) < n and time.monotonic() < deadline:
            item = ring.get_wait(timeout=1.0)
            if item is not EMPTY:
                got.append(item)
        for p in procs:
            p.join(timeout=30)
            assert p.exitcode == 0
        assert sorted(r.event_idx for r in got) == list(range(n))
        for r in got:
            assert float(r.panels[0, 0, 0]) == float(r.event_idx)
    finally:
        ring.destroy()


def test_attach_timeout():
    with pytest.raises(TimeoutError, match="not found"):
        ShmRingBuffer.attach(_name("never"), retries=2, interval_s=0.05)


# -- wedges, voids, drain -----------------------------------------------------


def _crash_mid_reserve(name):
    """Claim a slot and die without committing it."""
    ring = ShmRingBuffer.attach(name, retries=50, interval_s=0.1)
    ptr, ticket = ctypes.c_void_p(), ctypes.c_uint64()
    assert _load_lib().shmring_reserve(ring._h, ctypes.byref(ptr), ctypes.byref(ticket)) == 1
    os.kill(os.getpid(), signal.SIGKILL)


def test_sigkilled_producer_wedges_the_consumer_loudly():
    name = _name("wedge")
    ring = ShmRingBuffer.create(name, maxsize=4, slot_bytes=4096)
    ring.set_stall_timeout(0.3)
    try:
        p = SPAWN.Process(target=_crash_mid_reserve, args=(name,))
        p.start()
        p.join(timeout=60)
        assert p.exitcode == -signal.SIGKILL
        with pytest.raises(TransportWedged, match="producer.*crashed"):
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                ring.get()
                time.sleep(0.01)
    finally:
        ring.destroy()


def test_unreleased_consumer_wedges_the_producer_loudly():
    ring = ShmRingBuffer.create(_name("wedgep"), maxsize=2, slot_bytes=4096)
    ring.set_stall_timeout(0.3)
    try:
        assert ring.put(b"a") and ring.put(b"b")
        ptr, ticket = ctypes.c_void_p(), ctypes.c_uint64()
        assert _load_lib().shmring_acquire(ring._h, ctypes.byref(ptr), ctypes.byref(ticket)) >= 0
        with pytest.raises(TransportWedged, match="consumer.*crashed"):
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                ring.put(b"c")
                time.sleep(0.01)
    finally:
        ring.destroy()


def test_slow_peer_is_not_wedged(ring):
    ring.set_stall_timeout(0.1)
    time.sleep(0.3)
    assert ring.get() is EMPTY
    time.sleep(0.3)
    assert ring.get() is EMPTY


def test_get_skips_a_void_slot_and_returns_the_next_item(ring):
    class Unpicklable:
        def __reduce__(self):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        ring.put(Unpicklable())  # pickle fails before the reserve: no void
    assert ring.size() == 0
    # forge the void a mid-encode failure leaves: reserve, tag, commit one byte
    lib = _load_lib()
    ptr, ticket = ctypes.c_void_p(), ctypes.c_uint64()
    assert lib.shmring_reserve(ring._h, ctypes.byref(ptr), ctypes.byref(ticket)) == 1
    ctypes.memmove(ptr, TAG_VOID, 1)
    lib.shmring_commit(ring._h, ticket, 1)
    assert ring.put({"real": 1})
    assert ring.get() == {"real": 1}  # the void is consumed and skipped inline
    assert ring.stats()["voids_skipped"] == 1
    assert ring.get() is EMPTY


def test_a_wedge_propagates_through_the_batcher():
    class WedgedQueue:
        def get_batch_view(self, n, timeout=None):
            raise TransportWedged("wedged")

    with pytest.raises(TransportWedged):
        list(batches_from_queue(WedgedQueue(), batch_size=4))


def test_drain_refuses_producers_and_serves_consumers():
    name = _name("drain")
    ring = ShmRingBuffer.create(name, maxsize=8, slot_bytes=4096)
    try:
        assert ring.put({"i": 0}) and ring.put({"i": 1})
        other = ShmRingBuffer.attach(name, retries=2, interval_s=0.1)
        ring.begin_drain()
        with pytest.raises(TransportClosed):
            other.put({"i": 2})
        assert ring.get() == {"i": 0}
        assert other.get() == {"i": 1}
        assert ring.get() is EMPTY
        other.disconnect()
        with pytest.raises(TransportClosed, match="detached"):
            other.size()
        other.close()  # a no-op after disconnect
    finally:
        ring.destroy()
