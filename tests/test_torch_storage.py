"""The port's segment log and durable queue (``psana_ray_tpu_torch.storage``).

The cases of ``tests/test_storage.py`` on the port's ``SegmentLog``,
``DurableRingBuffer`` and ``ReplayCursor``: record framing and the CRC
recovery scan, roll and recycle, committed offsets and their store,
spill, the ack floor, ``put_front`` at the original offset, the restart's
re-exposure, replay and the disk-fault hook. Then the on-disk format
against the JAX package's: a log written by either package (seeded f32
and uint16 frames, EOS markers, a pickle, rolls, a recycle, commits of
two groups) opens in the other with the same offsets, payload bytes and
committed offsets, and a torn tail written by either is cut at the same
offset, to the same bytes, by both.
"""

import errno
import glob
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

import psana_ray_tpu.storage as jax_storage  # noqa: E402
from psana_ray_tpu.records import EndOfStream as JaxEos  # noqa: E402
from psana_ray_tpu.records import FrameRecord as JaxRecord  # noqa: E402
from psana_ray_tpu_torch import storage  # noqa: E402
from psana_ray_tpu_torch.records import EndOfStream, FrameRecord  # noqa: E402
from psana_ray_tpu_torch.storage import (  # noqa: E402
    DURABLE,
    REPLAY_BEGIN,
    REPLAY_RESUME,
    DurableRingBuffer,
    SegmentLog,
    SpilledRecord,
)
from psana_ray_tpu_torch.transport.ring import EMPTY  # noqa: E402


def _rec(i, value=None, shape=(1, 8, 8)):
    return FrameRecord(0, i, np.full(shape, i if value is None else value, np.uint16), 9.5)


def _log(tmp_path, **kw):
    kw.setdefault("segment_bytes", 1 << 20)
    kw.setdefault("fsync", "none")
    return SegmentLog(str(tmp_path / "log"), name="t", **kw)


class TestSegmentLog:
    def test_append_read_round_trip_all_payload_kinds(self, tmp_path):
        log = _log(tmp_path)
        o0 = log.append(_rec(7))
        o1 = log.append(EndOfStream(total_events=7, producer_rank=3))
        o2 = log.append({"arbitrary": "pickle"})
        assert (o0, o1, o2) == (0, 1, 2)
        back = log.read(o0)
        assert back.equals(_rec(7)) and back.panels.dtype == np.uint16
        eos = log.read(o1)
        assert isinstance(eos, EndOfStream) and eos.producer_rank == 3
        assert log.read(o2) == {"arbitrary": "pickle"}
        with pytest.raises(KeyError, match="not retained"):
            log.read(3)
        log.close()

    @pytest.mark.parametrize("fsync", ["none", "batch", "always"])
    def test_offsets_survive_reopen(self, tmp_path, fsync):
        n0 = DURABLE.stats()["fsyncs_total"]
        log = _log(tmp_path, fsync=fsync, fsync_batch_n=2)
        for i in range(5):
            log.append(_rec(i))
        log.commit(2, "")
        log.commit(4, "model-v2")
        synced = DURABLE.stats()["fsyncs_total"] - n0
        log.close()
        # none never fsyncs; batch every 2nd append; always every append
        assert synced >= {"none": 0, "batch": 2, "always": 5}[fsync]
        if fsync == "none":
            assert synced == 0
        log2 = _log(tmp_path)
        assert log2.next_offset == 5
        assert log2.committed("") == 2 and log2.committed("model-v2") == 4
        assert log2.read(3).event_idx == 3
        log2.close()

    def test_commit_is_monotonic(self, tmp_path):
        log = _log(tmp_path)
        log.append(_rec(0))
        assert log.commit(0, "g") is True
        assert log.commit(0, "g") is False  # no regress, no rewrite
        log.close()

    def test_rollover_and_recycle_bound_disk(self, tmp_path):
        log = _log(tmp_path, segment_bytes=4096, retain_segments=2)
        q = DurableRingBuffer(log, maxsize=500, ram_items=8, name="t")
        for i in range(100):
            assert q.put(_rec(i))
        assert log.stats()["segments"] > 3  # really rolled
        out = q.get_batch(200, timeout=0)
        assert len(out) == 100
        q.ack_delivered(out)
        s = log.stats()
        assert s["segments"] <= 3  # at most retain + 1 of consumed history
        assert s["first_retained_offset"] > 0  # history really recycled
        # recycled segments sit on the free list, out of the seg-* names
        free = glob.glob(str(tmp_path / "log" / "free-*.seg"))
        assert len(free) == s["free_segments"] <= 2
        log.close()

    @pytest.mark.parametrize("where", ["payload", "header_crc"])
    def test_torn_tail_truncated_and_flagged(self, tmp_path, where):
        log = _log(tmp_path)
        for i in range(6):
            log.append(_rec(i))
        seg = log._segments[-1]
        victim_pos = seg.find(5)
        path = seg.path
        log.close()
        with open(path, "r+b") as f:  # corrupt the last record
            f.seek(victim_pos + (24 if where == "payload" else 8))
            f.write(b"\xde\xad\xbe\xef")
        log2 = _log(tmp_path)
        assert log2.torn_tail_repaired is True
        assert log2.next_offset == 5  # cut after the last valid record
        assert log2.read(4).event_idx == 4
        assert log2.append(_rec(50)) == 5  # the repaired region appends again
        assert log2.read(5).event_idx == 50
        log2.close()

    def test_free_segment_leftovers_ignored_on_boot(self, tmp_path):
        log = _log(tmp_path)
        log.append(_rec(0))
        log.close()
        # a crash can leave retired free-* files: never scanned as history
        (tmp_path / "log" / "free-9.seg").write_bytes(b"\x01" * 64)
        log2 = _log(tmp_path)
        assert log2.next_offset == 1
        assert not os.path.exists(str(tmp_path / "log" / "free-9.seg"))
        log2.close()

    def test_oversized_record_fails_fast(self, tmp_path):
        log = _log(tmp_path, segment_bytes=4096)
        with pytest.raises(ValueError, match="segment_bytes"):
            log.append(_rec(0, shape=(4, 64, 64)))  # 32 KB > 4 KB segment
        assert log.next_offset == 0
        log.close()

    def test_offset_store_compacts(self, tmp_path):
        log = _log(tmp_path)
        log.append(_rec(0))
        for i in range(3000):  # enough lines to cross the threshold
            log.commit(i, f"g{i % 7}")
        assert os.path.getsize(str(tmp_path / "log" / "offsets.jsonl")) < 128 * 1024
        log.close()
        log2 = _log(tmp_path)
        assert log2.committed("g0") == 2996
        log2.close()

    @pytest.mark.parametrize("op", ["append", "sync"])
    def test_disk_fault_hook_fails_the_op_and_counts_it(self, tmp_path, op):
        from faultproxy import DiskFaultInjector

        log = _log(tmp_path)
        log.append(_rec(0))
        n0 = DURABLE.stats()["disk_faults_total"]
        storage.set_disk_fault_hook(DiskFaultInjector(ops=(op,)))
        try:
            with pytest.raises(OSError) as e:
                log.append(_rec(1)) if op == "append" else log.sync()
            assert e.value.errno == errno.ENOSPC
        finally:
            storage.set_disk_fault_hook(None)
        assert DURABLE.stats()["disk_faults_total"] == n0 + 1
        # the log lives on: the next append takes the next offset
        assert log.append(_rec(2)) == 1
        log.close()


class TestDurableRingBuffer:
    def test_contract_parity_with_ringbuffer(self, tmp_path):
        q = DurableRingBuffer(_log(tmp_path), maxsize=2, name="t")
        assert q.get() is EMPTY
        assert q.put(_rec(0)) and q.put(_rec(1))
        assert q.put(_rec(2)) is False  # full, rejected, not logged
        assert q.log.next_offset == 2
        assert q.get().event_idx == 0
        assert q.size() == 1
        stats = q.stats()
        assert stats["durable"] is True and stats["puts"] == 2
        assert q.put_offset(_rec(3)) == (True, 2)

    @pytest.mark.parametrize("read", ["materialize", "span"])
    def test_spill_beyond_ram_bounded_depth(self, tmp_path, read):
        from psana_ray_tpu_torch.transport.codec import decode_payload

        q = DurableRingBuffer(_log(tmp_path), maxsize=64, ram_items=4, name="t")
        for i in range(40):
            assert q.put(_rec(i))
        st = q.stats()
        assert st["resident"] == 4 and st["spilled"] == 36
        out = q.get_batch(64, timeout=0)
        # spilled records come as unread handles, read in by the server or
        # sent from the file
        assert all(type(r) is SpilledRecord for r in out[4:])
        if read == "materialize":
            out = out[:4] + [r.materialize() for r in out[4:]]
        else:
            spans = [r.payload_span() for r in out[4:]]
            out = out[:4] + [decode_payload(os.pread(f.fileno(), n, pos)) for f, pos, n in spans]
        assert [r.event_idx for r in out] == list(range(40))
        assert np.array_equal(out[20].panels, _rec(20).panels)
        assert q.stats()["spilled"] == 0

    def test_spilled_record_span_is_the_wire_payload(self, tmp_path):
        from psana_ray_tpu_torch.transport.codec import encode_payload

        q = DurableRingBuffer(_log(tmp_path), maxsize=8, ram_items=1, name="t")
        q.put(_rec(0))
        q.put(_rec(1))
        _, spilled = q.get_batch(2, timeout=0)
        f, pos, n = spilled.payload_span()
        assert os.pread(f.fileno(), n, pos) == encode_payload(_rec(1))

    def test_ack_floor_advances_only_over_acked_prefix(self, tmp_path):
        q = DurableRingBuffer(_log(tmp_path), maxsize=16, name="t")
        for i in range(6):
            q.put(_rec(i))
        a, b, c = q.get(), q.get(), q.get()
        q.ack_delivered([b])  # out of order: the floor must not move
        assert q.stats()["committed_offset"] == -1
        q.ack_delivered([a])
        assert q.stats()["committed_offset"] == 1  # a and b contiguous now
        q.ack_delivered([c])
        assert q.stats()["committed_offset"] == 2

    def test_put_front_reinstates_original_offset(self, tmp_path):
        q = DurableRingBuffer(_log(tmp_path), maxsize=16, name="t")
        q.put(_rec(0))
        q.put(_rec(1))
        x = q.get()
        logged = q.log.next_offset
        q.put_front(x)  # the redelivery path: no second append
        assert q.log.next_offset == logged
        y = q.get()
        assert y.event_idx == 0
        q.ack_delivered([y])
        assert q.stats()["committed_offset"] == 0

    def test_restart_reexposes_unconsumed_range(self, tmp_path):
        q = DurableRingBuffer(_log(tmp_path), maxsize=32, name="t")
        for i in range(10):
            q.put(_rec(i))
        q.put(EndOfStream(total_events=10))
        q.ack_delivered(q.get_batch(4, timeout=0))
        unacked = q.get_batch(2, timeout=0)  # popped, never acked
        assert [r.event_idx for r in unacked] == [4, 5]
        q.log.close()  # a crash: nothing graceful beyond the page cache
        q2 = DurableRingBuffer(_log(tmp_path), maxsize=32, name="t")
        assert q2.reexposed == 7
        # re-exposed records are spilled: delivered as handles on the log
        idxs = [getattr(r.materialize(), "event_idx", "EOS")
                for r in q2.get_batch(32, timeout=0)]
        # from the committed offset: the unacked 4, 5 come again, nothing lost
        assert idxs == [4, 5, 6, 7, 8, 9, "EOS"]
        q2.log.close()

    def test_spilled_handle_holds_the_floor_until_acked(self, tmp_path):
        # the handle's segment must outlive the send: the committed floor
        # stays below an outstanding spilled record
        q = DurableRingBuffer(_log(tmp_path), maxsize=8, ram_items=1, name="t")
        q.put(_rec(0))
        q.put(_rec(1))
        first, spilled = q.get_batch(2, timeout=0)
        assert type(spilled) is SpilledRecord and spilled.offset == 1
        q.ack_delivered([first])
        assert q.stats()["committed_offset"] == 0
        assert q.stats()["outstanding"] == 1
        q.ack_delivered([spilled])
        assert q.stats()["committed_offset"] == 1

    def test_spilled_handle_materializes_once(self, tmp_path):
        q = DurableRingBuffer(_log(tmp_path), maxsize=8, ram_items=1, name="t")
        q.put(_rec(0))
        q.put(_rec(1))
        _, spilled = q.get_batch(2, timeout=0)
        before = DURABLE.stats()["spill_reads_total"]
        rec = spilled.materialize()
        assert spilled.materialize() is rec  # cached: the log is read once
        assert DURABLE.stats()["spill_reads_total"] == before + 1
        assert rec.event_idx == 1 and np.array_equal(rec.panels, _rec(1).panels)

    def test_replay_cursor_begin_and_resume(self, tmp_path):
        q = DurableRingBuffer(_log(tmp_path), maxsize=32, name="t")
        for i in range(8):
            q.put(_rec(i))
        q.ack_delivered(q.get_batch(8, timeout=0))  # live consumption complete
        cur = q.open_replay("model-v2", REPLAY_BEGIN)
        assert [r.event_idx for r in cur.next_batch(3)] == [0, 1, 2]
        assert cur.commit() is True
        cur2 = q.open_replay("model-v2", REPLAY_RESUME)  # after the commit
        assert [r.event_idx for r in cur2.next_batch(32)] == [3, 4, 5, 6, 7]
        assert cur2.position == q.log.next_offset  # caught up
        cur3 = q.open_replay("model-v3", REPLAY_RESUME)  # another group: its own
        assert [r.event_idx for r in cur3.next_batch(2)] == [0, 1]
        cur4 = q.open_replay("g", 5)  # an explicit offset
        assert [r.event_idx for r in cur4.next_batch(8)] == [5, 6, 7]

    def test_telemetry_counts_rolls_spills_and_recovery(self, tmp_path):
        before = DURABLE.stats()
        log = _log(tmp_path, segment_bytes=4096)
        q = DurableRingBuffer(log, maxsize=200, ram_items=2, name="t")
        for i in range(20):  # rolls and spills
            q.put(_rec(i))
        after = DURABLE.stats()
        assert after["appends_total"] - before["appends_total"] == 20
        assert after["segments_rolled"] > before["segments_rolled"] + 1
        assert after["spilled_peak"] >= 18 and after["recovery_scans"] > before["recovery_scans"]
        log.close()

    def test_replay_does_not_disturb_live_queue(self, tmp_path):
        q = DurableRingBuffer(_log(tmp_path), maxsize=32, name="t")
        for i in range(5):
            q.put(_rec(i))
        assert len(q.open_replay("g", REPLAY_BEGIN).next_batch(100)) == 5
        assert q.size() == 5  # the live depth untouched
        assert [r.event_idx for r in q.get_batch(8, timeout=0)] == list(range(5))


# -- the on-disk format against the JAX package's ---------------------------
PACKAGES = {
    "port": (SegmentLog, storage.DurableRingBuffer, FrameRecord, EndOfStream),
    "jax": (jax_storage.SegmentLog, jax_storage.DurableRingBuffer, JaxRecord, JaxEos),
}


def _write_history(pkg, path, dtype):
    """A log with what a run leaves behind: seeded frames of ``dtype``, a
    pickle, EOS markers, rolls and a recycle (4 KiB segments, one
    retained), the live floor and a replay group's commit."""
    log_cls, ring_cls, rec_cls, eos_cls = PACKAGES[pkg]
    rng = np.random.default_rng(7)
    log = log_cls(path, segment_bytes=4096, retain_segments=1, fsync="batch", fsync_batch_n=3,
                  name="interop")
    q = ring_cls(log, maxsize=256, ram_items=4, name="interop")
    for i in range(40):
        panels = (rng.normal(100.0, 5.0, (2, 8, 12)) if dtype == np.float32
                  else rng.integers(0, 4096, (2, 8, 12))).astype(dtype)
        assert q.put(rec_cls(i % 2, i, panels, 9.5 + i))
    q.put({"run": 7, "note": "pickled"})
    q.put(eos_cls(total_events=40, producer_rank=0))
    q.put(eos_cls(total_events=40, producer_rank=1))
    q.ack_delivered(q.get_batch(30, timeout=0))  # the floor at 29: a recycle
    log.commit(35, "audit")
    q.get_batch(3, timeout=0)  # delivered, not acked: re-exposed at the boot
    log.close()


def _read_history(pkg, path):
    log_cls = PACKAGES[pkg][0]
    log = log_cls(path, segment_bytes=4096, retain_segments=1, fsync="none", name="interop")
    try:
        offsets = log.offsets_after(-1)
        payloads = {}
        for off in offsets:
            seg = log._find_segment(off)
            payloads[off] = bytes(seg.payload_at(seg.find(off)))
        return {"offsets": offsets, "next": log.next_offset, "payloads": payloads,
                "first": log.first_retained_offset(), "torn": log.torn_tail_repaired,
                "committed": {g: log.committed(g) for g in ("", "audit", "none")},
                "records": [log.read(o) for o in offsets]}
    finally:
        log.close()


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_a_log_boots_in_the_other_package(tmp_path, writer, reader, dtype):
    path = str(tmp_path / "q")
    _write_history(writer, path, dtype)
    copy = str(tmp_path / "copy")
    shutil.copytree(path, copy)
    want = _read_history(writer, path)
    got = _read_history(reader, copy)
    assert want["first"] > 0 and len(want["offsets"]) > 10  # recycled, still deep
    for key in ("offsets", "next", "first", "torn", "committed", "payloads"):
        assert got[key] == want[key], key
    assert got["committed"] == {"": 29, "audit": 35, "none": -1}
    for a, b in zip(want["records"], got["records"]):
        if hasattr(a, "panels"):
            assert (a.event_idx, a.shard_rank, a.photon_energy) == (
                b.event_idx, b.shard_rank, b.photon_energy)
            assert a.panels.dtype == b.panels.dtype and a.panels.tobytes() == b.panels.tobytes()
        elif hasattr(a, "to_bytes"):  # EOS markers: the same wire bytes
            assert a.to_bytes() == b.to_bytes()
        else:
            assert a == b
    # the reader's queue re-exposes the same unconsumed range
    log_cls, ring_cls = PACKAGES[reader][:2]
    log = log_cls(copy, segment_bytes=4096, retain_segments=1, fsync="none", name="interop")
    q = ring_cls(log, maxsize=256, name="interop")
    # the port hands re-exposed (spilled) records out as handles on the log
    got = [r.materialize() if type(r) is SpilledRecord else r for r in q.get_batch(64, timeout=0)]
    assert [getattr(r, "event_idx", None) for r in got][:3] == [30, 31, 32]
    log.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_torn_tail_is_cut_alike_by_both(tmp_path, writer):
    path = str(tmp_path / "q")
    _write_history(writer, path, np.uint16)
    tail = sorted(glob.glob(os.path.join(path, "seg-*.seg")))[-1]
    with open(tail, "r+b") as f:  # a crash mid-append: the last payload torn
        data = bytearray(f.read())
        end = len(data.rstrip(b"\0"))
        data[end - 6:end] = b"\xff" * 6
        f.seek(0)
        f.write(data)
    outs, files = {}, {}
    for pkg in ("port", "jax"):
        copy = str(tmp_path / pkg)
        shutil.copytree(path, copy)
        outs[pkg] = _read_history(pkg, copy)
        files[pkg] = {os.path.basename(p): open(p, "rb").read()
                      for p in glob.glob(os.path.join(copy, "*"))}
    assert outs["port"]["torn"] is outs["jax"]["torn"] is True
    assert outs["port"]["next"] == outs["jax"]["next"] == 42  # the last EOS cut
    assert outs["port"]["payloads"] == outs["jax"]["payloads"]
    assert files["port"] == files["jax"]  # the same scrubbed bytes on disk


def test_segment_truncate_from_scrubs_the_suffix(tmp_path):
    from psana_ray_tpu_torch.storage.segment import Segment

    seg = Segment.allocate(str(tmp_path / "seg-00000000000000000000.seg"), 1 << 16, 0)
    for i in range(4):
        seg.append(i, _rec(i))
    cut = seg.find(2)
    seg.truncate_from(cut)
    assert [off for off, _ in seg.index] == [0, 1] and seg.write_pos == cut
    seg.close()
    again = Segment.open_existing(str(tmp_path / "seg-00000000000000000000.seg"), 0)
    assert again.scan(0) == (2, False)  # a clean end where the cut was
    assert again.append(2, _rec(9)) == cut
    again.close()
