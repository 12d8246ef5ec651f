"""The port's durable queue server: the ``TestCommittedOffsets``,
``TestCrashRestart``, ``TestReplay``, ``TestSpillThroughRelay`` and
``TestFaultProxyDriven`` cases of ``tests/test_durable_server.py`` on
``psana_ray_tpu_torch``'s server, client and queue server program.

Committed offsets over the wire (the implicit ack, a dead consumer's
redelivery, a stream's cumulative ack), ``kill -9`` of the server
process mid-stream and a restart on the same ``--durable_dir`` with no
loss and an exact resume, replay for a second consumer group (from
``begin``, then ``resume`` after a crash), the refusals, depth beyond RAM
through the relay (spilled records sent by ``sendfile`` on a plain
connection, read in on a compressed one), and the fault proxy's cut
wire and stall.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from faultproxy import FaultProxy  # noqa: E402
from psana_ray_tpu_torch.records import EndOfStream, FrameRecord, is_eos  # noqa: E402
from psana_ray_tpu_torch.storage import DURABLE, DurableRingBuffer, SegmentLog  # noqa: E402
from psana_ray_tpu_torch.transport.codec import encode_payload_parts  # noqa: E402
from psana_ray_tpu_torch.transport.ring import RingBuffer  # noqa: E402
from psana_ray_tpu_torch.transport.splice import SPLICE, sendfile_capable  # noqa: E402
from psana_ray_tpu_torch.transport.tcp import TcpQueueClient, TcpQueueServer  # noqa: E402
from torch_parity import _no_lingering_child  # noqa: E402,F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rec(i, shape=(1, 16, 16)):
    return FrameRecord(0, i, np.full(shape, i, np.uint16), 9.5)


def _durable_server(root, maxsize=500, ram_items=None, **log_kw):
    log_kw.setdefault("segment_bytes", 1 << 20)
    log_kw.setdefault("fsync", "none")

    def factory(ns, name, maxsize_):
        log = SegmentLog(os.path.join(str(root), f"{ns}__{name}"), name=name, **log_kw)
        return DurableRingBuffer(log, maxsize=maxsize_, name=name, ram_items=ram_items)

    return TcpQueueServer(factory("default", "default", maxsize), host="127.0.0.1",
                          maxsize=maxsize, queue_factory=factory).serve_background()


def _drain(client, timeout=1.0):
    out = []
    while True:
        batch = client.get_batch(64, timeout=timeout)
        if not batch:
            return out
        out.extend(batch)
        if any(is_eos(x) for x in batch):
            return out


def _client(port, **kw):
    kw.setdefault("reconnect_tries", 2)
    kw.setdefault("reconnect_base_s", 0.05)
    return TcpQueueClient("127.0.0.1", port, timeout_s=10.0, **kw)


class TestCommittedOffsets:
    def test_implicit_ack_commits_over_the_wire(self, tmp_path):
        srv = _durable_server(tmp_path)
        try:
            prod = _client(srv.port)
            for i in range(10):
                assert prod.put(_rec(i))
            cons = _client(srv.port)
            assert len(cons.get_batch(4, timeout=1.0)) == 4
            # nothing committed yet: the response is still in flight
            assert srv.queue.stats()["committed_offset"] == -1
            cons.size()  # the next opcode is the ack
            assert srv.queue.stats()["committed_offset"] == 3
            prod.disconnect()
            cons.disconnect()
        finally:
            srv.shutdown()

    def test_consumer_death_without_ack_redelivers(self, tmp_path):
        srv = _durable_server(tmp_path)
        try:
            prod = _client(srv.port)
            for i in range(8):
                assert prod.put(_rec(i))
            cons = _client(srv.port)
            assert len(cons.get_batch(3, timeout=1.0)) == 3
            cons._sock.close()  # a crash: no BYE, no next opcode, no ack
            cons2 = _client(srv.port)
            deadline = time.monotonic() + 5.0
            redelivered = []
            while len(redelivered) < 8 and time.monotonic() < deadline:
                redelivered.extend(cons2.get_batch(8, timeout=0.25))
            # requeued at the head within this life; the floor never moved
            assert [r.event_idx for r in redelivered] == list(range(8))
            cons2.size()
            assert srv.queue.stats()["committed_offset"] == 7
            prod.disconnect()
            cons2.disconnect()
        finally:
            srv.shutdown()

    def test_stream_cumulative_ack_commits(self, tmp_path):
        srv = _durable_server(tmp_path)
        try:
            prod = _client(srv.port)
            for i in range(6):
                assert prod.put(_rec(i))
            cons = _client(srv.port)
            reader = cons.stream_open(window=8)
            first = reader.get_batch_stream(6, timeout=2.0)
            reader.get_batch_stream(1, timeout=0.1)  # acks what it returned before
            deadline = time.monotonic() + 2.0
            while (srv.queue.stats()["committed_offset"] != len(first) - 1
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            assert srv.queue.stats()["committed_offset"] == len(first) - 1
            prod.disconnect()
            cons.disconnect()
        finally:
            srv.shutdown()


class TestCrashRestart:
    """``kill -9`` of the queue server process mid-stream, a restart on the
    same ``--durable_dir``: no loss, and the resume at the committed
    offset."""

    @staticmethod
    def _start(durable_dir, port_file, log):
        if os.path.exists(port_file):
            os.remove(port_file)
        proc = subprocess.Popen(
            [sys.executable, "-m", "psana_ray_tpu_torch.queue_server", "--host", "127.0.0.1",
             "--port", "0", "--durable_dir", durable_dir, "--fsync", "batch",
             "--fsync_batch_n", "8", "--port_file", port_file, "--queue_size", "500",
             "--segment_bytes", str(1 << 20)],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": REPO})
        deadline = time.monotonic() + 30
        while not os.path.exists(port_file):
            assert proc.poll() is None, "queue server died on startup"
            assert time.monotonic() < deadline, "server never wrote port file"
            time.sleep(0.05)
        with open(port_file) as f:
            return proc, int(f.read())

    def test_kill9_zero_loss_exact_resume(self, tmp_path):
        durable_dir = str(tmp_path / "log")
        port_file = str(tmp_path / "port")
        log = open(str(tmp_path / "server.log"), "w+")
        proc, port = self._start(durable_dir, port_file, log)
        try:
            prod = _client(port, namespace="ns", queue_name="q", reconnect_tries=1)
            for i in range(60):  # windowed puts, fsynced every 8
                assert prod.put_pipelined(_rec(i))
            assert prod.flush_puts()
            cons = _client(port, namespace="ns", queue_name="q", reconnect_tries=1)
            assert len(cons.get_batch(25, timeout=2.0)) == 25
            cons.size()  # the implicit ack: committed offset 24

            os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=10)
            proc, port = self._start(durable_dir, port_file, log)
            cons2 = _client(port, namespace="ns", queue_name="q", reconnect_tries=1)
            idxs = sorted(r.event_idx for r in _drain(cons2))
            # the resume at the committed offset: 25..59, nothing lost, and
            # the acked prefix not delivered again
            assert idxs == list(range(25, 60)), (
                f"lost={sorted(set(range(25, 60)) - set(idxs))} "
                f"dup={len(idxs) - len(set(idxs))}")
            cons2.disconnect()
        finally:
            if proc.poll() is None:
                os.kill(proc.pid, signal.SIGKILL)
                proc.wait(timeout=10)
            log.seek(0)
            out = log.read()
            log.close()
        assert "recovered 35 unconsumed record(s) of 60" in out, out[-2000:]

    def test_torn_tail_repair_counted_on_reboot(self, tmp_path):
        # a log, its last record corrupted on disk, the backing booted again:
        # the scan cuts it and counts the repair
        log = SegmentLog(str(tmp_path / "q"), segment_bytes=1 << 20, fsync="none", name="q")
        q = DurableRingBuffer(log, maxsize=64, name="q")
        for i in range(5):
            q.put(_rec(i))
        seg = log._segments[-1]
        pos = seg.find(4)
        path = seg.path
        log.close()
        with open(path, "r+b") as f:
            f.seek(pos + 30)
            f.write(b"\xff\xff\xff\xff")
        n0 = DURABLE.stats()["torn_tail_repairs"]
        log2 = SegmentLog(str(tmp_path / "q"), segment_bytes=1 << 20, fsync="none", name="q")
        q2 = DurableRingBuffer(log2, maxsize=64, name="q")
        assert DURABLE.stats()["torn_tail_repairs"] == n0 + 1 and log2.torn_tail_repaired
        assert log2.recovered_records == 4
        # the four intact records come back; the torn fifth is the producer's
        # to resend, never served
        # (spilled: delivered as handles on the log)
        got = [r.materialize().event_idx for r in q2.get_batch(16, timeout=0)]
        assert got == [0, 1, 2, 3]
        log2.close()


class TestReplay:
    def test_second_group_replays_from_begin_without_disturbing_live(self, tmp_path):
        srv = _durable_server(tmp_path)
        try:
            prod = _client(srv.port)
            for i in range(12):
                assert prod.put(_rec(i))
            prod.put(EndOfStream(total_events=12))
            live = _client(srv.port)
            assert len(live.get_batch(5, timeout=1.0)) == 5
            live.size()  # ack

            rep = _client(srv.port)
            assert rep.replay_open("begin", group="model-v2") == {"start": 0, "end": 13}
            idxs = [getattr(r, "event_idx", "EOS") for r in _drain(rep)]
            assert idxs == [*range(12), "EOS"]  # the whole retained range
            assert rep.commit_offset() is True

            # live consumption goes on where it was
            live_idxs = [getattr(r, "event_idx", "EOS") for r in _drain(live)]
            assert live_idxs == [*range(5, 12), "EOS"]
            assert srv.queue.log.committed("model-v2") == 12
            for c in (prod, live, rep):
                c.disconnect()
        finally:
            srv.shutdown()

    def test_replay_resume_continues_after_crash(self, tmp_path):
        srv = _durable_server(tmp_path)
        try:
            prod = _client(srv.port)
            for i in range(10):
                assert prod.put(_rec(i))
            rep = _client(srv.port)
            rep.replay_open("begin", group="g2")
            first = rep.get_batch(4, timeout=1.0)
            rep.size()  # the implicit ack commits g2 through offset 3
            rep._sock.close()  # the replay reader crashes without BYE
            rep2 = _client(srv.port)
            rep2.replay_open("resume", group="g2")
            rest = rep2.get_batch(32, timeout=1.0)
            assert [r.event_idx for r in first] == [0, 1, 2, 3]
            assert [r.event_idx for r in rest] == [4, 5, 6, 7, 8, 9]
            prod.disconnect()
            rep2.disconnect()
        finally:
            srv.shutdown()

    def test_explicit_commit_offset_for_a_named_group(self, tmp_path):
        srv = _durable_server(tmp_path)
        try:
            prod = _client(srv.port)
            for i in range(6):
                assert prod.put(_rec(i))
            assert prod.commit_offset(3, group="ops") is True
            assert prod.commit_offset(2) is False  # no group and no cursor
            rep = _client(srv.port)
            assert rep.replay_open("resume", group="ops")["start"] == 4
            assert [r.event_idx for r in rep.get_batch(8, timeout=1.0)] == [4, 5]
            for c in (prod, rep):
                c.disconnect()
        finally:
            srv.shutdown()

    def test_replay_open_on_streamed_connection_refused(self, tmp_path):
        srv = _durable_server(tmp_path)
        try:
            c = _client(srv.port)
            c.stream_open(window=4)
            with pytest.raises(RuntimeError, match="streamed"):
                c.replay_open("begin")
            c.disconnect()
            r = _client(srv.port)
            r.replay_open("begin")
            with pytest.raises(RuntimeError, match="replay connection"):
                r.stream_open(4)
            r.disconnect()
        finally:
            srv.shutdown()

    def test_oversized_record_errors_without_killing_the_loop(self, tmp_path):
        # a record larger than segment_bytes raises inside the durable queue;
        # on the parked put path ('U' against a full queue) that must answer
        # this client 'E', not take the server's loop down
        srv = _durable_server(tmp_path, maxsize=1, segment_bytes=1 << 16)
        try:
            filler = _client(srv.port)
            assert filler.put(_rec(0))  # the queue (maxsize 1) is full
            big = _rec(1, shape=(8, 64, 64))  # 64 KB payload > 64 KB segment
            blocked = _client(srv.port)

            def free_soon():
                time.sleep(0.3)
                drainer = _client(srv.port)
                drainer.get_batch(4, timeout=1.0)
                drainer.disconnect()

            import threading

            threading.Thread(target=free_soon, daemon=True).start()
            with pytest.raises(RuntimeError, match="protocol error"):
                blocked.put_wait(big, timeout=5.0)  # parks, then the pump's put raises
            with pytest.raises(RuntimeError, match="protocol error"):
                blocked.put(big)  # the direct put path answers 'E' too
            probe = _client(srv.port)  # the loop survived
            assert isinstance(probe.size(), int)
            for c in (filler, blocked, probe):
                c.disconnect()
        finally:
            srv.shutdown()

    def test_replay_refused_on_memory_only_queue(self):
        srv = TcpQueueServer(RingBuffer(10), host="127.0.0.1").serve_background()
        try:
            c = _client(srv.port)
            with pytest.raises(RuntimeError, match="no segment log"):
                c.replay_open("begin")
            assert c.commit_offset(1, group="g") is False
            c.disconnect()
        finally:
            srv.shutdown()


class TestSpillThroughRelay:
    @pytest.mark.parametrize("codec", [None, "shuffle-rle"])
    def test_depth_beyond_ram_arrives_intact(self, tmp_path, codec):
        srv = _durable_server(tmp_path, maxsize=300, ram_items=8)
        try:
            before = SPLICE.snapshot()["spliced_frames_total"]
            prod = _client(srv.port)
            for i in range(120):
                assert prod.put_pipelined(_rec(i))
            assert prod.flush_puts()
            st = srv.queue.stats()
            assert st["spilled"] >= 100 and st["resident"] <= 8
            cons = _client(srv.port, codec=codec)
            got = []
            while len(got) < 120:
                batch = cons.get_batch(64, timeout=1.0)
                if not batch:
                    break
                got.extend(batch)
            assert [r.event_idx for r in got] == list(range(120))
            assert all(np.array_equal(r.panels, _rec(r.event_idx).panels) for r in got)
            spliced = SPLICE.snapshot()["spliced_frames_total"] - before
            # a plain connection sends the spilled records from the file; a
            # compressed one reads them in
            if codec is None and sendfile_capable():
                assert spliced >= 100
            else:
                assert spliced == 0
            prod.disconnect()
            cons.disconnect()
        finally:
            srv.shutdown()


class TestFaultProxyDriven:
    def test_kill_at_byte_mid_put_loses_nothing(self, tmp_path):
        """The producer's wire cut mid-record: the windowed-put resend and
        the durable floor deliver every frame, holes never."""
        srv = _durable_server(tmp_path)
        proxy = FaultProxy("127.0.0.1", srv.port)
        try:
            prod = _client(proxy.port)
            wire_one = len(b"".join(bytes(p) for p in encode_payload_parts(_rec(0))))
            fault = proxy.kill_at("up", int(4.5 * wire_one))  # mid 5th payload
            for i in range(20):
                assert prod.put_pipelined(_rec(i))
            assert prod.flush_puts()
            assert fault.fired
            cons = _client(srv.port)
            got = []
            while True:
                batch = cons.get_batch(64, timeout=0.5)
                if not batch:
                    break
                got.extend(batch)
            assert sorted({r.event_idx for r in got}) == list(range(20)), "holes"
            prod.disconnect()
            cons.disconnect()
        finally:
            proxy.close()
            srv.shutdown()

    def test_stall_injection_rides_backpressure(self, tmp_path):
        srv = _durable_server(tmp_path)
        proxy = FaultProxy("127.0.0.1", srv.port)
        try:
            prod = _client(proxy.port)
            proxy.stall_at("up", 1024, stall_s=0.4)
            t0 = time.monotonic()
            for i in range(8):
                assert prod.put(_rec(i))
            assert time.monotonic() - t0 >= 0.3  # the stall bit
            cons = _client(srv.port)
            assert [r.event_idx for r in cons.get_batch(16, timeout=1.0)] == list(range(8))
            prod.disconnect()
            cons.disconnect()
        finally:
            proxy.close()
            srv.shutdown()
