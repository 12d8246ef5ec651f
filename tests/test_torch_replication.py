"""Chain replication on the port: the cases of ``tests/test_replication.py``
on ``psana_ray_tpu_torch.cluster.replication``, with the placement held to
the JAX package's answers.

- Follower placement is the rendezvous ranking, bit for bit the JAX
  package's for seeded random server lists.
- ``SegmentLog``'s ``append_at``, ``truncate_to`` and ``reset_to``
  survive a reopen, and ``append_at`` takes only the tail.
- ``ReplicaSet``: an overlap truncates, a gap resets, floors commit by
  stride and exactly at promotion, a promotion fences.
- Two servers: the replicated ack floor (a flushed put means the follower
  logged it), the owner's death and disk (promote, backlog, replay), an
  owner back behind its replica fenced, a missing or hung follower
  degrading after its grace, the idle floor refresh.
- A cluster whose coordinator is killed and its disk deleted loses
  nothing, and its group state survives on the next peer.
- A dead server's undelivered frames after the producer ended: lost
  without replication, in either package; kept with it.
- Reconnect jitter, a disk fault answered 'E'. The three-server chaos
  loop is ``slow``.

Where the JAX file reads ``FLIGHT``, these read the ``REPL`` counts of
the logged events.
"""

import os
import shutil
import socket
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from psana_ray_tpu_torch.cluster.client import ClusterClient  # noqa: E402
from psana_ray_tpu_torch.cluster.hashring import (  # noqa: E402
    PartitionMap,
    next_in_chain,
    partition_follower,
    partition_owner,
    ranked_owners,
)
from psana_ray_tpu_torch.cluster.replication import (  # noqa: E402
    FLOOR_COMMIT_STRIDE,
    REPL,
    ReplicaSet,
    ReplicationManager,
    parse_partition,
)
from psana_ray_tpu_torch.records import EndOfStream, FrameRecord, is_eos  # noqa: E402
from psana_ray_tpu_torch.storage import (  # noqa: E402
    DURABLE,
    DurableRingBuffer,
    SegmentLog,
    set_disk_fault_hook,
)
from psana_ray_tpu_torch.transport import TransportClosed  # noqa: E402
from psana_ray_tpu_torch.transport.tcp import (  # noqa: E402
    _REPL_NO_FLOOR,
    TcpQueueClient,
    TcpQueueServer,
)
from torch_parity import _no_lingering_child  # noqa: E402,F401 (autouse)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _frame(i: int, shape=(2, 8, 8)) -> FrameRecord:
    return FrameRecord(0, i, np.full(shape, i % 4096, dtype=np.uint16), 1.0)


def _pick_queue_name(peers, owner: str, prefix: str = "rq") -> str:
    """A queue name whose partition 0 ``owner`` owns."""
    for i in range(512):
        name = f"{prefix}_{i}"
        if partition_owner(peers, name, 0) == owner:
            return name
    raise AssertionError("no suitable queue name in 512 tries")


def _durable_factory(durable_dir, fsync="none", segment_bytes=1 << 20):
    def factory(ns, name, maxsize):
        log = SegmentLog(os.path.join(durable_dir, f"{ns}__{name}"), segment_bytes=segment_bytes,
                         fsync=fsync, name=f"{ns}/{name}")
        return DurableRingBuffer(log, maxsize=maxsize, name=f"{ns}__{name}")

    return factory


def _replicated_server(durable_dir, peers, advertise, port, group_store=False, **mgr_kw):
    mgr = ReplicationManager(durable_dir, peers, advertise, **mgr_kw)
    return TcpQueueServer(
        host="127.0.0.1", port=port, maxsize=256, queue_factory=_durable_factory(durable_dir),
        replication=mgr,
        group_store_path=os.path.join(durable_dir, "groups.json") if group_store else None,
    ).serve_background()


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


def _shutdown(servers):
    for s in servers:
        if s is not None:
            try:
                s.shutdown()
            except Exception:
                pass


# ---------------------------------------------------------------------------
# follower placement: the chain is the rendezvous ranking
# ---------------------------------------------------------------------------
class TestFollowerPlacement:
    PEERS = ["h1:1", "h2:2", "h3:3", "h4:4"]

    def test_ranking_is_deterministic_and_total(self):
        for p in range(8):
            ranked = ranked_owners(self.PEERS, "q", p)
            assert sorted(ranked) == sorted(self.PEERS)
            assert ranked == ranked_owners(list(reversed(self.PEERS)), "q", p)
            assert ranked[0] == partition_owner(self.PEERS, "q", p)
            assert ranked[1] == partition_follower(self.PEERS, "q", p)

    def test_follower_is_the_failover_target(self):
        m = PartitionMap.compute(self.PEERS, "q", 8)
        for p in range(8):
            owner = m.assignments[p]
            follower = m.follower_of(p)
            assert follower is not None and follower != owner
            survivors = [s for s in self.PEERS if s != owner]
            assert partition_owner(survivors, "q", p) == follower

    def test_next_in_chain_walks_the_ranking(self):
        ranked = ranked_owners(self.PEERS, "q", 3)
        for i, server in enumerate(ranked):
            nxt = next_in_chain(self.PEERS, server, "q", 3)
            assert nxt == (ranked[i + 1] if i + 1 < len(ranked) else None)
        assert next_in_chain(self.PEERS, "h9:9", "q", 3) is None

    def test_single_server_has_no_follower(self):
        assert partition_follower(["h1:1"], "q", 0) is None

    def test_parse_partition(self):
        assert parse_partition("shared_queue#p3") == ("shared_queue", 3)
        assert parse_partition("plain") == ("plain", 0)
        assert parse_partition("odd#px") == ("odd#px", 0)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_chain_equals_the_jax_packages(self, seed):
        from psana_ray_tpu.cluster import hashring as jh

        rng = np.random.default_rng(seed)
        for _ in range(60):
            n = int(rng.integers(1, 7))
            servers = [f"10.0.{int(rng.integers(0, 4))}.{int(rng.integers(0, 256))}:"
                       f"{int(rng.integers(1024, 65536))}" for _ in range(n)]
            if rng.random() < 0.2:
                servers.append(servers[0])  # a duplicate spelling
            queue = f"q{int(rng.integers(0, 1 << 30))}"
            p = int(rng.integers(0, 64))
            assert ranked_owners(servers, queue, p) == jh.ranked_owners(servers, queue, p)
            assert partition_follower(servers, queue, p) == jh.partition_follower(
                servers, queue, p)
            for me in [*servers, "nowhere:1"]:
                assert next_in_chain(servers, me, queue, p) == jh.next_in_chain(
                    servers, me, queue, p)
            nparts = int(rng.integers(1, 9))
            ours = PartitionMap.compute(servers, queue, nparts)
            theirs = jh.PartitionMap.compute(servers, queue, nparts)
            assert [ours.follower_of(q) for q in range(nparts)] == [
                theirs.follower_of(q) for q in range(nparts)]


# ---------------------------------------------------------------------------
# SegmentLog's reconciliation
# ---------------------------------------------------------------------------
class TestLogReconciliation:
    def _log(self, tmp_path, name="l", **kw):
        kw.setdefault("segment_bytes", 4096)
        kw.setdefault("fsync", "none")
        return SegmentLog(str(tmp_path / name), **kw)

    def test_truncate_to_mid_segment_and_reappend(self, tmp_path):
        log = self._log(tmp_path)
        for i in range(10):
            log.append({"i": i})
        log.truncate_to(6)
        assert log.next_offset == 6
        assert log.read(5) == {"i": 5}
        with pytest.raises(KeyError):
            log.read(6)
        assert log.append({"i": "new6"}) == 6
        log.close()
        log2 = self._log(tmp_path)  # a boot scan agrees: no torn tail from the cut
        assert log2.next_offset == 7
        assert log2.read(6) == {"i": "new6"}
        assert not log2.torn_tail_repaired
        log2.close()

    def test_truncate_across_segments(self, tmp_path):
        log = self._log(tmp_path, segment_bytes=512)
        payload = {"pad": "x" * 100}
        for i in range(12):
            log.append(dict(payload, i=i))
        assert len(log.stats()["committed"]) == 0
        assert log.stats()["segments"] > 1
        log.truncate_to(3)
        assert log.next_offset == 3
        assert log.read(2)["i"] == 2
        for i in range(3, 6):
            assert log.append(dict(payload, i=i)) == i
        log.close()
        log2 = self._log(tmp_path, segment_bytes=512)
        assert log2.next_offset == 6
        assert [log2.read(i)["i"] for i in range(6)] == list(range(6))
        log2.close()

    def test_reset_to_starts_a_new_offset_space(self, tmp_path):
        log = self._log(tmp_path)
        for i in range(5):
            log.append({"i": i})
        log.reset_to(100)
        assert log.next_offset == 100
        assert log.first_retained_offset() == 100
        assert log.append_at(100, {"i": 100}) == 100
        log.close()
        log2 = self._log(tmp_path)
        assert log2.next_offset == 101
        assert log2.read(100) == {"i": 100}
        log2.close()

    def test_reset_to_after_a_failed_segment_mint_starts_clean(self, tmp_path, monkeypatch):
        """A reset whose new segment cannot be made (a full disk) leaves no
        closed, unlinked segment behind: the next reset, and appends after
        it, work (the JAX package's ``_reset_locked`` empties the ring before
        it mints, and so does the port's)."""
        log = self._log(tmp_path)
        for i in range(5):
            log.append({"i": i})
        mint = log._new_segment

        def full_disk(offset):
            raise OSError(28, "No space left on device")

        monkeypatch.setattr(log, "_new_segment", full_disk)
        with pytest.raises(OSError):
            log.reset_to(100)
        monkeypatch.setattr(log, "_new_segment", mint)
        log.reset_to(100)
        assert log.append_at(100, {"i": 100}) == 100
        assert log.read(100) == {"i": 100}
        log.close()
        log2 = self._log(tmp_path)
        assert log2.next_offset == 101 and log2.read(100) == {"i": 100}
        log2.close()

    def test_append_at_enforces_contiguity(self, tmp_path):
        log = self._log(tmp_path)
        log.append_at(0, {"i": 0})
        with pytest.raises(ValueError, match="out of order"):
            log.append_at(5, {"i": 5})
        with pytest.raises(ValueError, match="out of order"):
            log.append_at(0, {"i": 0})
        log.close()

    def test_disk_fault_hook_covers_append_at(self, tmp_path):
        from faultproxy import DiskFaultInjector

        log = self._log(tmp_path)
        log.append_at(0, {"i": 0})
        faults = DURABLE.stats()["disk_faults_total"]
        set_disk_fault_hook(DiskFaultInjector(ops=("append",)))
        try:
            with pytest.raises(OSError):
                log.append_at(1, {"i": 1})
        finally:
            set_disk_fault_hook(None)
        assert DURABLE.stats()["disk_faults_total"] == faults + 1
        assert log.append_at(1, {"i": 1}) == 1  # the offset was never taken
        log.close()


# ---------------------------------------------------------------------------
# ReplicaSet's ingest
# ---------------------------------------------------------------------------
class TestReplicaSetIngest:
    def test_ingest_overlap_truncates_and_gap_resets(self, tmp_path):
        rs = ReplicaSet(str(tmp_path), segment_bytes=1 << 16, fsync="none")
        entry = rs.subscribe_log("ns", "q")
        assert entry is not None
        for i in range(6):
            assert rs.ingest(entry, i, _REPL_NO_FLOOR, {"i": i})
        assert rs.ingest(entry, 4, _REPL_NO_FLOOR, {"i": "re4"})  # the owner's view wins
        assert entry.log.next_offset == 5
        assert entry.log.read(4) == {"i": "re4"}
        resets = REPL.count_of("replica_reset")
        assert rs.ingest(entry, 50, _REPL_NO_FLOOR, {"i": 50})  # a gap resets, loudly
        assert entry.log.first_retained_offset() == 50
        assert entry.log.next_offset == 51
        assert REPL.count_of("replica_reset") == resets + 1
        rs.close_all()

    def test_floor_commits_ride_with_stride_and_promote_is_exact(self, tmp_path):
        rs = ReplicaSet(str(tmp_path), segment_bytes=1 << 16, fsync="none")
        entry = rs.subscribe_log("ns", "q")
        for i in range(8):
            rs.ingest(entry, i, floor=i - 2, item={"i": i})
        assert entry.log.committed("") == -1  # the stride was not reached
        assert rs.promote("ns", "q") == (0, 8)
        reopened = SegmentLog(str(tmp_path / "ns__q"), fsync="none")
        assert reopened.committed("") == 5  # the exact latest floor
        reopened.close()

    def test_promotion_fences_ingest_and_resubscribe(self, tmp_path):
        rs = ReplicaSet(str(tmp_path), segment_bytes=1 << 16, fsync="none")
        entry = rs.subscribe_log("ns", "q")
        assert rs.ingest(entry, 0, _REPL_NO_FLOOR, {"i": 0})
        assert rs.promote("ns", "q") is not None
        assert rs.promote("ns", "q") is None
        assert not rs.ingest(entry, 1, _REPL_NO_FLOOR, {"i": 1})  # fenced
        assert rs.subscribe_log("ns", "q") is None  # a zombie's resubscribe


# ---------------------------------------------------------------------------
# two servers: the ack floor, degrading, promotion
# ---------------------------------------------------------------------------
class TestReplicationEndToEnd:
    def _pair(self, tmp_path, **mgr_kw):
        dirs = [str(tmp_path / f"s{i}") for i in range(2)]
        for d in dirs:
            os.makedirs(d, exist_ok=True)
        ports = [_free_port(), _free_port()]
        peers = [f"127.0.0.1:{p}" for p in ports]
        servers = [_replicated_server(dirs[i], peers, peers[i], ports[i], **mgr_kw)
                   for i in range(2)]
        return dirs, ports, peers, servers

    def test_flush_means_follower_logged_and_promote_serves(self, tmp_path):
        dirs, ports, peers, servers = self._pair(tmp_path)
        try:
            qname = _pick_queue_name(peers, peers[0])
            c = TcpQueueClient("127.0.0.1", ports[0], namespace="ns", queue_name=qname)
            n = 24
            for i in range(n):
                assert c.put_pipelined(_frame(i), deadline=time.monotonic() + 30)
            assert c.flush_puts(time.monotonic() + 30)
            got = c.get_batch(4, timeout=5.0)
            assert len(got) == 4
            c.disconnect()
            # flushed: every frame was follower-acked, so the replica holds all
            servers[1].shutdown()  # releases the replica's mapping
            rlog = SegmentLog(os.path.join(dirs[1], f"ns__{qname}"), fsync="none")
            assert rlog.next_offset == n
            assert not rlog.torn_tail_repaired
            rlog.close()
        finally:
            _shutdown(servers)

    def test_owner_death_promote_serves_backlog_and_replay(self, tmp_path):
        dirs, ports, peers, servers = self._pair(tmp_path)
        try:
            qname = _pick_queue_name(peers, peers[0])
            c = TcpQueueClient("127.0.0.1", ports[0], namespace="ns", queue_name=qname)
            n = 16
            for i in range(n):
                assert c.put_pipelined(_frame(i), deadline=time.monotonic() + 30)
            assert c.flush_puts(time.monotonic() + 30)
            c.disconnect()
            # the owner dies with its disk: the bytes live only on the follower
            servers[0].shutdown()
            shutil.rmtree(dirs[0])
            c2 = TcpQueueClient("127.0.0.1", ports[1])
            rng = c2.promote("ns", qname)
            assert rng is not None and rng["end"] == n
            c2.open("ns", qname, 256)
            drained = []
            while True:
                batch = c2.get_batch(64, timeout=2.0)
                if not batch:
                    break
                drained.extend(batch)
            assert sorted(r.event_idx for r in drained) == list(range(n))
            c2.disconnect()
            c3 = TcpQueueClient("127.0.0.1", ports[1], namespace="ns", queue_name=qname)
            rng2 = c3.replay_open(from_offset="begin", group="audit")
            assert rng2["end"] - rng2["start"] == n
            replayed = []
            while True:
                batch = c3.get_batch(64, timeout=1.0)
                if not batch:
                    break
                replayed.extend(batch)
            assert len(replayed) == n
            c3.disconnect()
        finally:
            _shutdown(servers)

    def test_owner_restarted_behind_replica_is_fenced_not_rewound(self, tmp_path):
        """An owner back with an emptied disk while its replica holds acked
        records fences itself (and serves degraded) rather than rewind the
        only surviving copy."""
        dirs, ports, peers, servers = self._pair(tmp_path, degrade_after_s=0.5)
        try:
            qname = _pick_queue_name(peers, peers[0])
            c = TcpQueueClient("127.0.0.1", ports[0], namespace="ns", queue_name=qname)
            n = 12
            for i in range(n):
                assert c.put_pipelined(_frame(i), deadline=time.monotonic() + 30)
            assert c.flush_puts(time.monotonic() + 30)
            c.disconnect()
            servers[0].shutdown()
            shutil.rmtree(dirs[0])
            os.makedirs(dirs[0])
            fenced_before = REPL.count_of("replication_fenced")
            behind_before = REPL.stats()["owners_fenced_behind"]
            servers[0] = _replicated_server(dirs[0], peers, peers[0], ports[0],
                                            degrade_after_s=0.5)
            c2 = TcpQueueClient("127.0.0.1", ports[0], namespace="ns", queue_name=qname)
            assert c2.put_wait(_frame(99), timeout=15.0)
            assert _wait(lambda: REPL.count_of("replication_fenced") > fenced_before)
            assert REPL.stats()["owners_fenced_behind"] > behind_before
            c2.disconnect()
            servers[1].shutdown()
            rlog = SegmentLog(os.path.join(dirs[1], f"ns__{qname}"), fsync="none")
            assert rlog.next_offset == n  # the replica survived untouched
            rlog.close()
        finally:
            _shutdown(servers)

    def test_acks_held_until_follower_logs(self, tmp_path):
        """With the follower absent and a grace of 1 s, windowed puts stay
        unanswered; once the grace lapses the owner degrades, loudly, and
        the answers flow."""
        d = str(tmp_path / "owner")
        os.makedirs(d)
        port, dead_port = _free_port(), _free_port()  # nothing listens on dead_port
        peers = [f"127.0.0.1:{port}", f"127.0.0.1:{dead_port}"]
        srv = _replicated_server(d, peers, peers[0], port, degrade_after_s=1.0)
        try:
            qname = _pick_queue_name(peers, peers[0])
            c = TcpQueueClient("127.0.0.1", port, namespace="ns", queue_name=qname,
                               put_window=4)
            degr0 = REPL.count_of("replication_degraded")
            t0 = time.monotonic()
            assert c.put_pipelined(_frame(0), deadline=t0 + 30)
            assert not c.flush_puts(time.monotonic() + 0.3)  # held
            assert c.flush_puts(time.monotonic() + 10.0)
            assert time.monotonic() - t0 >= 0.9
            assert REPL.count_of("replication_degraded") > degr0
            c.disconnect()
        finally:
            srv.shutdown()

    def test_hung_follower_degrades_after_grace(self, tmp_path):
        """A follower that accepts the link but stops acking meets the same
        grace as one that refuses the dial."""
        from faultproxy import FaultProxy

        d0, d1 = str(tmp_path / "o"), str(tmp_path / "f")
        os.makedirs(d0)
        os.makedirs(d1)
        oport, fport = _free_port(), _free_port()
        proxy = FaultProxy("127.0.0.1", fport)
        peers = [f"127.0.0.1:{oport}", f"127.0.0.1:{proxy.port}"]
        owner = _replicated_server(d0, peers, peers[0], oport, degrade_after_s=1.0)
        follower = _replicated_server(d1, peers, peers[1], fport)
        try:
            qname = _pick_queue_name(peers, peers[0])
            # the subscription goes through, then the owner -> follower
            # direction stalls in the first append, for good. The proxy
            # forwards a whole read (64 KiB at most) before it stalls, and
            # the appends leave back to back: frames of 256 KiB keep the
            # first one from arriving whole
            proxy.stall_at("up", 256, stall_s=120.0)
            degr0 = REPL.count_of("replication_degraded")
            c = TcpQueueClient("127.0.0.1", oport, namespace="ns", queue_name=qname)
            for i in range(6):
                assert c.put_pipelined(_frame(i, shape=(2, 256, 256)),
                                       deadline=time.monotonic() + 30)
            assert c.flush_puts(time.monotonic() + 20)
            assert REPL.count_of("replication_degraded") > degr0
            c.disconnect()
        finally:
            owner.shutdown()
            follower.shutdown()
            proxy.close()

    def test_idle_floor_refresh_bounds_the_redelivery(self, tmp_path):
        """The producer has ended and a consumer drains: the owner's newer
        floor reaches the follower without another put, so a promotion
        re-exposes only what was not consumed."""
        dirs, ports, peers, servers = self._pair(tmp_path)
        try:
            qname = _pick_queue_name(peers, peers[0])
            c = TcpQueueClient("127.0.0.1", ports[0], namespace="ns", queue_name=qname)
            n = 40
            for i in range(n):
                assert c.put_pipelined(_frame(i), deadline=time.monotonic() + 30)
            assert c.flush_puts(time.monotonic() + 30)
            refreshes = REPL.stats()["floor_refreshes"]
            consumed = c.get_batch(30, timeout=5.0)
            assert len(consumed) == 30
            c.size()  # the implicit ack moves the owner's floor to 29
            assert _wait(lambda: REPL.stats()["floor_refreshes"] > refreshes)
            c.disconnect()
            servers[0].shutdown()
            shutil.rmtree(dirs[0])
            c2 = TcpQueueClient("127.0.0.1", ports[1])
            assert c2.promote("ns", qname) == {"start": 0, "end": n}
            c2.open("ns", qname, 256)
            rest = c2.get_batch(64, timeout=2.0)
            assert sorted(r.event_idx for r in rest) == list(range(30, n))
            c2.disconnect()
        finally:
            _shutdown(servers)


def test_unknown_replica_codec_fails_fast(tmp_path):
    """An unknown codec fails at the manager's construction, not in the
    shipper thread (which would hold every producer answer for good)."""
    with pytest.raises(ValueError):
        ReplicationManager(str(tmp_path), ["a:1", "b:2"], "a:1", codec="no-such-codec")


def test_a_compressed_link_ships_and_promotes(tmp_path):
    dirs = [str(tmp_path / f"s{i}") for i in range(2)]
    ports = [_free_port(), _free_port()]
    peers = [f"127.0.0.1:{p}" for p in ports]
    servers = [_replicated_server(dirs[i], peers, peers[i], ports[i], codec="shuffle-rle")
               for i in range(2)]
    try:
        qname = _pick_queue_name(peers, peers[0])
        c = TcpQueueClient("127.0.0.1", ports[0], namespace="ns", queue_name=qname)
        for i in range(8):
            assert c.put_pipelined(_frame(i, shape=(2, 32, 32)),
                                   deadline=time.monotonic() + 30)
        assert c.flush_puts(time.monotonic() + 30)
        c.disconnect()
        servers[0].shutdown()
        c2 = TcpQueueClient("127.0.0.1", ports[1], namespace="ns", queue_name=qname)
        got = c2.get_batch(64, timeout=2.0)  # the OPEN promotes on its own
        assert sorted(r.event_idx for r in got) == list(range(8))
        assert all(np.array_equal(r.panels, _frame(r.event_idx, (2, 32, 32)).panels)
                   for r in got)
        c2.disconnect()
    finally:
        _shutdown(servers)


# ---------------------------------------------------------------------------
# cluster failover: the coordinator killed and its disk deleted
# ---------------------------------------------------------------------------
class TestClusterFailover:
    def test_kill_coordinator_and_delete_disk_loses_nothing(self, tmp_path):
        N, P, NF = 3, 4, 60
        dirs = [str(tmp_path / f"s{i}") for i in range(N)]
        for d in dirs:
            os.makedirs(d)
        ports = [_free_port() for _ in range(N)]
        peers = [f"127.0.0.1:{p}" for p in ports]
        servers = [_replicated_server(dirs[i], peers, peers[i], ports[i], group_store=True)
                   for i in range(N)]
        prod = cons = None
        try:
            prod = ClusterClient(peers, queue_name="cq", n_partitions=P, maxsize=256,
                                 retain=256, reconnect_tries=1, reconnect_base_s=0.05)
            cons = ClusterClient(peers, queue_name="cq", n_partitions=P, maxsize=256,
                                 group="g1", reconnect_tries=1, reconnect_base_s=0.05)
            err = {}

            def produce():
                try:
                    for i in range(NF):
                        assert prod.put_pipelined(_frame(i), deadline=time.monotonic() + 60), i
                        if i == NF // 3:
                            # the coordinator (server 0) dies with its disk:
                            # its partitions and the group state must survive
                            servers[0].shutdown()
                            shutil.rmtree(dirs[0])
                    assert prod.flush_puts(time.monotonic() + 60)
                    assert prod.put_wait(EndOfStream(0, -1, 1, 1), timeout=60)
                except BaseException as e:  # noqa: BLE001 (reported below)
                    err["e"] = e

            t = threading.Thread(target=produce, daemon=True)
            t.start()
            seen, eos = [], 0
            deadline = time.monotonic() + 120
            while not eos and time.monotonic() < deadline:
                if "e" in err:
                    raise err["e"]
                for item in cons.get_batch_stream(32, timeout=0.5):
                    if is_eos(item):
                        eos += 1
                    else:
                        seen.append(item.event_idx)
            t.join(10)
            if "e" in err:
                raise err["e"]
            assert eos == 1, "the group's EOS never came after the failover"
            lost = sorted(set(range(NF)) - set(seen))
            assert not lost, f"LOST {len(lost)}: {lost[:10]}"
            # the generation went on and a stale-generation commit is fenced
            info = cons._rpc({"op": "info", "group": "g1"})
            assert info["ok"] and len(info["drained"]) == P
            stale = cons._rpc({"op": "drained", "group": "g1", "member": "zombie",
                               "generation": info["generation"] - 1, "partition": 0})
            assert stale.get("fenced"), stale
            replayer = ClusterClient([a for a in peers if a != peers[0]], queue_name="cq",
                                     n_partitions=P, maxsize=256, reconnect_tries=1,
                                     reconnect_base_s=0.05)
            try:
                replayer.replay_open(from_offset="begin", group="audit")
                replayed, empty_reads = [], 0
                while empty_reads < 3:
                    batch = replayer.get_batch(64, timeout=1.0)
                    if batch:
                        replayed.extend(b for b in batch if not is_eos(b))
                        empty_reads = 0
                    else:
                        empty_reads += 1
                assert len({r.event_idx for r in replayed}) >= NF // 2
            finally:
                replayer.disconnect()
        finally:
            for c in (prod, cons):
                if c is not None:
                    try:
                        c.disconnect()
                    except Exception:
                        pass
            _shutdown(servers)


# ---------------------------------------------------------------------------
# a dead server's undelivered frames once the producer has ended
# ---------------------------------------------------------------------------
def _two_two_queue(peers, n_partitions=4, prefix="ended"):
    """A queue name whose partitions split 2 + 2 over two servers."""
    for i in range(512):
        m = PartitionMap.compute(peers, f"{prefix}_{i}", n_partitions)
        if sorted(len(m.partitions_on(s)) for s in peers) == [2, 2]:
            return f"{prefix}_{i}"
    raise AssertionError("no 2 + 2 queue name in 512 tries")


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("replicated", [False, True])
def test_a_dead_servers_undelivered_frames_after_the_producer_ended(tmp_path, package,
                                                                     replicated):
    """The producer puts every frame and its EOS and ends; a consumer reads
    part; the server holding two of the four partitions dies with its
    disk. Unreplicated (either package), the moved partitions start empty
    on the survivor and the undelivered frames are lost; replicated, the
    survivor promotes its replica and nothing is lost (the port bounds
    the redelivery by the stream window, its floor having reached the
    follower while the log was idle)."""
    if package == "port":
        Client, Server, Mgr, factory = (ClusterClient, TcpQueueServer, ReplicationManager,
                                        _durable_factory)
        Frame, Eos, eos_of = FrameRecord, EndOfStream, is_eos
    else:
        from psana_ray_tpu.cluster.client import ClusterClient as Client
        from psana_ray_tpu.cluster.replication import ReplicationManager as Mgr
        from psana_ray_tpu.records import EndOfStream as Eos
        from psana_ray_tpu.records import FrameRecord as Frame
        from psana_ray_tpu.records import is_eos as eos_of
        from psana_ray_tpu.storage import DurableRingBuffer as JDurable
        from psana_ray_tpu.storage import SegmentLog as JLog
        from psana_ray_tpu.transport.tcp import TcpQueueServer as Server

        def factory(d):
            def f(ns, name, maxsize):
                log = JLog(os.path.join(d, f"{ns}__{name}"), segment_bytes=1 << 20,
                           fsync="none")
                return JDurable(log, maxsize=maxsize, name=f"{ns}__{name}")
            return f

    NF, P, WINDOW = 64, 4, 8
    dirs = [str(tmp_path / f"s{i}") for i in range(2)]
    for d in dirs:
        os.makedirs(d)
    ports = [_free_port(), _free_port()]
    peers = [f"127.0.0.1:{p}" for p in ports]
    servers = []
    for i in range(2):
        kw = {"replication": Mgr(dirs[i], peers, peers[i])} if replicated else {}
        servers.append(Server(host="127.0.0.1", port=ports[i], maxsize=256,
                              queue_factory=factory(dirs[i]), **kw).serve_background())
    queue = _two_two_queue(peers)
    victim = 1  # not the coordinator
    prod = cons = None
    try:
        prod = Client(peers, queue_name=queue, n_partitions=P, maxsize=256,
                      reconnect_tries=1, reconnect_base_s=0.05)
        for i in range(NF):
            frame = Frame(0, i, np.full((2, 8, 8), i, np.uint16), 1.0)
            assert prod.put_pipelined(frame, deadline=time.monotonic() + 30)
        assert prod.flush_puts(time.monotonic() + 30)
        assert prod.put_wait(Eos(0, -1, 1, 1), timeout=30)
        prod.disconnect()  # the producer has ended
        prod = None
        cons = Client(peers, queue_name=queue, n_partitions=P, maxsize=256,
                      stream_window=WINDOW, reconnect_tries=1, reconnect_base_s=0.05)
        seen, eos = [], 0
        deadline = time.monotonic() + 20
        while len(seen) < NF // 4 and time.monotonic() < deadline:
            seen.extend(r.event_idx for r in cons.get_batch_stream(4, timeout=0.5)
                        if not eos_of(r))
        # one more read acks what was read before
        seen.extend(r.event_idx for r in cons.get_batch_stream(1, timeout=0.3)
                    if not eos_of(r))
        time.sleep(0.5)  # the floor reaches the follower of an idle log
        on_victim = PartitionMap.compute(peers, queue, P).partitions_on(peers[victim])
        servers[victim].shutdown()
        shutil.rmtree(dirs[victim])
        quiet_until = time.monotonic() + 3.0
        deadline = time.monotonic() + 30
        while not eos and time.monotonic() < min(deadline, quiet_until):
            for r in cons.get_batch_stream(16, timeout=0.5):
                if eos_of(r):
                    eos += 1
                else:
                    seen.append(r.event_idx)
                    quiet_until = time.monotonic() + 3.0
        lost = sorted(set(range(NF)) - set(seen))
        dups = len(seen) - len(set(seen))
        if not replicated:
            assert lost, "an unreplicated dead server's frames came back"
            return
        assert not lost, f"LOST {len(lost)}: {lost[:10]} (eos {eos}, dups {dups})"
        assert eos == 1
        if package == "port":
            assert dups <= WINDOW * len(on_victim), dups
    finally:
        for c in (prod, cons):
            if c is not None:
                try:
                    c.disconnect()
                except Exception:
                    pass
        _shutdown(servers)


# ---------------------------------------------------------------------------
# full-jitter reconnect backoff
# ---------------------------------------------------------------------------
class TestReconnectJitter:
    def test_backoff_sleeps_are_jittered_not_lockstep(self, monkeypatch):
        """Every backoff sleep is uniform in [0, envelope): clients that saw
        one server die do not dial again in lockstep."""
        sleeps = []
        monkeypatch.setattr(time, "sleep", lambda s: sleeps.append(s))
        port = _free_port()  # nothing listens: every dial fails fast
        per_client = []
        for _ in range(3):
            before = len(sleeps)
            with pytest.raises(TransportClosed):
                TcpQueueClient("127.0.0.1", port, timeout_s=0.2, reconnect_tries=5,
                               reconnect_base_s=0.05)
            per_client.append(sleeps[before:])
        caps = [0.05, 0.1, 0.2, 0.4]
        for client_sleeps in per_client:
            assert len(client_sleeps) == len(caps)
            for s, cap in zip(client_sleeps, caps):
                assert 0.0 <= s < cap
        firsts = [cs[0] for cs in per_client]
        assert len(set(firsts)) == len(firsts), firsts


# ---------------------------------------------------------------------------
# a failing durable disk is answered, and the loop lives
# ---------------------------------------------------------------------------
class TestDiskFaultDegradesLoudly:
    def test_enospc_answers_E_and_loop_survives(self, tmp_path):
        from faultproxy import DiskFaultInjector

        srv = TcpQueueServer(host="127.0.0.1", port=0, maxsize=64,
                             queue_factory=_durable_factory(str(tmp_path))).serve_background()
        try:
            c = TcpQueueClient("127.0.0.1", srv.port, namespace="ns", queue_name="dq")
            assert c.put(_frame(0))
            faults_before = DURABLE.stats()["disk_faults_total"]
            inj = DiskFaultInjector()
            set_disk_fault_hook(inj)
            try:
                with pytest.raises(RuntimeError, match="protocol error"):
                    c.put(_frame(1))
                assert inj.fired >= 1
                assert DURABLE.stats()["disk_faults_total"] > faults_before
                assert c.size() >= 1  # the loop lives through the fault
            finally:
                set_disk_fault_hook(None)
            assert c.put(_frame(2))
            got = c.get_batch(16, timeout=5.0)
            assert sorted(r.event_idx for r in got) == [0, 2]
            c.disconnect()
        finally:
            srv.shutdown()

    def test_injector_arms_after_n_ok_ops(self, tmp_path):
        from faultproxy import DiskFaultInjector

        log = SegmentLog(str(tmp_path / "l"), fsync="none")
        set_disk_fault_hook(DiskFaultInjector(ok_ops=2, ops=("append",)))
        try:
            log.append({"i": 0})
            log.append({"i": 1})
            with pytest.raises(OSError):
                log.append({"i": 2})
        finally:
            set_disk_fault_hook(None)
        assert log.append({"i": 3}) == 2  # offset 2 was never taken
        log.close()

    def test_a_replica_disk_fault_answers_E_on_the_link(self, tmp_path):
        """A follower whose disk fails answers the owner's append 'E': the
        owner's sender takes it as a refusal and degrades, and its
        producers are answered."""
        from faultproxy import DiskFaultInjector

        dirs = [str(tmp_path / f"s{i}") for i in range(2)]
        ports = [_free_port(), _free_port()]
        peers = [f"127.0.0.1:{p}" for p in ports]
        servers = [_replicated_server(dirs[i], peers, peers[i], ports[i]) for i in range(2)]
        try:
            qname = _pick_queue_name(peers, peers[0])
            c = TcpQueueClient("127.0.0.1", ports[0], namespace="ns", queue_name=qname)
            assert c.put(_frame(0))  # the link is up, the replica has it
            fenced = REPL.count_of("replication_fenced")
            # the owner's own append succeeds, the follower's fails
            set_disk_fault_hook(DiskFaultInjector(ok_ops=1, ops=("append",)))
            try:
                assert c.put(_frame(1))
            finally:
                set_disk_fault_hook(None)
            assert REPL.count_of("replication_fenced") > fenced
            c.disconnect()
        finally:
            _shutdown(servers)


# ---------------------------------------------------------------------------
# slow: kill and restart a random server under open-loop load
# ---------------------------------------------------------------------------
@pytest.mark.slow
class TestChaosKillRestart:
    def test_three_server_chaos_loses_nothing(self, tmp_path):
        """Kills and restarts under load, one victim losing its disk: an
        intact-disk victim comes back fast and clients ride their
        reconnect; the deleted-disk victim stays down and its partitions
        serve from promoted replicas."""
        import random as _random

        rng = _random.Random(1311)
        N, P, NF = 3, 4, 240
        dirs = [str(tmp_path / f"s{i}") for i in range(N)]
        for d in dirs:
            os.makedirs(d)
        ports = [_free_port() for _ in range(N)]
        peers = [f"127.0.0.1:{p}" for p in ports]

        def boot(i):
            return _replicated_server(dirs[i], peers, peers[i], ports[i], group_store=True)

        servers = [boot(i) for i in range(N)]
        prod = cons = None
        try:
            prod = ClusterClient(peers, queue_name="chaos", n_partitions=P, maxsize=256,
                                 retain=512, reconnect_tries=6, reconnect_base_s=0.1)
            cons = ClusterClient(peers, queue_name="chaos", n_partitions=P, maxsize=256,
                                 reconnect_tries=6, reconnect_base_s=0.1)
            err = {}
            kills = {"n": 0, "deleted": False}
            dead_idx = []

            def restart_victim():
                victim = rng.choice([j for j in range(N) if j not in dead_idx])
                servers[victim].shutdown()
                servers[victim] = boot(victim)
                kills["n"] += 1

            def delete_victim():
                owners = {prod.partition_map.assignments[p] for p in range(P)}
                victim = rng.choice([j for j in range(N)
                                     if j not in dead_idx and peers[j] in owners])
                servers[victim].shutdown()
                shutil.rmtree(dirs[victim])
                servers[victim] = None
                dead_idx.append(victim)
                kills["n"] += 1
                kills["deleted"] = True

            plan = {NF // 5: restart_victim, 2 * NF // 5: delete_victim,
                    3 * NF // 5: restart_victim}

            def produce():
                try:
                    for i in range(NF):
                        assert prod.put_pipelined(_frame(i), deadline=time.monotonic() + 120), i
                        action = plan.get(i)
                        if action is not None:
                            action()
                    assert prod.flush_puts(time.monotonic() + 120)
                    assert prod.put_wait(EndOfStream(0, -1, 1, 1), timeout=120)
                except BaseException as e:  # noqa: BLE001 (reported below)
                    err["e"] = e

            t = threading.Thread(target=produce, daemon=True)
            t.start()
            seen, eos = [], 0
            deadline = time.monotonic() + 300
            while not eos and time.monotonic() < deadline:
                if "e" in err:
                    raise err["e"]
                for item in cons.get_batch_stream(32, timeout=0.5):
                    if is_eos(item):
                        eos += 1
                    else:
                        seen.append(item.event_idx)
            t.join(15)
            if "e" in err:
                raise err["e"]
            assert eos == 1, "end-of-stream never fired"
            assert kills["n"] >= 3 and kills["deleted"]
            lost = sorted(set(range(NF)) - set(seen))
            assert not lost, f"chaos LOST {len(lost)}: {lost[:10]}"
            gone = peers[dead_idx[0]]
            assert gone not in prod.partition_map.servers
            assert gone not in cons.partition_map.servers
        finally:
            for c in (prod, cons):
                if c is not None:
                    try:
                        c.disconnect()
                    except Exception:
                        pass
            _shutdown(servers)
