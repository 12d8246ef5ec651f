"""Chain-replicated partition logs and the coordinator's leader lease.

The port's copy of ``psana_ray_tpu/cluster/replication.py``, with the
JAX package's wire format, log layout and group-store format: a chain may
mix servers of both packages. The design is van Renesse and Schneider's
chain replication (OSDI 2004):

- **Partition logs.** Each durable partition's segment log ships to a
  follower server over a link of its own: 'H' subscribes to the
  follower's replica log, 'V' appends at an explicit offset, acked
  cumulatively and windowed like 'W' puts, compressed by the negotiated
  'Z' codec. The chain is the rendezvous ranking
  (:func:`~psana_ray_tpu_torch.cluster.hashring.ranked_owners`): rank 0
  owns, rank 1 holds the replica, and when rank 0 dies the recomputed map
  hands the partition to rank 1, which already holds the bytes. 'Y'
  promotes: it fences the replica against a zombie owner and lets the
  next OPEN mount it as the live durable queue; the new owner then ships
  to rank 2.
- **The replicated ack floor.** The owner's event loop answers a
  producer's put only once the follower has logged the record
  (:meth:`ReplicationSender.reached`), so an acknowledged frame outlives
  the owner's disk. A follower link that stays dead past a grace window
  degrades loudly (a counter and a WARNING line), and the answers flow
  again rather than wedge the producers.
- **The committed floor** rides on every append, so a promoted replica
  re-exposes only what its owner had not seen consumed. When the owner's
  log is idle and its floor moved (its producer has ended while
  consumers drain), the sender ships the last record again carrying the
  new floor, at most every ``FLOOR_REFRESH_S``: the follower rewrites the
  same record at the same offset. So a failover after the producer ended
  redelivers what the windows held, not everything consumed since the
  last put.
- **The coordinator's leader lease.** Every group mutation pushes the
  :class:`~psana_ray_tpu_torch.cluster.coordinator.GroupRegistry`'s
  control state (generation, partition count, drained partitions,
  offsets; never member leases) to the next live peer over the 'N' RPC
  (``lease``, then ``sync``), under a lease the receiving registry
  enforces. A coordinator failover then continues the same generations,
  so a stale-generation commit stays fenced.

The port has no flight recorder: each event the JAX package records
there is a log line of the same name here, counted in :data:`REPL`
(``REPL.count_of(name)``).

Wiring: build a :class:`ReplicationManager` (``queue_server
--replicate_peers ... --advertise ...``) and hand it to
``TcpQueueServer(replication=...)``; the server's ``open_named`` mounts
senders and promotes replicas, and the event loop serves 'H', 'V', 'Y'
and holds producer answers on the floor. Imports no torch.
"""

from __future__ import annotations

import json
import logging
import os
import random
import socket
import struct
import threading
import time
from typing import Dict, Optional, Tuple

from psana_ray_tpu_torch.cluster.hashring import next_in_chain
from psana_ray_tpu_torch.obs.flight import FLIGHT
from psana_ray_tpu_torch.obs.registry import ensure_registered
from psana_ray_tpu_torch.storage.log import (
    DEFAULT_FSYNC_BATCH_N,
    DEFAULT_RETAIN_SEGMENTS,
    DEFAULT_SEGMENT_BYTES,
    FSYNC_BATCH,
    SegmentLog,
)
from psana_ray_tpu_torch.transport.codec import (
    available_codecs,
    encode_for_wire as _wire_encode,
    get_codec,
    payload_nbytes as _parts_nbytes,
)
from psana_ray_tpu_torch.transport.registry import TransportClosed
from psana_ray_tpu_torch.transport.tcp import (
    _OP_BYE,
    _OP_CODEC,
    _OP_REPL_APPEND,
    _OP_REPL_OPEN,
    _REPL_NO_FLOOR,
    _ST_OK,
    _recv_exact,
    _sendmsg_all,
)
from psana_ray_tpu_torch.utils.bufpool import BufferPool

logger = logging.getLogger(__name__)

# appends in flight on one link before the shipper waits for acks: the
# windowed-put shape
DEFAULT_REPL_WINDOW = 32
# how long a dead follower link may hold producer answers before the owner
# degrades to unreplicated, loudly
DEFAULT_DEGRADE_AFTER_S = 5.0
# a follower persists the piggybacked floor every this many offsets (each
# commit is a synced sidecar line); promotion commits the exact latest
FLOOR_COMMIT_STRIDE = 32
# the idle floor refresh's cadence (see the module docstring)
FLOOR_REFRESH_S = 0.1


def parse_partition(queue_name: str) -> Tuple[str, int]:
    """``(base queue, partition)`` of a ``q#pN`` name; a plain durable
    queue chains as partition 0 of itself."""
    base, sep, tail = queue_name.rpartition("#p")
    if sep and tail.isdigit():
        return base, int(tail)
    return queue_name, 0


class ReplicationTelemetry:
    """The process's replication counters, the lag of its live senders
    (records appended on owners, not yet follower-acked), and a count of
    each logged event by name."""

    def __init__(self):
        self._lock = threading.Lock()
        self.links_opened = 0  # guarded-by: _lock
        self.link_reconnects = 0  # guarded-by: _lock
        self.records_shipped = 0  # guarded-by: _lock
        self.bytes_shipped = 0  # guarded-by: _lock
        self.degrades = 0  # guarded-by: _lock
        self.restores = 0  # guarded-by: _lock
        self.fenced_links = 0  # guarded-by: _lock
        # owners that restarted behind their replica and fenced themselves
        # rather than rewind the better copy
        self.owners_fenced_behind = 0  # guarded-by: _lock
        self.replica_appends = 0  # records a follower logged  # guarded-by: _lock
        self.promotes = 0  # promotions a follower served  # guarded-by: _lock
        self.floor_refreshes = 0  # idle floor refreshes shipped  # guarded-by: _lock
        self.coord_syncs = 0  # guarded-by: _lock
        self.lease_denied = 0  # guarded-by: _lock
        self.events: Dict[str, int] = {}  # guarded-by: _lock
        self._senders: list = []  # guarded-by: _lock

    def note(self, name: str, level: int = logging.INFO, **fields) -> None:
        """Count one event, log it as ``name {fields}`` and record it in the
        flight recorder."""
        with self._lock:
            self.events[name] = self.events.get(name, 0) + 1
        logger.log(level, "%s %s", name, json.dumps(fields, default=str))
        FLIGHT.record(name, **fields)

    def count_of(self, name: str) -> int:
        with self._lock:
            return self.events.get(name, 0)

    def track(self, sender) -> None:
        ensure_registered("replication", self)  # a process's first link comes here
        with self._lock:
            self._senders.append(sender)

    def untrack(self, sender) -> None:
        with self._lock:
            try:
                self._senders.remove(sender)
            except ValueError:
                pass

    def bump(self, counter: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, counter, getattr(self, counter) + n)

    def shipped(self, records: int, nbytes: int) -> None:
        with self._lock:
            self.records_shipped += records
            self.bytes_shipped += nbytes

    def stats(self) -> dict:
        with self._lock:
            senders = list(self._senders)
            out = {k: getattr(self, k) for k in (
                "links_opened", "link_reconnects", "records_shipped", "bytes_shipped",
                "degrades", "restores", "fenced_links", "owners_fenced_behind",
                "replica_appends", "promotes", "floor_refreshes", "coord_syncs",
                "lease_denied")}
            out["events"] = dict(self.events)
        out["lag_records"] = sum(s.lag() for s in senders)
        return out


REPL = ReplicationTelemetry()


class ReplicaRefused(RuntimeError):
    """The follower refused the subscription or an append: no durable
    backing there, the queue is mounted live on it, or the replica was
    promoted. A zombie owner takes it as "stop replicating" and never
    retries through it."""


class ReplicaLink:
    """The owner's end of one chain hop: a connection of its own to the
    follower, subscribed ('H') to one replica log, shipping pipelined 'V'
    appends and reading cumulative acks. Not thread-safe: one
    :class:`ReplicationSender` thread owns it."""

    def __init__(self, host: str, port: int, namespace: str, queue_name: str,
                 codec: Optional[str] = None, pool: Optional[BufferPool] = None,
                 timeout_s: float = 10.0):
        self.host, self.port = host, port
        self._ns, self._nm = namespace, queue_name
        self._timeout_s = timeout_s
        self._pool = pool if pool is not None else BufferPool.default()
        self._codec = None  # the negotiated codec (None: raw)
        if codec == "auto":
            self._codec_names = available_codecs() or None
        elif codec:
            get_codec(codec)  # an unknown name fails here
            self._codec_names = [codec]
        else:
            self._codec_names = None
        self.tail: Optional[int] = None  # the follower's tail once subscribed
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def subscribe(self) -> int:
        """The 'H' exchange: bind this connection to the follower's replica
        log and learn its tail, where shipping resumes. Raises
        :class:`ReplicaRefused` on '0'."""
        if self.tail is not None:
            return self.tail
        if self._codec_names:
            self._negotiate()
        ns, nm = self._ns.encode(), self._nm.encode()
        self._sock.sendall(_OP_REPL_OPEN + struct.pack("<H", len(ns)) + ns
                           + struct.pack("<H", len(nm)) + nm)
        st = _recv_exact(self._sock, 1)
        if st != _ST_OK:
            raise ReplicaRefused(
                f"follower {self.host}:{self.port} refused the replica subscription for "
                f"{self._ns}/{self._nm} ({st!r}): no durable backing there, the queue is "
                f"mounted live, or it was promoted")
        (self.tail,) = struct.unpack("<Q", _recv_exact(self._sock, 8))
        return self.tail

    def _negotiate(self) -> None:
        """'Z' on the link: the shipped records travel compressed. Any
        refusal leaves the link raw."""
        names = ",".join(self._codec_names).encode()
        self._sock.sendall(_OP_CODEC + struct.pack("<H", len(names)) + names)
        if _recv_exact(self._sock, 1) != _ST_OK:
            return
        (n,) = struct.unpack("<H", _recv_exact(self._sock, 2))
        try:
            self._codec = get_codec(_recv_exact(self._sock, n).decode())
        except ValueError:
            self._codec = None

    def ship(self, offset: int, floor: int, item) -> int:
        """One pipelined 'V' append at ``offset`` with the owner's
        committed floor; acks are read by :meth:`read_ack`. Returns the
        payload's size on the wire."""
        if self.tail is None:
            self.subscribe()
        parts, clease = _wire_encode(item, self._codec, self._pool)
        try:
            n = _parts_nbytes(parts)
            _sendmsg_all(self._sock, [_OP_REPL_APPEND + struct.pack("<QQI", offset, floor, n),
                                      *parts])
        finally:
            if clease is not None:
                clease.release()
        return n

    def read_ack(self, timeout_s: float) -> Optional[int]:
        """One cumulative ack, or None when none arrives within
        ``timeout_s`` (which bounds the status byte only). 'E' raises
        :class:`ReplicaRefused`: promoted under us, or its disk failed."""
        try:
            self._sock.settimeout(timeout_s)
            try:
                st = _recv_exact(self._sock, 1)
            except (BlockingIOError, socket.timeout):
                return None
        finally:
            try:
                self._sock.settimeout(self._timeout_s)
            except OSError:
                pass
        if st != _ST_OK:
            raise ReplicaRefused(f"replica append refused by {self.host}:{self.port} ({st!r}): "
                                 f"promoted under us, or its disk failed")
        (off,) = struct.unpack("<Q", _recv_exact(self._sock, 8))
        return off

    def hang_up(self) -> None:
        """Close the link, with a BYE when subscribed."""
        if self.tail is not None:
            try:
                self._sock.sendall(_OP_BYE)
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass


class ReplicationSender:
    """The owner's half of one chain hop: a daemon thread that tails one
    durable queue's segment log and ships it to the follower, windowed.
    The log is the resend buffer: a reconnect resumes at the follower's
    tail, so nothing is held in memory and no hole can open (the follower
    reconciles an overlap by truncating to the offset).

    The event loop reads two things, each O(1) under the lock:
    :meth:`reached` (the replicated ack floor) and :meth:`lag`."""

    def __init__(self, manager: "ReplicationManager", namespace: str, queue_name: str, queue,
                 follower: str, window: int = DEFAULT_REPL_WINDOW, codec: Optional[str] = None,
                 pool: Optional[BufferPool] = None,
                 degrade_after_s: float = DEFAULT_DEGRADE_AFTER_S):
        self._mgr = manager
        self.namespace, self.queue_name = namespace, queue_name
        self.queue = queue
        self.log = queue.log
        self.follower = follower
        self._window = max(1, int(window))
        self._codec = codec
        self._pool = pool
        self._degrade_after_s = degrade_after_s
        self._lock = threading.Lock()
        self._acked = -1  # the replicated ack floor  # guarded-by: _lock
        self._degraded = False  # guarded-by: _lock
        self._link_down_since: Optional[float] = None  # guarded-by: _lock
        # the shipper thread's own state
        self._next_send = 0
        self._link: Optional[ReplicaLink] = None
        # the last time the link's acks advanced: a connected follower
        # that stops acking meets the same grace as one that refuses
        self._last_progress = time.monotonic()
        self._floor_shipped = -1  # the newest floor the follower was sent
        self._floor_shipped_at = 0.0
        self._stop = threading.Event()
        self._wakeup = threading.Event()
        queue.add_listener(self._poke)
        REPL.track(self)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"repl-ship-{queue_name}")
        self._thread.start()

    # -- the loop's surface (never blocks) ------------------------------------
    def reached(self, offset: int) -> bool:
        """Has the follower logged ``offset``? Also True once degraded
        (the link down past the grace, or fenced by a promotion)."""
        with self._lock:
            return self._degraded or self._acked >= offset

    def acked_floor(self) -> int:
        with self._lock:
            return self._acked

    def lag(self) -> int:
        """Records appended on the owner, not yet follower-acked."""
        with self._lock:
            acked = self._acked
        try:
            return max(0, self.log.next_offset - 1 - acked)
        except RuntimeError:  # the log closed during teardown
            return 0

    # -- lifecycle --------------------------------------------------------------
    def _poke(self) -> None:
        self._wakeup.set()

    def stop(self) -> None:
        self._stop.set()
        self._wakeup.set()
        self._thread.join(timeout=5.0)
        REPL.untrack(self)
        try:
            self.queue.remove_listener(self._poke)
        except Exception:  # noqa: BLE001 (the queue may be closed already)
            pass

    # -- the shipping thread ----------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._pump()
            except ReplicaRefused as e:
                # fenced: the replica was promoted under us, so this is the
                # zombie side of a failover. Stop for good; degraded opens
                # the producers' answers
                self._drop_link()
                with self._lock:
                    self._degraded = True
                REPL.bump("fenced_links")
                REPL.note("replication_fenced", logging.WARNING, queue=self.queue_name,
                          follower=self.follower, error=str(e))
                self._mgr.progress()
                return
            except (ConnectionError, socket.timeout, OSError, RuntimeError):
                self._drop_link()
                REPL.bump("link_reconnects")
                # a full-jitter pause before the next dial
                self._stop.wait(random.uniform(0.02, 0.3))
        self._drop_link()

    def _drop_link(self) -> None:
        link, self._link = self._link, None
        if link is not None:
            link.hang_up()

    def _connect(self) -> bool:
        host, _, port = self.follower.rpartition(":")
        try:
            link = ReplicaLink(host, int(port), self.namespace, self.queue_name,
                               codec=self._codec, pool=self._pool)
        except (ConnectionError, socket.timeout, OSError):
            self._note_link_down()
            self._stop.wait(random.uniform(0.05, 0.5))
            return False
        try:
            tail = link.subscribe()
        except ReplicaRefused:
            # fencing or a misconfiguration, not an outage: _run stops
            link.hang_up()
            raise
        except (ConnectionError, socket.timeout, OSError):
            link.hang_up()
            self._note_link_down()
            self._stop.wait(random.uniform(0.05, 0.5))
            return False
        local_tail = self.log.next_offset
        if tail > local_tail:
            # the follower holds more than this log: the owner came back
            # with a rolled-back or emptied disk. Shipping from here would
            # rewind the replica over acknowledged records, the only copy
            link.hang_up()
            REPL.bump("owners_fenced_behind")
            REPL.note("owner_fenced_behind_replica", logging.WARNING, queue=self.queue_name,
                      follower=self.follower, follower_tail=tail, local_tail=local_tail)
            raise ReplicaRefused(
                f"follower {self.follower} holds {tail} records of {self.queue_name} but the "
                f"local log ends at {local_tail}: the owner restarted behind its replica; "
                f"refusing to rewind the better copy")
        self._link = link
        self._next_send = min(tail, local_tail)
        self._last_progress = time.monotonic()
        self._floor_shipped = -1
        with self._lock:
            self._link_down_since = None
            if tail - 1 > self._acked:
                self._acked = tail - 1  # the follower kept more than we knew
            was_degraded = self._degraded
            self._degraded = False
        REPL.bump("links_opened")
        if was_degraded:
            REPL.bump("restores")
            REPL.note("replication_restored", queue=self.queue_name, follower=self.follower,
                      resume_at=self._next_send)
        REPL.note("replica_link_open", queue=self.queue_name, follower=self.follower, tail=tail)
        self._mgr.progress()
        return True

    def _note_link_down(self) -> None:
        with self._lock:
            if self._link_down_since is None:
                self._link_down_since = time.monotonic()
            down_s = time.monotonic() - self._link_down_since
        if down_s > self._degrade_after_s:
            self._flip_degraded()

    def _flip_degraded(self) -> None:
        with self._lock:
            if self._degraded:
                return
            self._degraded = True
        REPL.bump("degrades")
        REPL.note("replication_degraded", logging.WARNING, queue=self.queue_name,
                  follower=self.follower)
        self._mgr.progress()  # held producer answers flow again

    def _pump(self) -> None:
        if self._link is None and not self._connect():
            return
        link = self._link
        tail = self.log.next_offset
        floor = getattr(self.queue, "committed_floor", -1)
        wire_floor = floor if floor >= 0 else _REPL_NO_FLOOR
        shipped = nbytes = 0
        while (self._next_send < tail and self._next_send - self.acked_floor() <= self._window
               and not self._stop.is_set()):
            try:
                item = self.log.read(self._next_send)
            except KeyError:
                # retention lapped the link (consumed history only): skip ahead
                earliest = max(self.log.first_retained_offset(), self._next_send + 1)
                REPL.note("replication_gap", logging.WARNING, queue=self.queue_name,
                          skipped_from=self._next_send, resumed_at=earliest)
                with self._lock:
                    # records that cannot be shipped never hold an answer
                    self._acked = max(self._acked, earliest - 1)
                self._next_send = earliest
                continue
            nbytes += link.ship(self._next_send, wire_floor, item)
            self._next_send += 1
            shipped += 1
        if shipped:
            REPL.shipped(shipped, nbytes)
            self._floor_shipped = max(self._floor_shipped, floor)
        # acks: non-blocking while more waits to ship, a bounded slice when
        # the window is full or the link caught up
        caught_up = self._next_send >= self.log.next_offset
        window_full = self._next_send - self.acked_floor() > self._window
        inflight = self._next_send - 1 > self.acked_floor()
        advanced = False
        if inflight:
            off = link.read_ack(0.2 if (caught_up or window_full) else 0.0)
            while off is not None:
                with self._lock:
                    if off > self._acked:
                        self._acked = off
                        advanced = True
                off = link.read_ack(0.0)
        now = time.monotonic()
        if advanced:
            self._last_progress = now
            with self._lock:
                restored, self._degraded = self._degraded, False
            if restored:
                REPL.bump("restores")
                REPL.note("replication_restored", queue=self.queue_name,
                          follower=self.follower, resume_at=self._next_send)
            self._mgr.progress()  # wake the loop: held answers may go
        elif inflight and now - self._last_progress > self._degrade_after_s:
            # connected but silent: the same grace as a refused dial
            self._flip_degraded()
        if caught_up and not inflight:
            self._refresh_floor(link, now)
            # idle: wait for the queue's poke, or the tick
            self._wakeup.clear()
            if self.log.next_offset <= self._next_send:
                self._wakeup.wait(FLOOR_REFRESH_S)

    def _refresh_floor(self, link: ReplicaLink, now: float) -> None:
        """Ship the last record again with the owner's newer committed
        floor: the log is idle (its producer ended) but consumers moved
        the floor, and a promotion should re-expose only what they had
        not been seen to consume."""
        floor = getattr(self.queue, "committed_floor", -1)
        if (floor <= self._floor_shipped or self._next_send <= 0
                or now - self._floor_shipped_at < FLOOR_REFRESH_S):
            return
        offset = self._next_send - 1
        try:
            item = self.log.read(offset)
        except KeyError:
            return  # recycled: nothing left to carry the floor
        link.ship(offset, floor, item)
        self._floor_shipped = floor
        self._floor_shipped_at = now
        REPL.bump("floor_refreshes")


class _ReplicaEntry:
    """One replica log a follower hosts."""

    __slots__ = ("log", "promoted", "floor_seen", "floor_committed")

    def __init__(self, log: SegmentLog):
        self.log = log
        self.promoted = False
        self.floor_seen = -1  # the latest floor the owner sent
        self.floor_committed = -1  # the last floor persisted in the log


class ReplicaSet:
    """The follower's half: passive replica logs by ``(namespace, queue
    name)``, in the same ``durable_dir`` layout as live queues, so a
    promotion closes the replica and the durable factory's boot scan
    mounts the same directory."""

    def __init__(self, durable_dir: str, segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 retain_segments: int = DEFAULT_RETAIN_SEGMENTS, fsync: str = FSYNC_BATCH,
                 fsync_batch_n: int = DEFAULT_FSYNC_BATCH_N):
        self.durable_dir = durable_dir
        self._segment_bytes = segment_bytes
        self._retain_segments = retain_segments
        self._fsync = fsync
        self._fsync_batch_n = fsync_batch_n
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str], _ReplicaEntry] = {}  # guarded-by: _lock

    def subscribe_log(self, namespace: str, queue_name: str) -> Optional[_ReplicaEntry]:
        """The 'H' half: get or create the queue's replica log (None once
        promoted: the fencing refusal)."""
        key = (namespace, queue_name)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                return None if entry.promoted else entry
            log = SegmentLog(os.path.join(self.durable_dir, f"{namespace}__{queue_name}"),
                             segment_bytes=self._segment_bytes,
                             retain_segments=self._retain_segments, fsync=self._fsync,
                             fsync_batch_n=self._fsync_batch_n,
                             name=f"replica:{namespace}/{queue_name}")
            entry = self._entries[key] = _ReplicaEntry(log)
            return entry

    def ingest(self, entry: _ReplicaEntry, offset: int, floor: int, item) -> bool:
        """The 'V' half: reconcile, then append one record at the owner's
        offset. False once promoted (fenced). An overlap truncates to the
        offset (the owner's view wins); a gap forward resets (the owner's
        retention passed this replica, over consumed history only)."""
        with self._lock:
            if entry.promoted:
                return False
        log = entry.log
        tail = log.next_offset
        if offset < tail:
            log.truncate_to(offset)
        elif offset > tail:
            log.reset_to(offset)
            REPL.note("replica_reset", logging.WARNING, log=log.name, to_offset=offset)
        log.append_at(offset, item)
        if floor != _REPL_NO_FLOOR and floor > entry.floor_seen:
            entry.floor_seen = floor
            if floor >= entry.floor_committed + FLOOR_COMMIT_STRIDE:
                log.commit(floor, "")
                entry.floor_committed = floor
        REPL.bump("replica_appends")
        return True

    def promote(self, namespace: str, queue_name: str) -> Optional[Tuple[int, int]]:
        """The 'Y' half: fence the replica against appends, persist the
        exact latest floor, flush, and release the mapping so the durable
        factory can mount the directory live. Returns the retained
        ``(start, end)``, or None when no unpromoted replica is here."""
        t0 = time.monotonic()
        with self._lock:
            entry = self._entries.get((namespace, queue_name))
            if entry is None or entry.promoted:
                return None
            entry.promoted = True
        log = entry.log
        if entry.floor_seen > entry.floor_committed:
            log.commit(entry.floor_seen, "")
            entry.floor_committed = entry.floor_seen
        start, end = log.first_retained_offset(), log.next_offset
        try:
            log.sync()
        except OSError:
            pass  # counted by the log; promote all the same
        log.close()
        REPL.bump("promotes")
        REPL.note("replica_promote", queue=f"{namespace}/{queue_name}", start=start, end=end,
                  floor=entry.floor_committed, ms=(time.monotonic() - t0) * 1000.0)
        return start, end

    def close_all(self) -> None:
        with self._lock:
            entries, self._entries = list(self._entries.values()), {}
        for entry in entries:
            if not entry.promoted:
                entry.log.close()


class ReplicationManager:
    """A server's replication: the follower-facing :class:`ReplicaSet`,
    the owner-facing :class:`ReplicationSender` of each chained queue,
    and the coordinator's snapshot-sync thread. Built by ``queue_server``
    (``--replicate_peers``, ``--advertise``) or a test, and handed to
    ``TcpQueueServer(replication=...)``."""

    def __init__(self, durable_dir: str, peers, advertise: str, codec: Optional[str] = None,
                 window: int = DEFAULT_REPL_WINDOW, pool: Optional[BufferPool] = None,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 retain_segments: int = DEFAULT_RETAIN_SEGMENTS, fsync: str = FSYNC_BATCH,
                 fsync_batch_n: int = DEFAULT_FSYNC_BATCH_N, lease_ttl_s: float = 10.0,
                 degrade_after_s: float = DEFAULT_DEGRADE_AFTER_S):
        self.peers = list(peers)
        self.advertise = advertise
        if codec and codec != "auto":
            # an unknown codec raising in the shipper thread would kill it
            # quietly and hold every producer answer for good: fail here
            get_codec(codec)
        self._codec = codec
        self._window = window
        self._pool = pool
        self._lease_ttl_s = lease_ttl_s
        self._degrade_after_s = degrade_after_s
        self.replicas = ReplicaSet(durable_dir, segment_bytes=segment_bytes,
                                   retain_segments=retain_segments, fsync=fsync,
                                   fsync_batch_n=fsync_batch_n)
        self._lock = threading.Lock()
        self._senders: Dict[int, ReplicationSender] = {}  # id(queue) ->  # guarded-by: _lock
        self._server = None  # set once by attach()
        self._groups_dirty = threading.Event()
        self._stop = threading.Event()
        self._coord_thread: Optional[threading.Thread] = None

    # -- the server's wiring ------------------------------------------------------
    def attach(self, server) -> None:
        self._server = server
        if len(self.peers) > 1 and self.advertise:
            # every group mutation arms a push to the next live peer
            server.groups.on_mutate = self._groups_dirty.set
            self._coord_thread = threading.Thread(target=self._coord_run, daemon=True,
                                                  name="repl-coord-sync")
            self._coord_thread.start()

    def progress(self) -> None:
        """Wake the server's loop: the floor moved (or degraded), and held
        answers may go."""
        srv = self._server
        loop = getattr(srv, "_loop", None) if srv is not None else None
        if loop is not None:
            loop.wake()

    def queue_mounted(self, namespace: str, queue_name: str, queue) -> None:
        """``open_named``'s owner hook: where this server has a next link
        in the partition's chain, start shipping the queue's log there."""
        if getattr(queue, "log", None) is None or not self.advertise or len(self.peers) < 2:
            return  # a memory queue, or nothing to chain to
        base, part = parse_partition(queue_name)
        follower = next_in_chain(self.peers, self.advertise, base, part)
        if follower is None or follower == self.advertise:
            return
        # lock order: ReplicationManager._lock, then ReplicationSender._lock
        with self._lock:
            if self._stop.is_set() or id(queue) in self._senders:
                return
            self._senders[id(queue)] = ReplicationSender(
                self, namespace, queue_name, queue, follower, window=self._window,
                codec=self._codec, pool=self._pool, degrade_after_s=self._degrade_after_s)
        REPL.note("replica_chain", queue=f"{namespace}/{queue_name}", follower=follower)

    def sender_for(self, queue) -> Optional[ReplicationSender]:
        with self._lock:
            return self._senders.get(id(queue))

    # -- the loop's opcodes -------------------------------------------------------
    def replica_open(self, namespace: str, queue_name: str) -> Optional[_ReplicaEntry]:
        srv = self._server
        if srv is not None and srv.has_named_queue(namespace, queue_name):
            return None  # mounted live here: never a passive replica too
        return self.replicas.subscribe_log(namespace, queue_name)

    def replica_append(self, entry: _ReplicaEntry, offset: int, floor: int, item) -> bool:
        return self.replicas.ingest(entry, offset, floor, item)

    def promote(self, namespace: str, queue_name: str) -> Optional[Tuple[int, int]]:
        return self.replicas.promote(namespace, queue_name)

    def ensure_promoted(self, namespace: str, queue_name: str) -> None:
        """An OPEN of a queue this server holds a replica of promotes it
        too, behind the explicit 'Y' (a plain client failing over without
        the cluster layer still gets the replicated backlog)."""
        self.replicas.promote(namespace, queue_name)

    # -- the coordinator's snapshot sync -------------------------------------------
    def _coord_run(self) -> None:
        from psana_ray_tpu_torch.transport.tcp import TcpQueueClient

        while not self._stop.is_set():
            self._groups_dirty.wait(self._lease_ttl_s / 2)
            if self._stop.is_set():
                return
            if not self._groups_dirty.is_set():
                continue
            self._groups_dirty.clear()
            srv = self._server
            if srv is None:
                continue
            snap = srv.groups.snapshot_groups()
            if snap and not self._push_snapshot(TcpQueueClient, snap):
                # no peer took it (or another holds the lease): retry after
                # a beat, never in a hot loop
                self._groups_dirty.set()
                self._stop.wait(0.5)

    def _push_snapshot(self, client_cls, snap: dict) -> bool:
        for peer in self._chain_peers():
            host, _, port = peer.rpartition(":")
            try:
                c = client_cls(host, int(port), timeout_s=5.0, reconnect_tries=1,
                               reconnect_base_s=0.1)
            except TransportClosed:
                continue
            try:
                lease = c.cluster_rpc({"op": "lease", "holder": self.advertise,
                                       "ttl": self._lease_ttl_s})
                if not lease.get("ok"):
                    # another holder's lease is live: this is probably the
                    # deposed side of a coordinator failover, so back off
                    REPL.bump("lease_denied")
                    REPL.note("lease_denied", logging.WARNING, peer=peer,
                              holder=lease.get("holder"))
                    return False
                resp = c.cluster_rpc({"op": "sync", "holder": self.advertise, "groups": snap})
                if resp.get("ok"):
                    REPL.bump("coord_syncs")
                    return True
            except (TransportClosed, RuntimeError):
                continue
            finally:
                try:
                    c.disconnect()
                except Exception:  # noqa: BLE001 (closing anyway)
                    pass
        return False

    def _chain_peers(self):
        """The peers after this server in the configured order, wrapping:
        the coordinator's replication chain."""
        if self.advertise in self.peers:
            i = self.peers.index(self.advertise)
            return self.peers[i + 1:] + self.peers[:i]
        return [p for p in self.peers if p != self.advertise]

    # -- lifecycle ----------------------------------------------------------------
    def shutdown(self) -> None:
        self._stop.set()
        self._groups_dirty.set()
        with self._lock:
            senders, self._senders = list(self._senders.values()), {}
        for s in senders:
            s.stop()
        t = self._coord_thread
        if t is not None:
            t.join(timeout=3.0)
        self.replicas.close_all()
