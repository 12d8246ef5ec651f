"""Cross-host transport: the TCP queue server and its client.

The port's copy of ``psana_ray_tpu/transport/tcp.py``, byte for byte the
JAX package's wire protocol: a JAX client talks to this server and this
client to a JAX server. Producers on ingest nodes connect and put,
consumers on the card's host connect and get; one server hosts any
number of named queues.

Wire protocol (little-endian):

    request:  op:u8 + fields
              'P' put + len:u32 + payload
              'G' get
              'S' size
              'C' close the bound queue
              'B' get-batch + max_items:u32
              'D' get-batch, the server waiting up to the timeout (capped
                  at ``_SERVER_WAIT_CAP_S``) for the first item
                  + max_items:u32 + timeout_ms:u32
              'Q' put-batch + count:u32 + count x (len:u32 + payload)
              'U' put, the server waiting for space + timeout_ms:u32
                  + len:u32 + payload
              'W' windowed put + seq:u64 + len:u32 + payload: the client
                  does not wait for the answer before the next request
              'M' stream subscribe + credits:u32: server-push delivery
                  from here on ('M' again resizes the credit window)
              'K' stream ack + seq:u64, cumulative
              'O' open + ns_len:u16 + ns + name_len:u16 + name + maxsize:u32
              'T' stats of the bound queue
              'A' anchor + wall:f64 + mono:f64 (a clock exchange)
              'N' group RPC + len:u32 + JSON: the link probe's
                  ``{"op": "ping", ...}``, or a consumer-group request to
                  the server's :class:`~psana_ray_tpu_torch.cluster.
                  coordinator.GroupRegistry` (its JSON answer)
              'R' replay-open + from:u64 + group_len:u16 + group: durable
                  queues only. This connection's reads (G/B/D) switch to a
                  non-destructive cursor over the bound queue's retained
                  log for the named consumer group; ``from`` is an offset,
                  u64 max (the earliest retained) or u64 max - 1 (resume
                  after the group's committed offset). What the cursor
                  delivers is committed for the group at the connection's
                  implicit acks. '0' on a memory queue
              'J' commit-offset + offset:u64 + group_len:u16 + group: the
                  replay cursor's position (u64 max: all it delivered), or
                  the group's committed offset on the bound durable queue;
                  '0' when there is nothing to commit against
              'Z' capability exchange + len:u16 + comma-separated entries:
                  codec names the client decodes, in preference order,
                  and ``key=value`` fields (``tenant=<name>[:<weight>]``).
                  The server answers the first codec it also has (or
                  "none"), and both sides compress frame payloads on
                  this connection from the next message on (payload tag
                  'C', :mod:`psana_ray_tpu_torch.transport.codec`).
                  Entries the server does not know are skipped
              'H' replica-subscribe + ns_len:u16 + ns + name_len:u16 + name:
                  switch this connection to replica mode for the named
                  queue's replica log on a replicating durable server
                  (:mod:`psana_ray_tpu_torch.cluster.replication`). The
                  answer carries the replica's tail:u64, where the owner's
                  shipper resumes; from here the connection carries only
                  'V' and 'F'. '0' when this server cannot host the
                  replica (no replication, the queue is mounted live
                  here, or the replica was promoted: the fencing answer a
                  zombie owner sees)
              'V' replica-append + offset:u64 + floor:u64 + len:u32 +
                  payload: one record at the owner's offset (a divergence
                  truncates to the offset, a gap resets); ``floor`` is the
                  owner's committed offset (u64 max: none), so a promoted
                  replica re-exposes only what lies above it. Windowed
                  like 'W': the answer is '1' + offset:u64, cumulative,
                  and it is the replicated ack floor that holds the
                  producers' answers on the owner. 'E' when refused
                  (promoted, or a disk fault); a protocol error outside a
                  replica connection
              'Y' promote + ns_len:u16 + ns + name_len:u16 + name: fence
                  the named replica log against further appends, flush it
                  and release it, so the next OPEN mounts it as the live
                  durable queue. The answer is '1' + the retained range
                  start:u64 + end:u64, or '0' when no replica is here
                  (the partition then starts empty)
              'F' bye: no answer; acks the last delivery
    response: status:u8 ('1' ok | '0' full/empty | 'X' closed | 'E' error)
              + [G ok] len:u32 + payload   + [S] size:u32
              + [B/D ok] count:u32 + count x (len:u32 + payload)
              + [Q ok] accepted:u32   + [W ok] seq:u64
              + [T/N ok] len:u32 + JSON   + [A ok] wall:f64 + mono:f64
              + [Z ok] len:u16 + the chosen codec's name
              + [R ok] start:u64 + the log's next offset:u64
    stream push (server -> client, after 'M'):
              '1' + seq:u64 + len:u32 + payload a frame; 'X' when the
              bound queue closes

Delivery is at least once, never silently lost. The server holds each
G/B/D delivery in flight until the same connection's next opcode (the
client reads a response in full before it sends its next request) or
BYE, and puts it back at the queue's head if the connection dies first.
A streamed connection holds its pushed frames until a cumulative 'K'
covers them and requeues exactly the unacked tail on death; its
upstream carries only 'K', 'M' and 'F'. Windowed puts keep up to W
sequence-numbered puts in flight; the server answers each once it is
enqueued (a full queue delays the answer: that is the backpressure), and
on reconnect the client resends the whole unacked tail in order before
anything else. On a replicating server a put's answer waits until the
follower has logged the record (the replicated ack floor); a windowed
put's wait does not stop the connection's next puts.

Payloads are the codec's tagged payloads. Sends go out with
``socket.sendmsg`` scatter-gather straight from a record's panel memory;
receives land with ``recv_into`` in pooled leases
(:class:`~psana_ray_tpu_torch.utils.bufpool.BufferPool`) and decode as
views of them, the lease riding the record until the batcher's one copy
(``FrameBatcher.push_view``).

The server is one readiness loop (:mod:`psana_ray_tpu_torch.transport.
evloop`), or one of a fleet of them sharing the port
(:mod:`psana_ray_tpu_torch.transport.workers`); this module holds the protocol's constants and framing helpers
and the client. :class:`TcpQueueClient` serializes every exchange under
one lock (one outstanding request a connection); a reconnect holds that
lock through its backoff, so give each thread its own client where that
matters.
"""

from __future__ import annotations

import json
import os
import random
import socket
import struct
import threading
import time
from collections import deque
from typing import Any, List, Optional

from psana_ray_tpu_torch.transport.codec import (
    CODEC_NONE,
    CODEC_STATS,
    available_codecs,
    decode_payload as _decode,
    encode_for_wire as _wire_encode,
    get_codec,
    payload_nbytes as _parts_nbytes,
)
from psana_ray_tpu_torch.obs.flight import FLIGHT
from psana_ray_tpu_torch.obs.profiling.stagetag import TAG_ENQUEUE, set_stage, swap_stage
from psana_ray_tpu_torch.obs.registry import ensure_registered
from psana_ray_tpu_torch.obs.stages import HOP_ENQ, STAGE_QUEUE_DWELL
from psana_ray_tpu_torch.obs.tracing import SPAN_RELAY, TRACER
from psana_ray_tpu_torch.records import mark_hop
from psana_ray_tpu_torch.transport.registry import TransportClosed
from psana_ray_tpu_torch.transport.ring import EMPTY, RingBuffer
from psana_ray_tpu_torch.utils.bufpool import BufferPool
from psana_ray_tpu_torch.utils.metrics import probe_queue_stats

_OP_PUT = b"P"
_OP_GET = b"G"
_OP_SIZE = b"S"
_OP_CLOSE = b"C"
_OP_GET_BATCH = b"B"
_OP_GET_BATCH_WAIT = b"D"
_OP_PUT_BATCH = b"Q"
_OP_PUT_WAIT = b"U"
_OP_PUT_SEQ = b"W"
_OP_STREAM = b"M"
_OP_STREAM_ACK = b"K"
_OP_OPEN = b"O"
_OP_STATS = b"T"
_OP_ANCHOR = b"A"
_OP_CLUSTER = b"N"
_OP_REPLAY = b"R"
_OP_COMMIT = b"J"
_OP_CODEC = b"Z"
_OP_REPL_OPEN = b"H"
_OP_REPL_APPEND = b"V"
_OP_PROMOTE = b"Y"
_OP_BYE = b"F"
_ST_OK = b"1"
_ST_NO = b"0"
_ST_CLOSED = b"X"
_ST_ERR = b"E"
# the 'V' floor field when the owner has no committed floor to send
_REPL_NO_FLOOR = (1 << 64) - 1

# the longest one bounded-wait request ('D'/'U') may wait server-side:
# an idle consumer costs about one round trip an interval, and drain,
# shutdown and dead-peer detection stay timely
_SERVER_WAIT_CAP_S = 2.0
# default credit window (frames in flight) of stream subscriptions and of
# the windowed-put pipeline: it bounds client memory as a prefetch depth does
DEFAULT_STREAM_WINDOW = 32
# sendmsg: iovecs a call (Linux IOV_MAX is 1024)
_SENDMSG_IOV = 64
# consecutive parts up to this size are joined before sending (a run of
# control fields costs nothing to copy); frame payloads pass zero-copy
_COALESCE_MAX = 4096
# the largest tagged payload (u32 on the wire allows 4 GiB): a corrupt or
# hostile length must not size a pool lease. The largest real frame
# (jungfrau4M f64) is about 67 MB
_MAX_PAYLOAD = 256 * 1024 * 1024


class StreamTelemetry:
    """The streaming transport's counters: subscriptions, frames pushed,
    acks, redeliveries, the frames pushed and not yet acked (and their
    peak), the sum of open credit windows, and the client's windowed-put
    depth, its peak and resends. One process-wide instance,
    :data:`STREAM`."""

    def __init__(self):
        self._lock = threading.Lock()
        self.streams_opened = 0  # guarded-by: _lock
        self.frames_pushed = 0  # guarded-by: _lock
        self.acks = 0  # guarded-by: _lock
        self.redelivered = 0  # guarded-by: _lock
        self.inflight = 0  # guarded-by: _lock
        self.inflight_peak = 0  # guarded-by: _lock
        self.credit_window = 0  # guarded-by: _lock
        self.put_window_depth = 0  # guarded-by: _lock
        self.put_window_peak = 0  # guarded-by: _lock
        self.put_resent = 0  # guarded-by: _lock

    def opened(self, window: int):
        ensure_registered("stream", self)
        with self._lock:
            self.streams_opened += 1
            self.credit_window += window

    def closed(self, window: int):
        with self._lock:
            self.credit_window -= window

    def resized(self, old: int, new: int):
        with self._lock:
            self.credit_window += new - old

    def pushed(self, n: int):
        with self._lock:
            self.frames_pushed += n
            self.inflight += n
            self.inflight_peak = max(self.inflight_peak, self.inflight)

    def pruned(self, n: int):
        with self._lock:
            self.inflight -= n

    def acked_msg(self):
        with self._lock:
            self.acks += 1

    def redelivered_n(self, n: int):
        with self._lock:
            self.redelivered += n

    def put_depth(self, depth: int):
        ensure_registered("stream", self)
        with self._lock:
            self.put_window_depth = depth
            self.put_window_peak = max(self.put_window_peak, depth)

    def resent(self, n: int):
        with self._lock:
            self.put_resent += n

    def stats(self) -> dict:
        with self._lock:
            return {
                "streams_opened": self.streams_opened,
                "frames_pushed_total": self.frames_pushed,
                "acks_total": self.acks,
                "redelivered_total": self.redelivered,
                "inflight": self.inflight,
                "inflight_peak": self.inflight_peak,
                "credit_window": self.credit_window,
                "put_window_depth": self.put_window_depth,
                "put_window_peak": self.put_window_peak,
                "put_resent_total": self.put_resent,
            }


STREAM = StreamTelemetry()


def _queue_stats_payload(queue) -> dict:
    """JSON-safe stats of a backing queue; a closed queue reports
    ``closed`` instead of failing the RPC."""
    try:
        return probe_queue_stats(queue)
    except TransportClosed:
        return {"closed": True}
    except Exception as e:  # noqa: BLE001 (stats must not kill serving)
        return {"error": repr(e)}


def _recv_into(sock: socket.socket, mv: memoryview) -> None:
    """Fill ``mv`` exactly from ``sock`` with ``recv_into``: the payload
    lands in the caller's (pooled) memory with no bytes object between.
    Every read of this module goes through here."""
    got = 0
    n = len(mv)
    while got < n:
        k = sock.recv_into(mv[got:])
        if not k:
            raise ConnectionError("peer closed")
        got += k


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Exactly ``n`` bytes of a control field (a few bytes); payloads use
    :func:`_recv_into` on a pooled buffer."""
    buf = bytearray(n)
    _recv_into(sock, memoryview(buf))
    return bytes(buf)


def _gather_parts(parts) -> List[memoryview]:
    """A part list ready to send: empty parts dropped, runs of small
    control parts joined up to ``_COALESCE_MAX``, frame payloads passed as
    zero-copy memoryviews. The blocking sender and the event loop's write
    queue share it, so the bytes on the wire are the same."""
    bufs: List[memoryview] = []
    small: List[memoryview] = []

    def _flush_small():
        if not small:
            return
        bufs.append(small[0] if len(small) == 1 else memoryview(b"".join(small)))
        small.clear()

    for p in parts:
        m = p if isinstance(p, memoryview) else memoryview(p)
        if not m.nbytes:
            continue
        if m.nbytes <= _COALESCE_MAX:
            small.append(m)
            if sum(s.nbytes for s in small) >= _COALESCE_MAX:
                _flush_small()
        else:
            _flush_small()
            bufs.append(m)
    _flush_small()
    return bufs


def _sendmsg_all(sock: socket.socket, parts) -> None:
    """Send every part without joining the large ones: a frame goes from
    the record's panel memory to the kernel in one hop. A partial send
    resumes mid-part."""
    bufs = _gather_parts(parts)
    i = 0
    while i < len(bufs):
        sent = sock.sendmsg(bufs[i: i + _SENDMSG_IOV])
        if sent <= 0:
            raise ConnectionError("peer closed during sendmsg")
        while sent > 0:
            m = bufs[i]
            if sent >= m.nbytes:
                sent -= m.nbytes
                i += 1
            else:
                bufs[i] = m[sent:]
                sent = 0


def _recv_payload(sock: socket.socket, n: int, pool: BufferPool):
    """Receive an ``n``-byte tagged payload into one pooled lease and
    decode it: a frame comes back as a view of the lease, the lease
    attached; any other payload releases it at decode. An oversized
    length is a ConnectionError (the stream is out of step: the
    connection must die)."""
    if n > _MAX_PAYLOAD:
        raise ConnectionError(f"payload length {n} exceeds wire maximum {_MAX_PAYLOAD}")
    lease = pool.lease(n)
    try:
        _recv_into(sock, lease.mv)
        return _decode(lease.mv, lease=lease)
    except BaseException:
        lease.release()  # idempotent
        raise


def _discard_until_eof(sock: socket.socket, deadline: float) -> None:
    """Half-close ``sock`` and read off whatever still arrives until the
    peer closes or ``deadline`` (``time.monotonic()``) passes."""
    sock.shutdown(socket.SHUT_WR)
    buf = bytearray(1 << 20)
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return
        sock.settimeout(remaining)
        if not sock.recv_into(buf):
            return


def _refuse_conn(conn: socket.socket, port: int, active: int, limit: int) -> None:
    """Admission control past ``max_conns``: accept, answer ``'E'`` and
    close, so the refused client's next status read fails at once."""
    FLIGHT.record("conn_refused", port=port, active=active, max_conns=limit)
    try:
        conn.send(_ST_ERR)
    except OSError:
        pass
    try:
        conn.close()
    except OSError:
        pass


# -- the relay's spans (sampled frames only, while TRACER.enabled) ----------
def _stamp_relay_arrival(item) -> None:
    """Stamp a sampled frame's arrival at the relay: the start of its
    ``queue_dwell`` span. The stamp rides the record's process-local hops
    through the in-memory queue to the read that delivers it."""
    trace = getattr(item, "trace", None)
    if trace is not None and trace.sampled:
        mark_hop(item, HOP_ENQ)


def _emit_relay_spans(items, t_send0: float) -> None:
    """After a response went out: each sampled frame's ``queue_dwell`` span
    (arrival -> response start) and ``relay`` span (serialization + send)."""
    t_done = time.monotonic()
    for item in items:
        trace = getattr(item, "trace", None)
        if trace is None or not trace.sampled:
            continue
        hops = getattr(item, "hops", None)
        t_arrived = hops.get(HOP_ENQ) if hops else None
        if t_arrived is not None:
            TRACER.span(trace.trace_id, STAGE_QUEUE_DWELL, t_arrived, t_send0)
        TRACER.span(trace.trace_id, SPAN_RELAY, t_send0, t_done)


class TcpQueueServer:
    """Serve queues over TCP: a default queue, and any number of named
    queues that clients OPEN by ``(namespace, queue_name)``; connections
    that never OPEN use the default. Named queues live until the server
    stops. Start it with :meth:`serve_background`.

    ``queue_factory(namespace, name, maxsize)`` makes an OPENed queue
    (default: a :class:`RingBuffer`; the CLI's ``--shm`` gives shm rings
    that local processes attach to directly). ``max_conns`` (0: no limit)
    refuses connections past the limit with ``'E'``. ``worker_ctx`` (a
    :class:`~psana_ray_tpu_torch.transport.workers.WorkerContext`) makes
    the server one worker of a ``--workers`` fleet: it binds the shared
    port with ``SO_REUSEPORT`` and serves only the queues it owns,
    shipping other connections to their owners."""

    def __init__(self, queue=None, host: str = "0.0.0.0", port: int = 0, maxsize: int = 100,
                 queue_factory=None, pool: Optional[BufferPool] = None, max_conns: int = 0,
                 worker_ctx=None, group_store_path: Optional[str] = None, replication=None):
        # imported here: the cluster's client half imports this module
        from psana_ray_tpu_torch.cluster.coordinator import GroupRegistry

        self.queue = queue if queue is not None else RingBuffer(maxsize)
        self.worker_ctx = worker_ctx
        # the consumer groups of the 'N' RPC; with a store path (the CLI's
        # --durable_dir) they survive a restart
        self.groups = GroupRegistry(store_path=group_store_path)
        self._maxsize = maxsize
        # every received payload lands in a recycled lease of this pool and
        # decodes zero-copy: a PUT's buffer is the memory a later GET sends from
        self._pool = pool if pool is not None else BufferPool.default()
        self._queue_factory = queue_factory or (
            lambda ns, name, size: RingBuffer(size, name=f"{ns}__{name}"))
        self._queues = {}  # (namespace, name) -> queue  # guarded-by: _queues_lock
        self._queues_lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if worker_ctx is not None:
            # every worker binds its own listener on the one port; the
            # kernel spreads the connections across them
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._draining = False
        self._conns: List[socket.socket] = []  # guarded-by: _conns_lock
        self._conns_lock = threading.Lock()
        self.max_conns = int(max_conns)
        self._loop = None
        self._thread: Optional[threading.Thread] = None
        # a cluster.replication.ReplicationManager makes this server both an
        # owner that ships its durable queues' logs to their followers and a
        # follower that hosts replica logs ('H', 'V', 'Y')
        self.replication = replication
        if replication is not None:
            replication.attach(self)

    def open_named(self, namespace: str, queue_name: str, maxsize: Optional[int] = None):
        """Get or create the named queue (the OPEN opcode; also callable
        in-process, for a host-local consumer of a queue that remote
        producers feed)."""
        key = (namespace, queue_name)
        with self._queues_lock:
            q = self._queues.get(key)
            if q is None:
                if self.replication is not None:
                    # a queue this server holds a replica of lands here on a
                    # failover: fence and release the replica first, so the
                    # factory's boot scan mounts the replicated backlog
                    self.replication.ensure_promoted(namespace, queue_name)
                q = self._queue_factory(namespace, queue_name, maxsize or self._maxsize)
                self._queues[key] = q
                if self.replication is not None:
                    # where this server has a next link in the chain, ship there
                    self.replication.queue_mounted(namespace, queue_name, q)
                FLIGHT.record("queue_opened", namespace=namespace, name=queue_name)
            return q

    def has_named_queue(self, namespace: str, queue_name: str) -> bool:
        """Is the queue mounted live here? (A server never hosts a replica
        of a queue it serves.)"""
        with self._queues_lock:
            return (namespace, queue_name) in self._queues

    def named_queues(self) -> List[tuple]:
        with self._queues_lock:
            return sorted(self._queues)

    def queues_by_name(self) -> dict:
        """``{label: queue}`` of every queue, labelled ``default`` and
        ``<namespace>/<queue_name>``: the stall detector's population."""
        with self._queues_lock:
            queues = {f"{ns}/{nm}": q for (ns, nm), q in self._queues.items()}
        queues["default"] = self.queue
        return queues

    def stats_all(self) -> dict:
        """``{label: stats}`` of every queue (:meth:`queues_by_name`): the
        ``queue_server`` metrics source."""
        return {label: _queue_stats_payload(q) for label, q in self.queues_by_name().items()}

    def all_queues(self) -> List[Any]:
        with self._queues_lock:
            return [self.queue, *self._queues.values()]

    def begin_drain(self):
        """Refuse puts on every queue (producers see the dead-queue signal
        and exit) while gets go on: consumers drain what is queued. The
        backing queues are told too, so producers that bypass TCP (a
        ``--shm`` ring) are refused as well."""
        FLIGHT.record("begin_drain", port=self.port)
        self._draining = True
        for q in self.all_queues():
            drain = getattr(q, "begin_drain", None)
            if drain is not None:
                try:
                    drain()
                except Exception:
                    pass

    @property
    def draining(self) -> bool:
        return self._draining

    def depth(self) -> int:
        """Items still queued across every queue."""
        total = 0
        for q in self.all_queues():
            try:
                total += q.size()
            except Exception:
                pass
        return total

    def close_all(self):
        """Close every queue: each blocked client sees a dead transport."""
        FLIGHT.record("close_all", port=self.port)
        for q in self.all_queues():
            try:
                q.close()
            except Exception:
                pass

    def serve_background(self) -> "TcpQueueServer":
        from psana_ray_tpu_torch.transport.evloop import EventLoop

        self._loop = EventLoop(self)
        self._thread = threading.Thread(target=self._loop.run, daemon=True, name="tcp-evloop")
        self._thread.start()
        return self

    def _requeue(self, queue, items):
        """Put back items popped but never delivered (their connection
        died): at the queue's head, ahead of any EOS markers already
        queued, through the shared recovery path."""
        from psana_ray_tpu_torch.transport.recovery import return_to_queue

        if items:
            FLIGHT.record("requeue_in_flight", count=len(items))
        return_to_queue(queue, items, what="in-flight frame")

    def shutdown(self):
        self._stop.set()
        if self._loop is not None:
            self._loop.wake()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)  # before the close: a restart may rebind the port at once
        if self.replication is not None:
            # the senders, the coordinator sync and the replica logs stop
            # once the loop is down (no more 'V' appends)
            self.replication.shutdown()
        try:
            self._sock.close()
        except OSError:
            pass
        # an established connection keeps the port busy: close them all
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass


class TcpQueueClient:
    """A client with the transport contract (put/get/size/get_wait/...).

    A raw socket failure (a blip, a server restart under a supervisor)
    reconnects with jittered exponential backoff and retries the
    interrupted exchange once on the fresh connection; a named binding is
    replayed first, so the client lands on the same queue. A server that
    stays dead through every attempt raises :class:`TransportClosed` from
    every method, the signal a closed queue sends, so dead-transport
    handling works alike for both. An explicit refusal (a closed or
    draining queue) is an answer, not an outage.

    ``codec`` opts the connection into wire compression: ``"auto"``
    decides at each (re)connect from a short link-rate probe (on below
    ``AUTO_CODEC_THRESHOLD_MB_S``, where the bandwidth saved outweighs the
    codec's time), a name or comma list advertises exactly those, None or
    ``"none"`` skips the exchange (wire bytes as a client without codecs).
    The server picks; a server that refuses 'Z' leaves the connection
    uncompressed. ``tenant`` and ``tenant_weight`` (1-64) name the
    connection's fair-share tenant on the same exchange."""

    # control-plane probes fail fast on a dead server instead of riding
    # the whole reconnect envelope under the lock
    PROBE_DEADLINE_S = 5.0
    # link rate below which compression wins: the numpy codec moves about
    # 200 MB/s at about 3x on detector frames, a break-even near 133 MB/s.
    # PSANA_AUTO_CODEC_MB_S overrides it
    AUTO_CODEC_THRESHOLD_MB_S = 125.0
    # padded ping size of one bandwidth probe; three run and the median decides
    AUTO_CODEC_PROBE_BYTES = 640 * 1024

    def __init__(self, host: str, port: int, timeout_s: float = 30.0,
                 namespace: Optional[str] = None, queue_name: Optional[str] = None,
                 maxsize: int = 0, reconnect_tries: int = 4, reconnect_base_s: float = 0.5,
                 pool: Optional[BufferPool] = None, put_window: int = DEFAULT_STREAM_WINDOW,
                 codec: Optional[str] = None, tenant: Optional[str] = None,
                 tenant_weight: int = 1):
        self.host, self.port = host, port
        self._timeout_s = timeout_s
        self._pool = pool if pool is not None else BufferPool.default()
        self._reconnect_tries = reconnect_tries
        self._reconnect_base_s = reconnect_base_s
        self._binding: Optional[tuple] = None  # (ns, name, maxsize) to replay
        self._replay_group: Optional[str] = None  # a replay cursor to open again
        self._lock = threading.Lock()
        # set before the dial: _reconnect (reachable from here) reads them.
        # A streamed connection carries only pushes and acks; other
        # request/response ops go over a side channel opened on demand
        self._stream: Optional["TcpStreamReader"] = None
        self._side: Optional["TcpQueueClient"] = None
        self._put_seq = 0  # guarded-by: _lock
        self._put_unacked: deque = deque()  # (seq, item)  # guarded-by: _lock
        self._put_window = max(1, int(put_window))
        self._codec_arg = codec
        self._codec_names: Optional[List[str]] = None
        self._codec_auto = codec == "auto"
        if codec and codec != CODEC_NONE and not self._codec_auto:
            names = [n.strip() for n in codec.split(",") if n.strip()]
            for n in names:
                get_codec(n)  # unknown names fail here
            self._codec_names = names
        self._codec = None  # guarded-by: _lock
        self._codec_refused = False  # guarded-by: _lock
        self._hello_fields: List[str] = []
        if tenant is not None:
            if not tenant or any(c in tenant for c in ",=:\n"):
                raise ValueError(f"tenant name {tenant!r} may not be empty or contain ',' '=' "
                                 f"':' or newlines (it rides a comma-separated capability list)")
            w = int(tenant_weight)
            if not 1 <= w <= 64:
                raise ValueError(f"tenant_weight must be in [1, 64], got {tenant_weight}")
            self._hello_fields.append(f"tenant={tenant}:{w}")
        self.tenant = tenant
        # the first dial backs off as a mid-stream drop does: a consumer
        # starting while its server restarts waits it out
        try:
            self._sock = socket.create_connection((host, port), timeout=timeout_s)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except (ConnectionError, socket.timeout, OSError) as e:
            self._reconnect(e)  # raises TransportClosed when it gives up
        if namespace is not None or queue_name is not None:
            self.open(namespace or "default", queue_name or "default", maxsize)
        if self._codec_auto:
            with self._lock:
                try:
                    self._decide_auto_codec_raw()
                except (ConnectionError, socket.timeout, OSError) as e:
                    self._reconnect(e)  # probes and negotiates again itself
        if self._codec_names or self._hello_fields:
            self._negotiate()

    def open(self, namespace: str, queue_name: str, maxsize: int = 0):
        """Bind this connection to the server's queue ``(namespace,
        queue_name)``, creating it (``maxsize`` only on create; 0: the
        server's default)."""
        with self._lock:
            self._binding = (namespace, queue_name, maxsize)
            try:
                self._open_raw(namespace, queue_name, maxsize)
            except (ConnectionError, socket.timeout, OSError) as e:
                self._reconnect(e)  # replays the binding itself

    def _open_raw(self, namespace: str, queue_name: str, maxsize: int):
        # guarded-by-caller: _lock
        ns, nm = namespace.encode(), queue_name.encode()
        self._sock.sendall(_OP_OPEN + struct.pack("<H", len(ns)) + ns
                           + struct.pack("<H", len(nm)) + nm + struct.pack("<I", maxsize))
        self._status()

    # -- the capability exchange ('Z') --------------------------------------
    def _negotiate(self):
        with self._lock:
            try:
                self._negotiate_raw()
            except (ConnectionError, socket.timeout, OSError) as e:
                self._reconnect(e)  # negotiates again itself

    def _negotiate_raw(self):
        """One 'Z' exchange. A server without the opcode answers 'E' (and
        drops the connection): the client stays uncompressed, and remembers
        it so that reconnects do not ask again."""
        # guarded-by-caller: _lock
        if self._codec_refused:
            return
        advert = [*(self._codec_names or [CODEC_NONE]), *self._hello_fields]
        names = ",".join(advert).encode()
        self._sock.sendall(_OP_CODEC + struct.pack("<H", len(names)) + names)
        try:
            self._status()
        except RuntimeError:  # a peer without 'Z': raw from here on
            self._codec = None
            self._codec_refused = True
            FLIGHT.record("codec_refused", host=self.host, port=self.port)
            return
        (n,) = struct.unpack("<H", _recv_exact(self._sock, 2))
        try:
            chosen = _recv_exact(self._sock, n).decode()
            self._codec = get_codec(chosen)
        except ValueError:  # a name never advertised: as a refusal
            self._codec = None
            self._codec_refused = True
            FLIGHT.record("codec_refused", host=self.host, port=self.port)
            return
        CODEC_STATS.negotiated(chosen)
        FLIGHT.record("codec_negotiated", host=self.host, port=self.port, codec=chosen)

    def _probe_link_raw(self) -> tuple:
        """``(link MB/s, RTT s)`` of the current socket: the RTT from two
        'A' exchanges (the least), the rate from three padded 'N' pings
        (the median; the server reads the whole request before it answers,
        so a ping takes about RTT + bytes / rate)."""
        # guarded-by-caller: _lock
        sock = self._sock
        rtt = float("inf")
        for _ in range(2):
            t0 = time.monotonic()
            sock.sendall(_OP_ANCHOR + struct.pack("<dd", time.time(), t0))
            self._status()
            _recv_exact(sock, 16)
            rtt = min(rtt, time.monotonic() - t0)
        # the server's O(1) ping path matches this exact prefix
        body = b'{"op": "ping", "pad": "' + b"x" * self.AUTO_CODEC_PROBE_BYTES + b'"}'
        samples = []
        for _ in range(3):
            t0 = time.monotonic()
            sock.sendall(_OP_CLUSTER + struct.pack("<I", len(body)) + body)
            self._status()
            (n,) = struct.unpack("<I", _recv_exact(sock, 4))
            _recv_exact(sock, n)
            samples.append(len(body) / max(time.monotonic() - t0 - rtt, 1e-6) / 1e6)
        return sorted(samples)[1], rtt

    def _decide_auto_codec_raw(self) -> None:
        """``codec="auto"``: probe the link and set what the next 'Z'
        advertises. A probe the peer refuses decides for compression."""
        # guarded-by-caller: _lock
        mb_s = rtt = None
        try:
            mb_s, rtt = self._probe_link_raw()
        except (ConnectionError, socket.timeout, OSError):
            raise  # a dead socket: the caller reconnects
        except Exception:  # noqa: BLE001 (a refused probe decides, never fails)
            pass
        try:
            threshold = float(os.environ.get("PSANA_AUTO_CODEC_MB_S",
                                             self.AUTO_CODEC_THRESHOLD_MB_S))
        except ValueError:
            threshold = self.AUTO_CODEC_THRESHOLD_MB_S
        slow = mb_s is None or mb_s < threshold
        self._codec_names = (available_codecs() or None) if slow else None
        if self._codec_names is None:
            self._codec = None  # no 'Z' follows: a stale codec must not stay
        FLIGHT.record("codec_auto_decision", host=self.host, port=self.port,
                      link_mb_s=round(mb_s, 1) if mb_s is not None else None,
                      rtt_ms=round(rtt * 1e3, 2) if rtt is not None else None,
                      threshold_mb_s=threshold, codec_on=bool(self._codec_names))

    def _encode_for_wire(self, item):
        # guarded-by-caller: _lock (the codec is the connection's, and a
        # reconnect may change it)
        return _wire_encode(item, self._codec, self._pool)

    @property
    def codec_name(self) -> Optional[str]:
        """The negotiated codec's name, or None when raw."""
        with self._lock:
            codec = self._codec
        return codec.name if codec is not None else None

    # -- live dials (the autotune knobs) -------------------------------------
    @property
    def put_window(self) -> int:
        with self._lock:
            return self._put_window

    def set_put_window(self, n: int) -> None:
        """Resize the windowed-put depth live. Client state only: a shrink
        waits for more acks before the next send, a grow lets more puts
        fly."""
        with self._lock:
            self._put_window = max(1, int(n))

    @property
    def stream_window(self) -> int:
        with self._lock:
            st = self._stream
            return st.window if st is not None else 0

    def set_stream_window(self, n: int) -> bool:
        """Resize the stream's credit window live: one 'M' with the new
        count on the streamed connection, which the server applies in
        place (no answer, as for the subscribe); the next cumulative 'K'
        returns credit against the new window. Needs an open subscription;
        a replay connection (pull mode) refuses."""
        n = max(1, min(int(n), 4096))
        with self._lock:
            if self._replay_group is not None:
                # the server drops a replay connection that sends 'M'
                raise RuntimeError("set_stream_window on a replay connection: replay is "
                                   "pull-mode")
            if self._stream is None:
                raise RuntimeError("set_stream_window needs an open stream subscription "
                                   "(call stream_open first)")
            st = self._stream
            if n == st.window:
                return True
            st.window = n  # before the send: a reconnect resubscribes with it
            try:
                self._sock.sendall(_OP_STREAM + struct.pack("<I", n))
            except (ConnectionError, socket.timeout, OSError) as e:
                self._reconnect(e)  # resubscribes at the new window
            return True

    def renegotiate_codec(self, names=None) -> bool:
        """Turn wire compression on or off live with a fresh 'Z' exchange:
        ``names`` is the codec list to advertise, None or empty goes back
        to raw. Refused on a streamed connection (a 'Z' between pushes
        would break their framing; the codec there is decided at each
        connect) and a no-op once a peer without 'Z' was latched. Windowed
        puts still unacked drain first, within ``PROBE_DEADLINE_S``: their
        acks come before the 'Z' answer on the wire. True when a codec is
        negotiated after it."""
        if self._stream is not None:
            raise RuntimeError("renegotiate_codec on a streamed connection: the codec there "
                               "is decided at (re)connect, not between pushes")
        if names:
            names = [str(n) for n in names]
            for n in names:
                get_codec(n)  # unknown names fail here
        deadline = time.monotonic() + self.PROBE_DEADLINE_S
        with self._lock:
            if self._codec_refused:
                return False
            self._codec_names = names or None
            self._retrying(self._negotiate_raw, deadline)
            return self._codec is not None

    # -- reconnect ----------------------------------------------------------
    def _reconnect(self, cause: BaseException, deadline: Optional[float] = None):
        """Dial again with jittered exponential backoff; replay the
        binding, the codec decision and exchange, the windowed-put tail
        and the stream subscription. Raises TransportClosed when every
        attempt fails, or when ``deadline`` (``time.monotonic()``) passes,
        so callers with a timeout keep it."""
        # guarded-by-caller: _lock
        # reconnect storms lead most wedged-run postmortems
        FLIGHT.record("reconnect", host=self.host, port=self.port, cause=repr(cause))
        sock = getattr(self, "_sock", None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        delay = self._reconnect_base_s
        last: BaseException = cause
        for attempt in range(self._reconnect_tries):
            now = time.monotonic()
            if deadline is not None and now >= deadline:
                break
            if attempt:  # between dials, never after the last
                # full jitter: clients that saw the same server die must
                # not dial again in lockstep
                sleep_s = random.uniform(0.0, delay)
                if deadline is not None:
                    sleep_s = min(sleep_s, max(0.0, deadline - now))
                time.sleep(sleep_s)
                delay = min(delay * 2, 5.0)
                if deadline is not None and time.monotonic() >= deadline:
                    break
            dial_timeout = self._timeout_s
            if deadline is not None:
                dial_timeout = max(0.05, min(dial_timeout, deadline - time.monotonic()))
            try:
                self._sock = socket.create_connection((self.host, self.port),
                                                      timeout=dial_timeout)
                self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                if self._binding is not None:
                    self._open_raw(*self._binding)
                if self._codec_auto and not self._codec_refused and deadline is None:
                    # "auto" decides per connection; the probe runs under the
                    # patient timeout (a clipped deadline keeps the last decision)
                    self._sock.settimeout(self._timeout_s)
                    self._decide_auto_codec_raw()
                if self._codec_names or self._hello_fields:
                    # before any payload: the resend below must know the codec
                    self._negotiate_raw()
                if self._replay_group is not None:
                    self._resume_replay_raw()
                # the whole unacked tail, in order, before anything else:
                # duplicates possible, holes never
                if self._put_unacked:
                    self._resend_put_window()
                # resubscribe with the same window; what the dead connection
                # had in the air was requeued server-side and redelivers here
                if self._stream is not None:
                    self._sock.sendall(_OP_STREAM + struct.pack("<I", self._stream.window))
                    self._stream.reset_after_reconnect()
                    FLIGHT.record("stream_resubscribe", host=self.host, port=self.port)
                # the connection runs under the configured timeout, not the
                # clipped dial timeout (a later 'D' wait would read as death)
                self._sock.settimeout(self._timeout_s)
                return
            except (ConnectionError, socket.timeout, OSError) as e:
                last = e
        deadline_hit = deadline is not None and time.monotonic() >= deadline
        raise TransportClosed(
            f"connection to queue server {self.host}:{self.port} died and reconnect attempts "
            f"failed (tries={self._reconnect_tries}{', caller deadline hit' if deadline_hit else ''}"
            f"): {last}") from last

    def _retrying(self, do, deadline: Optional[float] = None):
        """One request/response exchange; on a raw socket failure,
        reconnect (bounded by ``deadline``) and retry once. Windowed-put
        acks still owed are read first: they precede this exchange's
        answer on the wire."""
        # guarded-by-caller: _lock
        if self._put_unacked and not self._drain_put_acks(0, deadline):
            raise TransportClosed(f"windowed puts to {self.host}:{self.port} still "
                                  f"unacknowledged at the caller's deadline")
        try:
            return do()
        except (ConnectionError, socket.timeout, OSError) as e:
            self._reconnect(e, deadline)
            try:
                return do()
            except (ConnectionError, socket.timeout, OSError) as e2:
                raise TransportClosed(
                    f"connection to queue server {self.host}:{self.port} died again right "
                    f"after a successful reconnect: {e2}") from e2

    # -- windowed pipelined put ('W') ---------------------------------------
    def _resend_put_window(self):
        # guarded-by-caller: _lock
        for seq, item in list(self._put_unacked):
            parts, clease = self._encode_for_wire(item)
            try:
                head = _OP_PUT_SEQ + struct.pack("<QI", seq, _parts_nbytes(parts))
                _sendmsg_all(self._sock, [head, *parts])
            finally:
                if clease is not None:
                    clease.release()
        if self._put_unacked:
            STREAM.resent(len(self._put_unacked))
            FLIGHT.record("put_window_resend", count=len(self._put_unacked), host=self.host,
                          port=self.port)

    def _drain_put_acks(self, max_unacked: int, deadline: Optional[float]) -> bool:
        """Read windowed-put acks until at most ``max_unacked`` remain in
        flight; False when ``deadline`` passes first (the tail stays queued
        for a resend). An overdue ack is backpressure, not death (the
        server holds acks while its queue is full), so a quiet wire keeps
        waiting in slices; only a broken connection reconnects, with the
        full backoff, and resends. 'X' raises TransportClosed."""
        # guarded-by-caller: _lock
        while len(self._put_unacked) > max_unacked:
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return False
            slice_s = self._timeout_s if remaining is None else min(self._timeout_s, remaining)
            try:
                # the slice bounds the status byte only; the seq follows at
                # wire speed (a timeout inside an ack would lose the framing)
                try:
                    self._sock.settimeout(slice_s)
                    try:
                        st = self._status()
                    except socket.timeout:
                        continue
                finally:
                    try:
                        self._sock.settimeout(self._timeout_s)
                    except OSError:
                        pass
                if st != _ST_OK:
                    raise RuntimeError(f"protocol error in windowed-put ack: {st!r}")
                (seq,) = struct.unpack("<Q", _recv_exact(self._sock, 8))
            except (ConnectionError, socket.timeout, OSError) as e:
                self._reconnect(e)  # resends the tail itself
                continue
            while self._put_unacked and self._put_unacked[0][0] <= seq:
                self._put_unacked.popleft()
            STREAM.put_depth(len(self._put_unacked))
        return True

    def put_pipelined(self, item: Any, deadline: Optional[float] = None) -> bool:
        """Send without waiting for the answer, keeping up to
        ``put_window`` puts in flight. False when the window is still full
        at ``deadline`` (the item was not sent: retry it); TransportClosed
        when the transport is dead (``deadline`` bounds the wait for room,
        not a reconnect). Call :meth:`flush_puts` before relying on the
        puts (an EOS, a shutdown)."""
        if self._stream is not None:
            return self._side_channel().put_pipelined(item, deadline)
        with self._lock:
            if not self._drain_put_acks(self._put_window - 1, deadline):
                return False
            parts, clease = self._encode_for_wire(item)
            try:
                n = _parts_nbytes(parts)
                if n > _MAX_PAYLOAD:
                    raise ValueError(f"payload of {n} bytes exceeds wire maximum {_MAX_PAYLOAD}")
                self._put_seq += 1
                seq = self._put_seq
                self._put_unacked.append((seq, item))
                STREAM.put_depth(len(self._put_unacked))
                head = _OP_PUT_SEQ + struct.pack("<QI", seq, n)
                try:
                    _sendmsg_all(self._sock, [head, *parts])
                except (ConnectionError, socket.timeout, OSError) as e:
                    self._reconnect(e)  # resends the tail, this item included
            finally:
                if clease is not None:
                    clease.release()
            return True

    def flush_puts(self, deadline: Optional[float] = None) -> bool:
        """Block until every windowed put is acked (False at ``deadline``)."""
        if self._stream is not None:
            side = self._side
            return True if side is None else side.flush_puts(deadline)
        with self._lock:
            return self._drain_put_acks(0, deadline)

    def unacked_puts(self) -> List[Any]:
        """The windowed puts this server has not acked yet, oldest first."""
        with self._lock:
            return [item for (_seq, item) in self._put_unacked]

    # -- streaming ('M'/'K') -------------------------------------------------
    def stream_open(self, window: int = DEFAULT_STREAM_WINDOW) -> "TcpStreamReader":
        """Subscribe this connection to server-push delivery with
        ``window`` credits (the first subscription wins). From here on the
        reads drain the stream and other requests go over a side channel."""
        with self._lock:
            if self._stream is not None:
                return self._stream
            if self._replay_group is not None:
                # the server drops a replay connection that subscribes
                raise RuntimeError("stream_open on a replay connection: replay is pull-mode; "
                                   "use a client of its own")
            window = max(1, int(window))

            def _do():
                self._sock.sendall(_OP_STREAM + struct.pack("<I", window))

            self._retrying(_do)
            self._stream = TcpStreamReader(self, window)
            return self._stream

    def take_pushed(self, settle_s: float) -> List[Any]:
        """Before a clean close of a streamed connection: the frames the
        server has pushed and the caller has not been given yet, up to the
        credit window, waiting at most ``settle_s`` for each one still in
        transit. The caller owns them: :meth:`disconnect` acks them, so the
        server does not put them back. [] when not streamed or the
        connection is gone."""
        st = self._stream
        if st is None:
            return []
        with self._lock:
            return st.take_pushed(settle_s)

    def get_batch_stream(self, max_items: int, timeout: Optional[float] = None) -> List[Any]:
        """What the server has pushed, up to ``max_items``, waiting at
        most ``timeout`` for the first (subscribing with the default window
        at first use). The batcher prefers this to ``get_batch``: no
        request round trip, no empty-queue poll."""
        return self.stream_open().get_batch_stream(max_items, timeout)

    # -- durable queues: replay ('R') and commits ('J') ---------------------
    def replay_open(self, from_offset=None, group: str = "replay") -> dict:
        """Switch this connection's reads to a non-destructive replay
        cursor over the bound durable queue's retained log for ``group``.
        ``from_offset``: None or ``"resume"`` (after the group's committed
        offset), ``"begin"`` (the earliest retained record) or an offset.
        Live consumers are undisturbed. What the cursor delivers is
        committed for the group at this connection's implicit acks, so a
        crashed reader resumes and loses nothing; a reconnect resumes by
        itself. Returns ``{"start", "end"}``; RuntimeError when the queue
        has no log (or the connection is streamed)."""
        from psana_ray_tpu_torch.storage.log import REPLAY_BEGIN, REPLAY_RESUME

        if self._stream is not None:
            raise RuntimeError("replay_open on a streamed connection: replay is pull-mode; "
                               "use a client of its own")
        if from_offset is None or from_offset == "resume":
            pos = REPLAY_RESUME
        elif from_offset == "begin":
            pos = REPLAY_BEGIN
        else:
            pos = int(from_offset)

        def _do():
            return self._replay_raw(pos, group)

        with self._lock:
            start, end = self._retrying(_do)
        # the consumer's own breadcrumb, wherever the server runs
        FLIGHT.record("replay_open", host=self.host, port=self.port, group=group, start=start,
                      end=end)
        return {"start": start, "end": end}

    def _replay_raw(self, pos: int, group: str) -> tuple:
        # guarded-by-caller: _lock
        g = group.encode()
        self._sock.sendall(_OP_REPLAY + struct.pack("<QH", pos, len(g)) + g)
        if self._status() != _ST_OK:
            raise RuntimeError(f"replay refused: queue {self._binding or 'default'} on "
                               f"{self.host}:{self.port} has no segment log (start the server "
                               f"with --durable_dir)")
        start_end = struct.unpack("<QQ", _recv_exact(self._sock, 16))
        self._replay_group = group  # the connection's mode: a reconnect resumes at the commit
        return start_end

    def _resume_replay_raw(self) -> None:
        """After a reconnect: the cursor again, at the group's committed
        offset. A server that came back without a log for the queue fails
        the transport: reading on would pop live consumers' frames."""
        # guarded-by-caller: _lock
        from psana_ray_tpu_torch.storage.log import REPLAY_RESUME

        try:
            self._replay_raw(REPLAY_RESUME, self._replay_group)
        except RuntimeError as e:
            FLIGHT.record("replay_resubscribe_refused", host=self.host, port=self.port)
            try:
                self._sock.close()
            except OSError:
                pass
            raise TransportClosed(f"replay re-subscription refused by {self.host}:{self.port}: "
                                  f"{e}") from e

    def commit_offset(self, offset=None, group: str = "",
                      deadline: Optional[float] = None) -> bool:
        """Persist a committed offset for ``group`` on the bound durable
        queue ('J'); ``offset=None`` commits all this connection's replay
        cursor delivered. False when the queue has no log."""
        from psana_ray_tpu_torch.storage.log import COMMIT_DELIVERED

        if self._stream is not None:
            return self._side_channel().commit_offset(offset, group, deadline)
        pos = COMMIT_DELIVERED if offset is None else int(offset)
        g = group.encode()

        def _do():
            self._sock.sendall(_OP_COMMIT + struct.pack("<QH", pos, len(g)) + g)
            return self._status() == _ST_OK

        with self._lock:
            return self._retrying(_do, deadline)

    # -- the cluster's control plane ('N', 'Y') ------------------------------
    def cluster_rpc(self, payload: dict, deadline: Optional[float] = None) -> dict:
        """One consumer-group RPC ('N'): ``payload`` to the server's
        :class:`~psana_ray_tpu_torch.cluster.coordinator.GroupRegistry`,
        its JSON answer back. Control plane: fails fast
        (``PROBE_DEADLINE_S``) so that a dead coordinator shows at once."""
        if self._stream is not None:  # would break the push framing
            return self._side_channel().cluster_rpc(payload, deadline)
        body = json.dumps(payload).encode()

        def _do():
            self._sock.sendall(_OP_CLUSTER + struct.pack("<I", len(body)) + body)
            self._status()
            (n,) = struct.unpack("<I", _recv_exact(self._sock, 4))
            return json.loads(_recv_exact(self._sock, n).decode())

        if deadline is None:
            deadline = time.monotonic() + self.PROBE_DEADLINE_S
        with self._lock:
            return self._retrying(_do, deadline)

    def promote(self, namespace: str, queue_name: str,
                deadline: Optional[float] = None) -> Optional[dict]:
        """Ask the server to promote its replica log of ``(namespace,
        queue_name)`` into the live queue ('Y'), as the cluster client does
        on a partition's new owner before it opens the partition. Returns
        the retained range ``{"start", "end"}``, or None when the server
        holds no replica (it does not replicate, or another promotion took
        it), and then the partition starts empty there. Control plane:
        fails fast."""
        if self._stream is not None:
            return self._side_channel().promote(namespace, queue_name, deadline)
        ns, nm = namespace.encode(), queue_name.encode()

        def _do():
            self._sock.sendall(_OP_PROMOTE + struct.pack("<H", len(ns)) + ns
                               + struct.pack("<H", len(nm)) + nm)
            if self._status() != _ST_OK:
                return None
            start, end = struct.unpack("<QQ", _recv_exact(self._sock, 16))
            return {"start": start, "end": end}

        if deadline is None:
            deadline = time.monotonic() + self.PROBE_DEADLINE_S
        with self._lock:
            return self._retrying(_do, deadline)

    def _side_channel(self) -> "TcpQueueClient":
        """A second, plain connection for the request/response ops a
        streamed client still needs (EOS put-backs, probes): any on the
        streamed socket would break the push framing."""
        side = self._side
        if side is None:
            ns, nm, ms = self._binding or (None, None, 0)
            codec_arg = self._codec_arg
            with self._lock:
                names = self._codec_names
                put_window = self._put_window
            if self._codec_auto:  # the side channel shares the link: no new probe
                codec_arg = ",".join(names) if names else None
            side = TcpQueueClient(self.host, self.port, timeout_s=self._timeout_s, namespace=ns,
                                  queue_name=nm, maxsize=ms, reconnect_tries=self._reconnect_tries,
                                  reconnect_base_s=self._reconnect_base_s, pool=self._pool,
                                  put_window=put_window, codec=codec_arg)
            self._side = side
        return side

    # -- the contract -------------------------------------------------------
    def put(self, item: Any, deadline: Optional[float] = None) -> bool:
        if self._stream is not None:
            return self._side_channel().put(item, deadline)

        # encoded inside the retried exchange: a reconnect may change the codec
        def _do():
            parts, clease = self._encode_for_wire(item)
            try:
                n = _parts_nbytes(parts)
                if n > _MAX_PAYLOAD:
                    raise ValueError(f"payload of {n} bytes exceeds wire maximum {_MAX_PAYLOAD}")
                _sendmsg_all(self._sock, [_OP_PUT + struct.pack("<I", n), *parts])
                return self._status() == _ST_OK
            finally:
                if clease is not None:
                    clease.release()

        with self._lock:
            return self._retrying(_do, deadline)

    def get(self, deadline: Optional[float] = None) -> Any:
        if self._stream is not None:  # what was pushed already
            return self._stream.get_wait_stream(0.0)

        def _do():
            self._sock.sendall(_OP_GET)
            if self._status() == _ST_NO:
                return EMPTY
            (n,) = struct.unpack("<I", _recv_exact(self._sock, 4))
            return _recv_payload(self._sock, n, self._pool)

        with self._lock:
            return self._retrying(_do, deadline)

    def _probe(self, do, deadline: Optional[float]):
        if deadline is None:
            deadline = time.monotonic() + self.PROBE_DEADLINE_S
        with self._lock:
            return self._retrying(do, deadline)

    def size(self, deadline: Optional[float] = None) -> int:
        if self._stream is not None:
            return self._side_channel().size(deadline)

        def _do():
            self._sock.sendall(_OP_SIZE)
            self._status()
            return struct.unpack("<I", _recv_exact(self._sock, 4))[0]

        return self._probe(_do, deadline)

    def anchor(self, deadline: Optional[float] = None) -> dict:
        """The clock exchange ('A'): the server's ``(wall, mono)`` pair
        between this process's own samples, and the round trip."""
        if self._stream is not None:
            return self._side_channel().anchor(deadline)

        def _do():
            t0_wall, t0_mono = time.time(), time.monotonic()
            self._sock.sendall(_OP_ANCHOR + struct.pack("<dd", t0_wall, t0_mono))
            self._status()
            peer_wall, peer_mono = struct.unpack("<dd", _recv_exact(self._sock, 16))
            t1_wall, t1_mono = time.time(), time.monotonic()
            return {"send_wall": t0_wall, "send_mono": t0_mono, "recv_wall": t1_wall,
                    "recv_mono": t1_mono, "peer_wall": peer_wall, "peer_mono": peer_mono,
                    "rtt_s": t1_mono - t0_mono, "peer": f"{self.host}:{self.port}"}

        return self._probe(_do, deadline)

    def stats(self, deadline: Optional[float] = None) -> dict:
        """The bound queue's stats ('T'): depth, high-water mark, put and
        get counters, the ages of the last put and get."""
        if self._stream is not None:
            return self._side_channel().stats(deadline)

        def _do():
            self._sock.sendall(_OP_STATS)
            self._status()
            (n,) = struct.unpack("<I", _recv_exact(self._sock, 4))
            return json.loads(_recv_exact(self._sock, n).decode())

        return self._probe(_do, deadline)

    def close_remote(self):
        """Close the remote queue."""
        if self._stream is not None:
            return self._side_channel().close_remote()

        def _do():
            self._sock.sendall(_OP_CLOSE)
            self._status()

        with self._lock:
            return self._retrying(_do)

    # -- blocking helpers (RingBuffer's surface). The sleeps run between
    # server-side bounded waits, so the caller's timeout bounds the total
    def get_wait(self, timeout: Optional[float] = None, poll_s: float = 0.001) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        if self._stream is not None:  # the push is the wait
            while True:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return EMPTY
                item = self._stream.get_wait_stream(remaining)
                if item is not EMPTY:
                    return item
                if deadline is not None and time.monotonic() >= deadline:
                    return EMPTY
        while True:
            out = self._get_batch_once(1, deadline, self._server_wait(deadline))
            if out:
                return out[0]
            if deadline is not None and time.monotonic() >= deadline:
                return EMPTY
            time.sleep(poll_s)

    @staticmethod
    def _server_wait(deadline: Optional[float]) -> float:
        """How long the server should wait this round trip: the cap,
        clipped to the caller's remaining time."""
        if deadline is None:
            return _SERVER_WAIT_CAP_S
        return min(_SERVER_WAIT_CAP_S, max(0.0, deadline - time.monotonic()))

    def put_wait(self, item: Any, timeout: Optional[float] = None, poll_s: float = 0.001) -> bool:
        if self._stream is not None:
            return self._side_channel().put_wait(item, timeout, poll_s)
        deadline = None if timeout is None else time.monotonic() + timeout
        # the profiler bills this thread to "enqueue" until the put resolves
        prev_tag = swap_stage(TAG_ENQUEUE)
        # the encode is kept across full-queue retries (the codec once a
        # frame) until a reconnect changes the codec
        cached = None  # (codec, parts, staging lease)
        try:
            while True:
                wait_ms = int(self._server_wait(deadline) * 1000)

                def _do():
                    nonlocal cached
                    codec = self._codec
                    if cached is None or cached[0] is not codec:
                        if cached is not None and cached[2] is not None:
                            cached[2].release()
                        cached = None
                        parts, clease = self._encode_for_wire(item)
                        cached = (codec, parts, clease)
                    parts = cached[1]
                    n = _parts_nbytes(parts)
                    if n > _MAX_PAYLOAD:
                        raise ValueError(f"payload of {n} bytes exceeds wire maximum "
                                         f"{_MAX_PAYLOAD}")
                    _sendmsg_all(self._sock, [_OP_PUT_WAIT + struct.pack("<II", wait_ms, n),
                                              *parts])
                    return self._status() == _ST_OK

                with self._lock:
                    if self._retrying(_do, deadline):
                        return True
                if deadline is not None and time.monotonic() >= deadline:
                    return False
                time.sleep(poll_s)
        finally:
            set_stage(prev_tag)
            if cached is not None and cached[2] is not None:
                cached[2].release()

    def get_batch(self, max_items: int, timeout: Optional[float] = None,
                  poll_s: float = 0.001) -> List[Any]:
        """Up to ``max_items`` in one round trip; on an empty queue the
        server waits for the first item ('D', bounded by ``timeout`` and
        the server's cap)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        if self._stream is not None:
            while True:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return []
                out = self._stream.get_batch_stream(max_items, remaining)
                if out:
                    return out
                if deadline is not None and time.monotonic() >= deadline:
                    return []
        while True:
            out = self._get_batch_once(max_items, deadline, self._server_wait(deadline))
            if out:
                return out
            if deadline is not None and time.monotonic() >= deadline:
                return []
            time.sleep(poll_s)

    def _get_batch_once(self, max_items: int, deadline: Optional[float] = None,
                        server_wait_s: float = 0.0) -> List[Any]:
        def _do():
            if server_wait_s > 0:
                self._sock.sendall(_OP_GET_BATCH_WAIT
                                   + struct.pack("<II", max_items, int(server_wait_s * 1000)))
            else:
                self._sock.sendall(_OP_GET_BATCH + struct.pack("<I", max_items))
            self._status()
            (count,) = struct.unpack("<I", _recv_exact(self._sock, 4))
            out = []
            for _ in range(count):
                (n,) = struct.unpack("<I", _recv_exact(self._sock, 4))
                out.append(_recv_payload(self._sock, n, self._pool))
            return out

        with self._lock:
            return self._retrying(_do, deadline)

    def put_batch(self, items: List[Any]) -> int:
        """Send the items in one round trip ('Q'); returns how many the
        server accepted (a full queue truncates: retry the rest)."""
        if self._stream is not None:
            return self._side_channel().put_batch(items)

        def _do():
            parts = [_OP_PUT_BATCH + struct.pack("<I", len(items))]
            leases = []
            try:
                for item in items:
                    item_parts, clease = self._encode_for_wire(item)
                    if clease is not None:
                        leases.append(clease)
                    n = _parts_nbytes(item_parts)
                    if n > _MAX_PAYLOAD:
                        raise ValueError(f"payload of {n} bytes exceeds wire maximum "
                                         f"{_MAX_PAYLOAD}")
                    parts.append(struct.pack("<I", n))
                    parts.extend(item_parts)
                _sendmsg_all(self._sock, parts)
                self._status()
                return struct.unpack("<I", _recv_exact(self._sock, 4))[0]
            finally:
                for clease in leases:
                    clease.release()

        with self._lock:
            return self._retrying(_do)

    def disconnect(self):
        """Close cleanly: owed windowed-put acks are read (bounded), a
        streamed connection acks what it consumed, and BYE acks the last
        delivery, so the server redelivers nothing this client had. A
        streamed connection then reads off the pushes still in flight
        until the server closes (bounded): closing with unread bytes would
        reset the connection, and a server that meets the reset on a push
        before it reads the ack requeues frames this client consumed."""
        side, self._side = self._side, None
        if side is not None:
            side.disconnect()
        sock = getattr(self, "_sock", None)  # absent if the first dial failed
        if sock is None:
            return
        try:
            with self._lock:
                deadline = time.monotonic() + self.PROBE_DEADLINE_S
                if self._put_unacked:
                    self._drain_put_acks(0, deadline)
                # the last ack and BYE in one write: the server reads both
                # in one pass, so it pushes nothing between them
                ack = b"" if self._stream is None else self._stream.consumed_ack()
                sock.sendall(ack + _OP_BYE)
                if self._stream is not None:
                    _discard_until_eof(sock, deadline)
        except (OSError, TransportClosed):
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _status(self) -> bytes:
        # guarded-by-caller: _lock
        st = _recv_exact(self._sock, 1)
        if st == _ST_CLOSED:
            raise TransportClosed(f"remote queue at {self.host}:{self.port} is closed")
        if st == _ST_ERR:
            raise RuntimeError("protocol error")
        return st


class TcpStreamReader:
    """The client half of stream mode: reads the frames the server
    pushes on a subscribed :class:`TcpQueueClient` connection and returns
    credit with a cumulative ack as it consumes (a frame is acked when the
    caller comes back for the next, the point where request/response mode
    takes its implicit ack). Every read is bounded by the caller's timeout
    or the client's socket timeout; a reconnect mid-stream runs the
    client's full backoff. Its methods run under the client's lock."""

    def __init__(self, client: TcpQueueClient, window: int):
        self._c = client
        self.window = window
        self.delivered_seq = 0  # the last seq returned to the caller
        self.acked_seq = 0  # the last seq acked to the server
        self._dead: Optional[str] = None  # 'X' seen: the stream is over

    def reset_after_reconnect(self):
        """A fresh subscription numbers from 1 again; the dead
        connection's unacked frames were requeued and redeliver."""
        self.delivered_seq = 0
        self.acked_seq = 0

    def ack_consumed(self):
        """Cumulative credit for everything returned so far."""
        ack = self.consumed_ack()
        if ack:
            self._c._sock.sendall(ack)

    def consumed_ack(self) -> bytes:
        """The cumulative ack owed for what was returned (b"" if none),
        counted as sent: the caller writes it."""
        if self.delivered_seq <= self.acked_seq:
            return b""
        self.acked_seq = self.delivered_seq
        STREAM.acked_msg()
        return _OP_STREAM_ACK + struct.pack("<Q", self.delivered_seq)

    def take_pushed(self, settle_s: float) -> List[Any]:
        """See :meth:`TcpQueueClient.take_pushed`. The server pushes at
        most ``window`` frames past the last ack, so reading stops there,
        at the first ``settle_s`` that brings nothing, or at a dead or
        closed connection."""
        # guarded-by-caller: the client's _lock
        out: List[Any] = []
        while self.delivered_seq < self.acked_seq + self.window:
            try:
                item = self._read_push(settle_s)
            except (TransportClosed, ConnectionError, socket.timeout, OSError):
                break
            if item is EMPTY:
                break
            out.append(item)
        return out

    def _read_push(self, first_timeout: Optional[float]):
        """One pushed frame, or EMPTY when none starts within
        ``first_timeout`` (0: only what is buffered). The timeout bounds
        the status byte alone; the rest of a push is read under the
        client's timeout."""
        if self._dead is not None:
            raise TransportClosed(self._dead)
        sock = self._c._sock
        try:
            sock.settimeout(first_timeout)  # 0: a non-blocking probe
            try:
                st = _recv_exact(sock, 1)
            except (BlockingIOError, socket.timeout):
                return EMPTY
        finally:
            try:
                sock.settimeout(self._c._timeout_s)
            except OSError:
                pass
        if st == _ST_CLOSED:
            self._dead = f"remote queue at {self._c.host}:{self._c.port} is closed"
            raise TransportClosed(self._dead)
        if st != _ST_OK:
            raise RuntimeError(f"protocol error on streamed connection: {st!r}")
        seq, n = struct.unpack("<QI", _recv_exact(sock, 12))
        item = _recv_payload(sock, n, self._c._pool)
        self.delivered_seq = seq
        return item

    def get_batch_stream(self, max_items: int, timeout: Optional[float] = None) -> List[Any]:
        """Ack what was returned before, wait up to ``timeout`` for the
        first push, then take what is buffered without waiting, up to
        ``max_items``. [] on a timeout and after a reconnect (the
        redeliveries come on the next call)."""
        c = self._c
        with c._lock:
            try:
                self.ack_consumed()
                first = self._read_push(timeout)
            except TransportClosed:
                raise
            except (ConnectionError, socket.timeout, OSError) as e:
                c._reconnect(e)  # resubscribes; unacked frames redeliver
                return []
            if first is EMPTY:
                return []
            out = [first]
            while len(out) < int(max_items):
                try:
                    nxt = self._read_push(0.0)
                except TransportClosed:
                    break  # deliver what is held; the next call raises
                except (ConnectionError, socket.timeout, OSError):
                    break  # the next call reconnects
                if nxt is EMPTY:
                    break
                out.append(nxt)
            return out

    def get_wait_stream(self, timeout: Optional[float] = None) -> Any:
        batch = self.get_batch_stream(1, timeout)
        return batch[0] if batch else EMPTY
