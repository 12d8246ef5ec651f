# lint: hot-path
"""The TCP queue server's event loop: one thread, any number of
connections.

The port's copy of ``psana_ray_tpu/transport/evloop.py``.

- One thread runs a ``selectors.DefaultSelector`` (epoll on Linux):
  non-blocking accepts, incremental reads, non-blocking scatter-gather
  writes that resume on ``EPOLLOUT`` after a partial send. The thread
  count does not grow with the connections; memory is a small struct a
  connection.
- Each connection is an :class:`_EvConn` state machine over the wire
  protocol of :mod:`psana_ray_tpu_torch.transport.tcp` (whose constants
  and part-gathering helpers it imports, so the format cannot fork).
  Control fields land in a reused scratch buffer, payloads straight into
  pooled leases.
- A wait is state, not a parked thread: a 'D' get-batch on an empty
  queue, a 'U' put on a full one, a 'W' windowed put under backpressure
  and a stream whose credits ran out park the connection as a waiter on
  its queue. The pump serves waiters whenever queue state may have
  changed (an enqueue or dequeue of the loop's own, a ``RingBuffer``
  listener poking the waker, or, for queues without listeners such as
  shm rings fed by other processes, a poll tick), and bounded waits
  expire off a timer heap.
- Streams sharing a queue are served in rotation under a weighted
  deficit round-robin across tenants (:class:`_Wdrr`).
- Delivery: popped items ride ``conn.in_flight`` until the next opcode
  (the implicit ack) or BYE and go back to the queue's head when the
  connection dies first; stream pushes ride the connection's unacked
  window, whose exact tail redelivers on death. At least once:
  duplicates possible, silent loss never.

- Durable queues (:class:`~psana_ray_tpu_torch.storage.DurableRingBuffer`):
  the implicit ack, a stream's cumulative ack and a clean BYE advance
  the committed floor (``ack_delivered``). 'R' opens a replay cursor on
  the connection, whose reads then serve the retained log; 'J' commits
  it. A spilled record goes out as a :class:`~psana_ray_tpu_torch.
  transport.splice.FileSpan` by ``sendfile`` on a plain connection and
  is read into the interpreter on a compressed one.
- A worker of a ``--workers`` fleet (``server.worker_ctx``) serves the
  queues it owns and ships every other connection, at its first queue
  op, to the owner over the adoption socket (:mod:`psana_ray_tpu_torch.
  transport.workers`).

While a connection has a deferred op, its reads pause (one outstanding
request a connection: what it pipelined waits in the kernel's buffer);
a 1-byte ``MSG_PEEK`` probe, repeated every ``PROBE_INTERVAL_S``, keeps
detecting a peer that died. Reads take exact sizes and never run past
the current op, which is what lets a connection migrate with its fd.

Nothing reachable from :meth:`EventLoop.run` may block: no sleeps, no
blocking socket calls, no unbounded waits. The one put-back that can
block (a queue without ``put_front``) runs on a short-lived helper
thread.

- 'N' carries the link probe's ping, answered in O(1), and the
  consumer-group RPCs, which the server's :class:`~psana_ray_tpu_torch.
  cluster.coordinator.GroupRegistry` answers. On a fleet, a group RPC on
  a connection bound to no queue (the cluster client's coordinator link)
  goes to the default queue's worker like any default-queue op, so one
  registry serves every member.

- Replication (``server.replication``, a :class:`~psana_ray_tpu_torch.
  cluster.replication.ReplicationManager`): 'H' switches a connection to
  replica mode (only 'V' appends and 'F' from then on), 'V' logs a record
  at the owner's offset, 'Y' promotes a replica log. A put on a chained
  durable queue goes through ``put_offset``, and its answer waits in the
  connection's ``held`` queue until the follower has logged that offset
  (the replicated ack floor), released by the pump when the sender's acks
  wake the loop. A held 'W' answer does not stop the connection's next
  'W' puts (the window stays full); any other op waits until the held
  answers have gone, so answers keep their order. A server without a
  manager answers 'H' and 'Y' with '0'.

- 'N' ``{"op": "metrics"}`` answers the process's federation payload
  (:func:`~psana_ray_tpu_torch.obs.registry.federation_payload`): its
  metrics registry's snapshot, host-tagged.

While the process's tracer is on, a sampled frame gets its arrival stamp
at the put and its ``queue_dwell`` and ``relay`` spans when it goes out;
control-plane events (stream opens and redeliveries, codec and tenant
hellos, migrations and adoptions) are flight-recorder events.

:data:`EVLOOP` (the ``evloop`` registry source) times each pass, its
dispatch against its wait in ``select`` (``busy_frac``), and counts the
connections. The loop's thread carries the continuous profiler's
``dispatch`` tag for its whole life.
"""

from __future__ import annotations

import heapq
import json
import os
import selectors
import socket
import struct
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from psana_ray_tpu_torch.cluster.replication import REPL
from psana_ray_tpu_torch.obs.flight import FLIGHT
from psana_ray_tpu_torch.obs.profiling.stagetag import TAG_DISPATCH, clear_thread, set_stage
from psana_ray_tpu_torch.obs.registry import ensure_registered, federation_payload
from psana_ray_tpu_torch.obs.tracing import TRACER
from psana_ray_tpu_torch.storage.durable import SpilledRecord
from psana_ray_tpu_torch.storage.log import COMMIT_DELIVERED
from psana_ray_tpu_torch.transport.codec import (
    CODEC_NONE,
    CODEC_STATS,
    decode_payload as _decode,
    encode_for_wire as _wire_encode,
    negotiate_codec,
    payload_nbytes as _parts_nbytes,
)
from psana_ray_tpu_torch.transport.registry import TransportClosed
from psana_ray_tpu_torch.transport.ring import EMPTY
from psana_ray_tpu_torch.transport.splice import SPLICE, FileSpan, fallback_errno
from psana_ray_tpu_torch.transport.splice import sendfile_capable as _sendfile_capable
from psana_ray_tpu_torch.transport.tcp import (
    _MAX_PAYLOAD,
    _OP_ANCHOR,
    _OP_BYE,
    _OP_CLOSE,
    _OP_CLUSTER,
    _OP_CODEC,
    _OP_COMMIT,
    _OP_GET,
    _OP_GET_BATCH,
    _OP_GET_BATCH_WAIT,
    _OP_OPEN,
    _OP_PROMOTE,
    _OP_PUT,
    _OP_PUT_BATCH,
    _OP_PUT_SEQ,
    _OP_PUT_WAIT,
    _OP_REPL_APPEND,
    _OP_REPL_OPEN,
    _OP_REPLAY,
    _OP_SIZE,
    _OP_STATS,
    _OP_STREAM,
    _OP_STREAM_ACK,
    _SENDMSG_IOV,
    _SERVER_WAIT_CAP_S,
    _ST_CLOSED,
    _ST_ERR,
    _ST_NO,
    _ST_OK,
    STREAM,
    _gather_parts,
    _emit_relay_spans,
    _queue_stats_payload,
    _refuse_conn,
    _stamp_relay_arrival,
)
from psana_ray_tpu_torch.transport.workers import (
    DEFAULT_QUEUE_WORKER,
    MIGRATE_GRACE_S,
    MIGRATE_RETRY_S,
)

# pump cadence for queues without a change listener (shm rings fed by
# other processes); a listened queue pokes the waker on every change, so
# its tick is only a safety net
POLL_TICK_S = 0.02
LISTENED_TICK_S = 0.25
IDLE_TICK_S = 0.5
# re-probe cadence of parked connections whose reads are paused
PROBE_INTERVAL_S = 0.5
# frames popped a stream visit: one wide window must not take a whole pass
_STREAM_POP_MAX = 64
# weighted deficit round-robin: frames of deficit a tenant earns a round
# per unit of weight
_WDRR_QUANTUM = 8
_TENANT_DEFAULT = "default"
_TENANT_WEIGHT_MAX = 64


class _Wdrr:
    """A queue's weighted-deficit state for the stream pump: streams
    sharing a queue are served in rotation, each pop capped by its
    tenant's deficit. A round hands out ``_WDRR_QUANTUM`` frames for each
    waiting stream connection, split across tenants by weight, so a
    tenant's share follows its weight however many sockets it opens.
    Loop-thread state: no lock."""

    __slots__ = ("deficit",)

    def __init__(self):
        self.deficit: Dict[str, float] = {}

    def allowance(self, tenant: str) -> float:
        return self.deficit.get(tenant, 0.0)

    def charge(self, tenant: str, n: int) -> None:
        self.deficit[tenant] = self.deficit.get(tenant, 0.0) - n

    def all_dry(self, tenant_weights: Dict[str, int]) -> bool:
        return all(self.deficit.get(t, 0.0) < 1.0 for t in tenant_weights)

    def replenish(self, tenant_weights: Dict[str, int], n_conns: int) -> None:
        """A new round: ``quantum * n_conns`` frames, split by weight,
        capped at two rounds of credit; tenants that left are dropped."""
        if not tenant_weights:
            return
        for t in list(self.deficit):
            if t not in tenant_weights:
                del self.deficit[t]
        total = float(_WDRR_QUANTUM * max(1, n_conns))
        sum_w = sum(tenant_weights.values())
        for t, w in tenant_weights.items():
            earn = max(1.0, total * w / sum_w)
            self.deficit[t] = min(2.0 * earn, max(0.0, self.deficit.get(t, 0.0)) + earn)


def _stream_tenant_weights(get_waiters) -> Tuple[Dict[str, int], int]:
    """``(tenant -> weight, live stream connections)`` over a queue's
    waiters; of several connections of one tenant the largest weight
    counts."""
    out: Dict[str, int] = {}
    n = 0
    for conn in get_waiters:
        if conn.stream is None or conn.closed:
            continue
        n += 1
        if conn.weight > out.get(conn.tenant, 0):
            out[conn.tenant] = conn.weight
    return out, n


class _StreamState:
    """A streamed connection's credit window and unacked tail."""

    __slots__ = ("window", "seq", "acked", "unacked", "queue_closed")

    def __init__(self, window: int):
        self.window = window
        self.seq = 0
        self.acked = 0
        self.unacked: deque = deque()  # (seq, item) in push order
        self.queue_closed = False

    def budget(self) -> int:
        return self.window - (self.seq - self.acked)


class _QueueState:
    """The loop's view of one backing queue: who waits on it."""

    __slots__ = ("queue", "get_waiters", "put_waiters", "ra_waiters", "repl", "listened",
                 "unlisten", "wdrr")

    def __init__(self, queue):
        self.queue = queue
        self.get_waiters: deque = deque()  # 'D' waiters and stream connections
        self.put_waiters: deque = deque()  # 'U'/'W' waiters, FIFO
        # connections whose put answers wait on the replicated ack floor
        self.ra_waiters: deque = deque()
        self.repl = None  # the queue's ReplicationSender, if it is chained
        self.listened = False
        self.unlisten = None
        self.wdrr = _Wdrr()


def _put_offset(queue, item) -> Tuple[bool, Optional[int]]:
    """``(ok, log offset)`` of a put; the offset is None on a memory queue."""
    put_offset = getattr(queue, "put_offset", None)
    if put_offset is not None:
        return put_offset(item)
    return queue.put(item), None


class _QueueClosedSignal(Exception):
    """The backing queue raised TransportClosed mid-pump."""


class _EvConn:
    """One connection: incremental reads, an outbound scatter-gather
    queue, the in-flight deliveries and, once subscribed, the stream's
    credit window."""

    __slots__ = (
        "loop", "sock", "srv", "queue", "in_flight", "out", "out_bytes", "closing", "closed",
        "stream", "pending", "op_gen", "codec", "tenant", "weight", "_out_enq_total",
        "_out_releases", "_hdr", "_hdr_mv", "_target", "_need", "_got", "_cb", "_lease",
        "_want_read", "_want_write", "_mask", "_qb_remaining", "_qb_items", "_pw_wait_s",
        "_w_seq", "_open_ns", "_open_buf", "replay", "_r_from", "_no_splice", "_migration",
        "replica", "held", "_v_off", "_v_floor",
    )

    def __init__(self, loop: "EventLoop", sock: socket.socket, srv):
        self.loop = loop
        self.sock = sock
        self.srv = srv
        self.queue = srv.queue  # until an OPEN binds another
        # popped, unconfirmed deliveries: cleared at the next opcode (the
        # implicit ack), requeued if the connection dies first
        self.in_flight: List[Any] = []
        self.out: deque = deque()  # memoryviews waiting to be sent
        self.out_bytes = 0
        self.closing = False  # flush what is queued, then close
        self.closed = False
        self.stream: Optional[_StreamState] = None
        # the codec frames sent on this connection use ('Z'); a receive is
        # driven by its tag and needs no state
        self.codec = None
        self.tenant = _TENANT_DEFAULT
        self.weight = 1
        # staging leases of compressed parts: (bytes-enqueued mark, lease),
        # released once the bytes sent pass the mark
        self._out_enq_total = 0
        self._out_releases: deque = deque()
        self.pending: Optional[dict] = None  # a deferred 'D'/'U'/'W'
        self.op_gen = 0  # staleness guard of timer-heap entries
        self._hdr = bytearray(64)  # control-field scratch
        self._hdr_mv = memoryview(self._hdr)
        self._target: Optional[memoryview] = None
        self._need = 0
        self._got = 0
        self._cb = None
        self._lease = None  # the pooled lease a payload is landing in
        self._want_read = False
        self._want_write = False
        self._mask = 0
        self._qb_remaining = 0
        self._qb_items: List[Any] = []
        self._pw_wait_s = 0.0
        self._w_seq = 0
        self._open_ns = ""
        self._open_buf = bytearray()
        # a durable queue's replay cursor ('R'): when set, this connection's
        # reads serve the log without popping the queue
        self.replay = None
        self._r_from = 0
        # this socket refused sendfile: spilled records materialize
        self._no_splice = False
        # a handoff to the queue's owning worker in progress: {"target",
        # "ctx", "deadline"}; reads pause and queued bytes flush first
        self._migration = None
        # replica mode ('H'): the replica log this owner's link appends to
        self.replica = None
        self._v_off = 0
        self._v_floor = 0
        # put answers waiting on the replicated ack floor: (offset, answer
        # bytes), in the order they must go out
        self.held: deque = deque()

    # -- reads ----------------------------------------------------------
    def _arm(self, mv: memoryview, cb, lease=None) -> None:
        self._lease = lease
        self._target = mv
        self._need = mv.nbytes
        self._got = 0
        self._cb = cb

    def _expect(self, n: int, cb) -> None:
        self._arm(self._hdr_mv[:n], cb)

    def _expect_payload(self, n: int, cb) -> None:
        if n > _MAX_PAYLOAD:
            raise ConnectionError(f"payload length {n} exceeds wire maximum {_MAX_PAYLOAD}")
        lease = self.srv._pool.lease(n)
        self._arm(lease.mv, cb, lease=lease)

    def _expect_string(self, n: int, cb) -> None:
        """A control string of ``n`` bytes (names, JSON) into its own buffer."""
        self._open_buf = bytearray(n)
        self._arm(memoryview(self._open_buf), cb)

    def _await_op(self) -> None:
        self._expect(1, self._on_op)

    def on_readable(self) -> None:
        if self.closed or self.closing:
            return
        if self.pending is not None:
            self._probe_while_pending()
            return
        while True:
            if self._got < self._need:
                try:
                    k = self.sock.recv_into(self._target[self._got:])
                except (BlockingIOError, InterruptedError):
                    return
                if k == 0:
                    raise ConnectionError("peer closed")
                self._got += k
                if self._got < self._need:
                    continue
            cb = self._cb
            self._cb = None
            cb()
            if self.closed or self.closing or self.pending is not None or self._cb is None:
                return

    def _probe_while_pending(self) -> None:
        """Readable during a deferred op: EOF (the peer died mid-wait:
        the op is dropped with the connection) or pipelined bytes that
        wait their turn. Reads pause then (level-triggered epoll would
        spin), and a timer re-probes, so a peer that dies later is still
        caught."""
        try:
            k = self.sock.recv_into(self._hdr_mv[:1], 1, socket.MSG_PEEK)
        except (BlockingIOError, InterruptedError):
            return
        if k == 0:
            raise ConnectionError("peer closed while op deferred")
        self._set_interest(read=False)
        self.loop.add_liveness_probe(self)

    # -- writes ---------------------------------------------------------
    def send_parts(self, parts, release=None) -> None:
        """Queue parts to send. ``release`` (a lease or a list of them,
        backing compressed parts) is released once every byte queued so
        far has gone to the kernel. A :class:`FileSpan` queues as itself
        (``sendfile`` moves it); the byte runs between spans gather as
        usual."""
        run: List[Any] = []
        for p in parts:
            if type(p) is FileSpan:
                self._enqueue_bufs(run)
                run = []
                self.out.append(p)
                self.out_bytes += p.nbytes
                self._out_enq_total += p.nbytes
            else:
                run.append(p)
        self._enqueue_bufs(run)
        if release is not None:
            for lease in release if isinstance(release, list) else (release,):
                self._out_releases.append((self._out_enq_total, lease))
        self.flush_out()

    def _enqueue_bufs(self, parts) -> None:
        for m in _gather_parts(parts):
            self.out.append(m)
            self.out_bytes += m.nbytes
            self._out_enq_total += m.nbytes

    def _send_control(self, b: bytes) -> None:
        self.send_parts([b])

    def flush_out(self) -> None:
        if self.closed:
            return
        try:
            while self.out:
                if type(self.out[0]) is FileSpan:
                    self._pump_span(self.out[0])
                    continue
                bufs = []
                for m in self.out:
                    if type(m) is FileSpan or len(bufs) >= _SENDMSG_IOV:
                        break  # a span goes alone, on the next turn
                    bufs.append(m)
                sent = self.sock.sendmsg(bufs)
                if sent <= 0:
                    raise ConnectionError("peer closed during send")
                self.out_bytes -= sent
                while sent:
                    m = self.out[0]
                    if sent >= m.nbytes:
                        sent -= m.nbytes
                        self.out.popleft()
                    else:
                        self.out[0] = m[sent:]
                        sent = 0
        except (BlockingIOError, InterruptedError):
            pass
        sent_total = self._out_enq_total - self.out_bytes
        while self._out_releases and self._out_releases[0][0] <= sent_total:
            self._out_releases.popleft()[1].release()
        if not self.out and self.closing:
            self.loop.kill_conn(self, None, requeue=False)
            return
        if not self.out and self._migration is not None:
            self.loop._try_migrate(self)  # the handoff waited for the flush
            return
        self._set_interest(write=bool(self.out))

    def _pump_span(self, span) -> None:
        """Send the head :class:`FileSpan` with ``os.sendfile``: the payload
        never enters the interpreter. A short send or ``BlockingIOError``
        is handled as a short ``sendmsg`` is; an errno that means this
        socket cannot splice turns the rest of the span (and this
        connection's later spilled records) into bytes for ``sendmsg``."""
        try:
            sent = os.sendfile(self.sock.fileno(), span.fileno(), span.pos, span.nbytes)
        except (BlockingIOError, InterruptedError):
            raise
        except OSError as e:
            if fallback_errno(e):
                self._no_splice = True
                SPLICE.note_fallback(f"sendfile_errno_{e.errno}")
                self.out[0] = memoryview(span.materialize())
                return
            raise ConnectionError(f"sendfile failed: {e!r}") from e
        if sent <= 0:
            raise ConnectionError("peer closed during sendfile")
        self.out_bytes -= sent
        SPLICE.note_sendfile(sent)
        if sent >= span.nbytes:
            self.out.popleft()
            SPLICE.note_frame()
        else:
            span.advance(sent)

    def _set_interest(self, read: Optional[bool] = None, write: Optional[bool] = None) -> None:
        if read is not None:
            self._want_read = read
        if write is not None:
            self._want_write = write
        mask = ((selectors.EVENT_READ if self._want_read else 0)
                | (selectors.EVENT_WRITE if self._want_write else 0))
        if mask == self._mask or self.closed:
            return
        sel = self.loop._sel
        if self._mask == 0:
            sel.register(self.sock, mask, self)
        elif mask == 0:
            sel.unregister(self.sock)
        else:
            sel.modify(self.sock, mask, self)
        self._mask = mask

    # -- deferred ops ---------------------------------------------------
    def park(self, kind: str, **state) -> None:
        self.pending = dict(state, kind=kind)
        self.op_gen += 1

    def unpark(self) -> None:
        self.pending = None
        self.op_gen += 1
        self._await_op()
        self._set_interest(read=True)

    # -- dispatch -------------------------------------------------------
    def _ack_in_flight(self) -> None:
        """The implicit ack: a durable queue advances (and persists) its
        committed floor over the deliveries, a replay cursor commits its
        group's position. A memory queue has nothing to do."""
        if self.in_flight:
            self._ack_items(self.in_flight)
        if self.replay is not None:
            self.replay.commit()

    def _on_op(self) -> None:
        op = self._hdr[0]
        # the peer read the last response before it sent this: the implicit ack
        self._ack_in_flight()
        self.in_flight = []
        self._dispatch(op)

    def _dispatch(self, op: int) -> None:
        if self.replica is not None:
            # a replica link carries appends and BYE only
            if op == _OP_REPL_APPEND[0]:
                self._expect(20, self._va_hdr)
                return
            if op == _OP_BYE[0]:
                self._begin_close()
                return
            raise ConnectionError(f"bad opcode {op:#04x} on a replica connection")
        if self.held and op != _OP_PUT_SEQ[0]:
            # answers held on the floor go out first: the op waits for them
            self.park("RA", op=op)
            return
        if self.stream is not None:
            # a streamed connection's upstream: acks, window resizes, BYE
            if op == _OP_STREAM_ACK[0]:
                self._expect(8, self._on_stream_ack)
                return
            if op == _OP_STREAM[0]:
                self._expect(4, self._stream_resize)
                return
            if op == _OP_BYE[0]:
                self._finish_stream(clean=True)
                self._begin_close()
                return
            raise ConnectionError(f"bad opcode {op:#04x} on streamed connection")
        wctx = self.srv.worker_ctx
        if (wctx is not None and self.queue is self.srv.queue
                and wctx.worker_id != DEFAULT_QUEUE_WORKER and op not in _WORKER_LOCAL_OPS):
            # an op on the default queue, which another worker owns: ship
            # the connection there. Only the opcode byte was read (it rides
            # in the context); what the client pipelined behind it is still
            # in the kernel's buffer and travels with the fd
            self.loop.migrate_conn(self, DEFAULT_QUEUE_WORKER, {"kind": "op", "op": op})
            return
        name = _OPS.get(op)
        if name is None:
            self._send_control(_ST_ERR)
            self._begin_close()
            return
        getattr(self, name)()

    def _begin_close(self) -> None:
        """Flush queued bytes, then close without redelivery."""
        if self.out:
            self.closing = True
            self._set_interest(read=False, write=True)
        else:
            self.loop.kill_conn(self, None, requeue=False)

    # -- responses ------------------------------------------------------
    def _encode_item_parts(self, item):
        """The item's parts under this connection's codec, and the staging
        lease to release after they are sent. A :class:`SpilledRecord` on
        a plain connection is one :class:`FileSpan` (its payload on disk
        is the wire payload); a compressed connection, or a socket that
        refused ``sendfile``, reads it in first."""
        if type(item) is SpilledRecord:
            if self.codec is None and not self._no_splice and _sendfile_capable():
                span = item.payload_span()
                if span is not None:
                    return [FileSpan(*span)], None
                # not retained any more: the floor pin forbids it, but a
                # broken contract costs a copy here, not the connection
                SPLICE.note_fallback("span_unretained")
            item = item.materialize()
        return _wire_encode(item, self.codec, self.srv._pool)

    def _respond_item(self, item) -> None:
        parts, clease = self._encode_item_parts(item)
        self.send_parts([_ST_OK + struct.pack("<I", _parts_nbytes(parts)), *parts],
                        release=clease)

    def _respond_batch(self, items) -> None:
        self.in_flight = list(items)
        parts: List[Any] = [_ST_OK, struct.pack("<I", len(self.in_flight))]
        leases: List[Any] = []
        try:
            for item in self.in_flight:
                item_parts, clease = self._encode_item_parts(item)
                if clease is not None:
                    leases.append(clease)
                parts.append(struct.pack("<I", _parts_nbytes(item_parts)))
                parts.extend(item_parts)
        except BaseException:
            for clease in leases:  # nothing queued yet: still ours
                clease.release()
            raise
        t_send0 = time.monotonic() if TRACER.enabled else 0.0
        self.send_parts(parts, release=leases or None)
        if TRACER.enabled:
            _emit_relay_spans(self.in_flight, t_send0)

    def _take_item(self):
        """Decode the payload just received, zero-copy off its lease. A
        compressed frame is validated but not inflated (``lazy``): a peer
        of the same codec gets its bytes verbatim."""
        lease = self._lease
        self._lease = None
        try:
            return _decode(lease.mv, lease=lease, lazy=True)
        except BaseException:
            lease.release()
            raise

    def _try_put(self, item) -> Tuple[Optional[bool], Optional[int]]:
        """``queue.put`` with refusals answered ('X' closed, 'E' any other
        error: a poison record must not kill the connection, or a windowed
        producer would resend it on every reconnect). ``(ok, offset)``:
        the durable log's offset (None on a memory queue), which the
        replicated ack floor holds the answer on; ``(None, None)`` when
        answered."""
        try:
            return _put_offset(self.queue, item)
        except TransportClosed:
            self._send_control(_ST_CLOSED)
        except Exception:  # noqa: BLE001 (answer, don't kill the connection)
            self._send_control(_ST_ERR)
        return None, None

    def _answer_put(self, reply: bytes, offset: Optional[int], pipelined: bool = False,
                    parked: bool = False) -> None:
        """Send a put's answer, or hold it until the queue's follower has
        logged ``offset`` (the replicated ack floor; the pump sends it).
        A held windowed answer (``pipelined``) lets reads go on; any other
        parks the connection. ``parked``: the pump is resolving this
        connection's deferred op."""
        repl = self.loop.repl_sender(self.queue)
        if self.held or (offset is not None and repl is not None
                         and not repl.reached(offset)):
            self.held.append((offset, reply))
            self.loop.add_rack_waiter(self)
            if not pipelined:
                self.park("RA")
                return
        else:
            self._send_control(reply)
        if parked:
            self.unpark()
        else:
            self._await_op()

    def release_held(self, repl) -> bool:
        """Send the held answers the follower has reached, in order. When
        none is left, resume a parked connection (running the op that
        waited for them). True when anything went out."""
        did = False
        while self.held:
            offset = self.held[0][0]
            if offset is not None and repl is not None and not repl.reached(offset):
                return did
            self._send_control(self.held.popleft()[1])
            did = True
        if self.pending is not None and self.pending.get("kind") == "RA":
            op = self.pending.get("op")
            if op is None:
                self.unpark()
            else:
                self.pending = None
                self.op_gen += 1
                self._set_interest(read=True)
                self._dispatch(op)
            did = True
        return did

    def _put_refused(self) -> bool:
        """A draining server answers a put 'X'."""
        if self.srv._draining:
            self._send_control(_ST_CLOSED)
            self._await_op()
            return True
        return False

    # -- opcodes --------------------------------------------------------
    def _op_put(self) -> None:
        self._expect(4, self._put_hdr)

    def _put_hdr(self) -> None:
        (n,) = struct.unpack_from("<I", self._hdr)
        self._expect_payload(n, self._put_payload)

    def _put_payload(self) -> None:
        item = self._take_item()
        if TRACER.enabled:
            _stamp_relay_arrival(item)
        if self._put_refused():
            return
        ok, offset = self._try_put(item)
        if ok:
            self._answer_put(_ST_OK, offset)
            return
        if ok is not None:
            self._send_control(_ST_NO)
        self._await_op()

    def _op_get(self) -> None:
        try:
            if self.replay is not None:
                items = self.replay.next_batch(1)
                item = items[0] if items else EMPTY
            else:
                item = self.queue.get()
        except TransportClosed:
            self._send_control(_ST_CLOSED)
        else:
            if item is EMPTY:
                self._send_control(_ST_NO)
            else:
                self.in_flight = [item]  # held until the next opcode
                t_send0 = time.monotonic() if TRACER.enabled else 0.0
                self._respond_item(item)
                if TRACER.enabled:
                    _emit_relay_spans(self.in_flight, t_send0)
        self._await_op()

    def _op_get_batch(self) -> None:
        self._expect(4, self._gb_hdr)

    def _gb_hdr(self) -> None:
        (max_items,) = struct.unpack_from("<I", self._hdr)
        try:
            items = self._read_batch(min(max_items, 4096))
        except TransportClosed:
            self._send_control(_ST_CLOSED)
        else:
            self._respond_batch(items)
        self._await_op()

    def _read_batch(self, max_items: int) -> List[Any]:
        """A non-blocking read: the replay cursor where one is open, else
        the queue."""
        if self.replay is not None:
            return self.replay.next_batch(max_items)
        return self.queue.get_batch(max_items, timeout=0.0)

    def _op_get_batch_wait(self) -> None:
        self._expect(8, self._gbw_hdr)

    def _gbw_hdr(self) -> None:
        max_items, wait_ms = struct.unpack_from("<II", self._hdr)
        max_items = min(max_items, 4096)
        wait_s = min(wait_ms / 1000.0, _SERVER_WAIT_CAP_S)
        try:
            items = self._read_batch(max_items)
        except TransportClosed:
            self._send_control(_ST_CLOSED)
            self._await_op()
            return
        if items or wait_s <= 0:
            self._respond_batch(items)
            self._await_op()
            return
        # an empty queue: served by the pump or answered empty by the timer
        self.park("D", max_items=max_items)
        self.loop.add_get_waiter(self, time.monotonic() + wait_s)

    def _op_put_wait(self) -> None:
        self._expect(8, self._pw_hdr)

    def _pw_hdr(self) -> None:
        wait_ms, n = struct.unpack_from("<II", self._hdr)
        self._pw_wait_s = min(wait_ms / 1000.0, _SERVER_WAIT_CAP_S)
        self._expect_payload(n, self._pw_payload)

    def _pw_payload(self) -> None:
        item = self._take_item()
        if TRACER.enabled:
            _stamp_relay_arrival(item)
        if self._put_refused():
            return
        ok, offset = self._try_put(item)
        if ok is None:
            self._await_op()
            return
        if ok:
            self._answer_put(_ST_OK, offset)
            return
        if self._pw_wait_s <= 0:
            self._send_control(_ST_NO)
            self._await_op()
            return
        self.park("U", item=item)
        self.loop.add_put_waiter(self, time.monotonic() + self._pw_wait_s)

    def _op_put_seq(self) -> None:
        self._expect(12, self._ws_hdr)

    def _ws_hdr(self) -> None:
        seq, n = struct.unpack_from("<QI", self._hdr)
        self._w_seq = seq
        self._expect_payload(n, self._ws_payload)

    def _ws_payload(self) -> None:
        item = self._take_item()
        if TRACER.enabled:
            _stamp_relay_arrival(item)
        if self._put_refused():
            return
        ok, offset = self._try_put(item)
        if ok is None:
            self._await_op()
            return
        if ok:
            self._answer_put(_ST_OK + struct.pack("<Q", self._w_seq), offset, pipelined=True)
            return
        # backpressure: the ack waits for room, with no deadline (the delay
        # is the signal)
        self.park("W", item=item, seq=self._w_seq)
        self.loop.add_put_waiter(self, None)

    def _op_put_batch(self) -> None:
        self._expect(4, self._qb_count)

    def _qb_count(self) -> None:
        (count,) = struct.unpack_from("<I", self._hdr)
        self._qb_remaining = count
        self._qb_items = []
        self._qb_next()

    def _qb_next(self) -> None:
        if self._qb_remaining <= 0:
            self._qb_finish()
            return
        self._qb_remaining -= 1
        self._expect(4, self._qb_len)

    def _qb_len(self) -> None:
        (n,) = struct.unpack_from("<I", self._hdr)
        self._expect_payload(n, self._qb_payload)

    def _qb_payload(self) -> None:
        self._qb_items.append(self._take_item())
        self._qb_next()

    def _qb_finish(self) -> None:
        batch, self._qb_items = self._qb_items, []
        if TRACER.enabled:
            for item in batch:
                _stamp_relay_arrival(item)
        if self._put_refused():
            return
        accepted = 0
        high = None  # the highest log offset (offsets increase)
        for item in batch:
            ok, offset = self._try_put(item)
            if ok is None:  # refusal already answered
                self._await_op()
                return
            if not ok:
                break  # full: the accepted prefix only (FIFO)
            accepted += 1
            if offset is not None:
                high = offset
        self._answer_put(_ST_OK + struct.pack("<I", accepted), high)

    def _op_stream(self) -> None:
        self._expect(4, self._stream_hdr)

    def _stream_hdr(self) -> None:
        (window,) = struct.unpack_from("<I", self._hdr)
        if self.replay is not None:
            # replay is pull-mode: stream seqs would need a second mapping
            # to cursor offsets to commit on ack
            raise ConnectionError("stream subscribe on a replay connection")
        window = max(1, min(int(window), 4096))
        self.stream = _StreamState(window)
        STREAM.opened(window)
        FLIGHT.record("stream_open", port=self.srv.port, window=window)
        self.loop.add_stream(self)
        self._await_op()  # from here: only 'K', 'M' and 'F' upstream

    def _stream_resize(self) -> None:
        """'M' on a streamed connection: resize the credit window in place
        (no answer, as the subscribe has none)."""
        (window,) = struct.unpack_from("<I", self._hdr)
        window = max(1, min(int(window), 4096))
        st = self.stream
        old, st.window = st.window, window
        if window != old:
            STREAM.resized(old, window)
            FLIGHT.record("stream_resize", port=self.srv.port, old=old, window=window)
        self._await_op()

    def _on_stream_ack(self) -> None:
        (seq,) = struct.unpack_from("<Q", self._hdr)
        st = self.stream
        if seq > st.acked:
            st.acked = seq
            STREAM.acked_msg()
        acked = []
        while st.unacked and st.unacked[0][0] <= st.acked:
            acked.append(st.unacked.popleft()[1])  # credit returned: the lease may go
        if acked:
            STREAM.pruned(len(acked))
            self._ack_items(acked)  # a durable queue's commit point
        self._await_op()

    def _ack_items(self, items) -> None:
        ack = getattr(self.queue, "ack_delivered", None)
        if ack is not None:
            ack(items)

    def push_stream_items(self, items) -> None:
        st = self.stream
        t_send0 = time.monotonic() if TRACER.enabled else 0.0
        parts: List[Any] = []
        leases: List[Any] = []
        try:
            for item in items:
                st.seq += 1
                st.unacked.append((st.seq, item))
                item_parts, clease = self._encode_item_parts(item)
                if clease is not None:
                    leases.append(clease)
                parts.append(_ST_OK + struct.pack("<QI", st.seq, _parts_nbytes(item_parts)))
                parts.extend(item_parts)
        except BaseException:
            for clease in leases:
                clease.release()
            raise
        self.send_parts(parts, release=leases or None)
        STREAM.pushed(len(items))
        if TRACER.enabled:
            _emit_relay_spans(items, t_send0)

    def _finish_stream(self, clean: bool) -> None:
        """Stream teardown: prune what the last cumulative ack covered and
        requeue the rest at the head, unless the queue itself closed."""
        st, self.stream = self.stream, None
        if st is None:
            return
        acked = []
        while st.unacked and st.unacked[0][0] <= st.acked:
            acked.append(st.unacked.popleft()[1])
        if acked:
            STREAM.pruned(len(acked))
            self._ack_items(acked)  # the last cumulative ack commits too
        lost = [item for (_s, item) in st.unacked]
        st.unacked.clear()
        if lost:
            STREAM.pruned(len(lost))
            if not st.queue_closed:
                STREAM.redelivered_n(len(lost))
                FLIGHT.record("stream_redelivery", count=len(lost), clean_bye=clean)
                self.loop.requeue_items(self.queue, lost)
        STREAM.closed(st.window)

    def _op_size(self) -> None:
        try:
            n = self.queue.size()
        except TransportClosed:
            self._send_control(_ST_CLOSED)
        else:
            self._send_control(_ST_OK + struct.pack("<I", n))
        self._await_op()

    def _send_json(self, obj) -> None:
        payload = json.dumps(obj).encode()
        self.send_parts([_ST_OK + struct.pack("<I", len(payload)), payload])

    def _op_stats(self) -> None:
        self._send_json(_queue_stats_payload(self.queue))
        self._await_op()

    def _op_anchor(self) -> None:
        self._expect(16, self._anchor_reply)

    def _anchor_reply(self) -> None:
        self._send_control(_ST_OK + struct.pack("<dd", time.time(), time.monotonic()))
        self._await_op()

    def _op_close(self) -> None:
        try:
            self.queue.close()
        except TransportClosed:
            self._send_control(_ST_CLOSED)
        else:
            self._send_control(_ST_OK)
        self._await_op()

    def _op_bye(self) -> None:
        self._begin_close()  # the last response was acked when this arrived

    def _op_cluster(self) -> None:
        self._expect(4, self._cluster_len)

    def _cluster_len(self) -> None:
        (n,) = struct.unpack_from("<I", self._hdr)
        if n > 1 << 20:  # control-plane JSON: a MB is already absurd
            raise ConnectionError(f"cluster RPC payload {n} bytes")
        self._expect_string(n, self._cluster_finish)

    def _cluster_finish(self) -> None:
        """The link probe's ping answers in O(1) (its padded request is
        what is timed); ``{"op": "metrics"}`` gets the federation payload;
        every other request goes to the server's group registry, and a
        malformed one gets ``{"ok": false, ...}``."""
        buf = self._open_buf
        if buf[:13] == b'{"op": "ping"':
            self._send_json({"ok": True, "nbytes": len(buf)})
            self._await_op()
            return
        try:
            req = json.loads(buf.decode())
            if req.get("op") == "metrics":
                resp = federation_payload()
            elif req.get("op") == "ping":
                resp = {"ok": True, "nbytes": len(buf)}
            else:
                resp = self.srv.groups.handle(req)
        except Exception as e:  # noqa: BLE001 (a bad RPC must not kill the loop)
            resp = {"ok": False, "error": repr(e)}
        self._send_json(resp)
        self._await_op()

    def _op_replay(self) -> None:
        """'R' (from:u64, group_len:u16, group): this connection's reads
        switch to a replay cursor over the bound durable queue's retained
        log; the answer carries the cursor's start and the log's tail. A
        memory queue has no log: '0'."""
        self._expect(10, lambda: self._log_hdr(self._replay_finish))

    def _op_commit(self) -> None:
        """'J' (offset:u64, group_len:u16, group): commit the replay
        cursor (``COMMIT_DELIVERED``: all it delivered), or ``group``'s
        offset on the bound durable queue; '0' where there is nothing to
        commit against."""
        self._expect(10, lambda: self._log_hdr(self._commit_finish))

    def _log_hdr(self, then) -> None:
        self._r_from, glen = struct.unpack_from("<QH", self._hdr)
        self._expect_string(glen, then)

    def _replay_finish(self) -> None:
        group = self._open_buf.decode() or "replay"
        open_replay = getattr(self.queue, "open_replay", None)
        if open_replay is None:
            self._answer_no()
            return
        self.replay = open_replay(group, self._r_from)
        self._send_control(_ST_OK + struct.pack("<QQ", self.replay.position,
                                                self.replay.log.next_offset))
        self._await_op()

    def _commit_finish(self) -> None:
        offset, group = self._r_from, self._open_buf.decode()
        if self.replay is not None:
            self.replay.commit(None if offset == COMMIT_DELIVERED else offset)
            self._send_control(_ST_OK)
            self._await_op()
            return
        commit = getattr(self.queue, "commit_offset", None)
        if commit is None or not group or offset == COMMIT_DELIVERED:
            self._answer_no()
            return
        commit(offset, group)
        self._send_control(_ST_OK)
        self._await_op()

    def _answer_no(self) -> None:
        self._send_control(_ST_NO)
        self._await_op()

    def _read_names(self, then) -> None:
        """ns_len:u16, ns, name_len:u16, name; then ``then(ns, name)``."""
        def ns_len():
            (n,) = struct.unpack_from("<H", self._hdr)
            self._expect_string(n, ns_done)

        def ns_done():
            self._open_ns = self._open_buf.decode()
            self._expect(2, nm_len)

        def nm_len():
            (n,) = struct.unpack_from("<H", self._hdr)
            self._expect_string(n, lambda: then(self._open_ns, self._open_buf.decode()))

        self._expect(2, ns_len)

    def _op_repl_open(self) -> None:
        """'H': switch to replica mode for the named queue's replica log,
        answering its tail; '0' when this server cannot host it (no
        replication, the queue is live here, or it was promoted)."""
        self._read_names(self._repl_open_finish)

    def _repl_open_finish(self, ns: str, nm: str) -> None:
        repl = self.srv.replication
        entry = repl.replica_open(ns, nm) if repl is not None else None
        if entry is None:
            self._answer_no()
            return
        self.replica = entry
        tail = entry.log.next_offset
        REPL.note("replica_subscribe", port=self.srv.port, queue=f"{ns}/{nm}", tail=tail)
        self._send_control(_ST_OK + struct.pack("<Q", tail))
        self._await_op()

    def _va_hdr(self) -> None:
        self._v_off, self._v_floor, n = struct.unpack_from("<QQI", self._hdr)
        self._expect_payload(n, self._va_payload)

    def _va_payload(self) -> None:
        item = self._take_item()
        try:
            ok = self.srv.replication.replica_append(self.replica, self._v_off, self._v_floor,
                                                     item)
        except Exception:  # noqa: BLE001 (a replica disk fault answers 'E'; the loop lives)
            ok = False
        finally:
            release = getattr(item, "release", None)
            if release is not None:
                release()  # the record is in the log now, or refused
        self._send_control(_ST_OK + struct.pack("<Q", self._v_off) if ok else _ST_ERR)
        self._await_op()

    def _op_promote(self) -> None:
        """'Y': promote the named replica log, answering its retained
        range; '0' when no replica is here."""
        self._read_names(self._promote_finish)

    def _promote_finish(self, ns: str, nm: str) -> None:
        repl = self.srv.replication
        rng = repl.promote(ns, nm) if repl is not None else None
        if rng is None:
            self._answer_no()
            return
        self._send_control(_ST_OK + struct.pack("<QQ", *rng))
        self._await_op()

    def _op_codec(self) -> None:
        self._expect(2, self._codec_len)

    def _codec_len(self) -> None:
        (n,) = struct.unpack_from("<H", self._hdr)
        if n > 4096:  # a codec list is tens of bytes
            raise ConnectionError(f"codec negotiation payload {n} bytes")
        self._expect_string(n, self._codec_finish)

    def _codec_finish(self) -> None:
        # codec names and key=value capability fields; a field this server
        # does not know is ignored, a name it does not know skipped
        names = []
        for entry in self._open_buf.decode().split(","):
            entry = entry.strip()
            key, sep, value = entry.partition("=")
            if not sep:
                names.append(entry)
                continue
            if key == "tenant":
                tenant, _, w = value.partition(":")
                self.tenant = tenant or _TENANT_DEFAULT
                try:
                    self.weight = max(1, min(_TENANT_WEIGHT_MAX, int(w))) if w else 1
                except ValueError:
                    self.weight = 1
                FLIGHT.record("tenant_hello", port=self.srv.port, tenant=self.tenant,
                              weight=self.weight)
        self.codec = negotiate_codec(names)
        name = self.codec.name if self.codec is not None else CODEC_NONE
        CODEC_STATS.negotiated(name)
        FLIGHT.record("codec_negotiated", port=self.srv.port, codec=name, server=True)
        nb = name.encode()
        self._send_control(_ST_OK + struct.pack("<H", len(nb)) + nb)
        self._await_op()

    def _op_open(self) -> None:
        self._expect(2, self._open_ns_len)

    def _open_ns_len(self) -> None:
        (n,) = struct.unpack_from("<H", self._hdr)
        self._expect_string(n, self._open_ns_done)

    def _open_ns_done(self) -> None:
        self._open_ns = self._open_buf.decode()
        self._expect(2, self._open_nm_len)

    def _open_nm_len(self) -> None:
        (n,) = struct.unpack_from("<H", self._hdr)
        self._expect_string(n, lambda: self._expect(4, self._open_finish))

    def _open_finish(self) -> None:
        (maxsize,) = struct.unpack_from("<I", self._hdr)
        name = self._open_buf.decode()
        wctx = self.srv.worker_ctx
        if wctx is not None:
            owner = wctx.owner_of(self._open_ns, name)
            if owner != wctx.worker_id:
                # the queue lives on its owner: the adopter opens it and
                # answers the client
                self.loop.migrate_conn(self, owner, {"kind": "open", "ns": self._open_ns,
                                                     "nm": name, "maxsize": maxsize})
                return
        self.queue = self.srv.open_named(self._open_ns, name, maxsize or None)
        self._send_control(_ST_OK)
        self._await_op()

_OPS: Dict[int, str] = {
    _OP_PUT[0]: "_op_put",
    _OP_GET[0]: "_op_get",
    _OP_SIZE[0]: "_op_size",
    _OP_CLOSE[0]: "_op_close",
    _OP_GET_BATCH[0]: "_op_get_batch",
    _OP_GET_BATCH_WAIT[0]: "_op_get_batch_wait",
    _OP_PUT_BATCH[0]: "_op_put_batch",
    _OP_PUT_WAIT[0]: "_op_put_wait",
    _OP_PUT_SEQ[0]: "_op_put_seq",
    _OP_STREAM[0]: "_op_stream",
    _OP_OPEN[0]: "_op_open",
    _OP_STATS[0]: "_op_stats",
    _OP_ANCHOR[0]: "_op_anchor",
    _OP_CLUSTER[0]: "_op_cluster",
    _OP_REPLAY[0]: "_op_replay",
    _OP_COMMIT[0]: "_op_commit",
    _OP_CODEC[0]: "_op_codec",
    _OP_REPL_OPEN[0]: "_op_repl_open",
    _OP_PROMOTE[0]: "_op_promote",
    _OP_BYE[0]: "_op_bye",
}

# the ops a worker serves itself whatever queue it owns: the capability
# exchange and the anchor (a worker's own answers), the replica ops
# (refused: a fleet does not replicate) and BYE. OPEN routes at its end,
# once the name is read. The group RPC is not among them: on an unbound connection it
# goes to the default queue's worker, whose registry is the fleet's one
_WORKER_LOCAL_OPS = frozenset(
    op for op, handler in _OPS.items()
    if handler in ("_op_open", "_op_codec", "_op_anchor", "_op_repl_open", "_op_promote",
                   "_op_bye"))


class EvLoopTelemetry:
    """The loop's health, the ``evloop`` registry source: connections,
    refusals, passes, and how long a dispatch pass holds the loop against
    how long it waits in ``select`` (``busy_frac``: dispatch over dispatch
    plus select, cumulative, and its EWMA over passes; 1.0 is a loop that
    never waits). One a process (:data:`EVLOOP`), registered by the first
    loop."""

    def __init__(self):
        self._lock = threading.Lock()
        self.connections = 0  # guarded-by: _lock
        self.connections_peak = 0  # guarded-by: _lock
        self.accepted_total = 0  # guarded-by: _lock
        self.refused_total = 0  # guarded-by: _lock
        self.loops_total = 0  # guarded-by: _lock
        self.dispatch_ms_last = 0.0  # guarded-by: _lock
        self.dispatch_ms_max = 0.0  # guarded-by: _lock
        self.dispatch_ms_ewma = 0.0  # guarded-by: _lock
        self.timer_lag_ms_max = 0.0  # guarded-by: _lock
        self.dispatch_s_total = 0.0  # guarded-by: _lock
        self.select_s_total = 0.0  # guarded-by: _lock
        self.busy_frac_ewma = 0.0  # guarded-by: _lock

    def conn_opened(self):
        with self._lock:
            self.accepted_total += 1
            self.connections += 1
            if self.connections > self.connections_peak:
                self.connections_peak = self.connections

    def conn_closed(self):
        with self._lock:
            self.connections -= 1

    def refused(self):
        with self._lock:
            self.refused_total += 1

    def loop_pass(self, dispatch_ms: float, select_ms: float = 0.0):
        with self._lock:
            self.loops_total += 1
            self.dispatch_ms_last = dispatch_ms
            if dispatch_ms > self.dispatch_ms_max:
                self.dispatch_ms_max = dispatch_ms
            self.dispatch_ms_ewma += 0.05 * (dispatch_ms - self.dispatch_ms_ewma)
            self.dispatch_s_total += dispatch_ms * 1e-3
            self.select_s_total += select_ms * 1e-3
            span_ms = dispatch_ms + select_ms
            if span_ms > 0.0:
                frac = dispatch_ms / span_ms
                self.busy_frac_ewma += 0.05 * (frac - self.busy_frac_ewma)

    def timer_lag(self, lag_ms: float):
        with self._lock:
            if lag_ms > self.timer_lag_ms_max:
                self.timer_lag_ms_max = lag_ms

    def stats(self) -> dict:
        with self._lock:
            busy_s = self.dispatch_s_total + self.select_s_total
            return {
                "connections": self.connections,
                "connections_peak": self.connections_peak,
                "accepted_total": self.accepted_total,
                "refused_total": self.refused_total,
                "loops_total": self.loops_total,
                "dispatch_ms_last": round(self.dispatch_ms_last, 3),
                "dispatch_ms_max": round(self.dispatch_ms_max, 3),
                "dispatch_ms_ewma": round(self.dispatch_ms_ewma, 3),
                "timer_lag_ms_max": round(self.timer_lag_ms_max, 3),
                "busy_frac": round(self.dispatch_s_total / busy_s if busy_s > 0.0 else 0.0, 6),
                "busy_frac_ewma": round(self.busy_frac_ewma, 6),
            }

    def snapshot(self) -> dict:
        return self.stats()


EVLOOP = EvLoopTelemetry()


class EventLoop:
    """The one loop of a :class:`~psana_ray_tpu_torch.transport.tcp.
    TcpQueueServer`: accepts, reads, writes, fires bounded-wait timers and
    pumps queue waiters."""

    def __init__(self, server):
        ensure_registered("splice", SPLICE)
        ensure_registered("evloop", EVLOOP)
        self._srv = server
        self._sel = selectors.DefaultSelector()
        self._conns: set = set()
        self._queues: Dict[int, _QueueState] = {}
        self._timers: List[tuple] = []  # heap: (deadline, tie, conn, gen, kind)
        self._timer_tie = 0
        # listeners and shutdown poke this pair so the selector wakes at once
        self._waker_r, self._waker_w = socket.socketpair()
        self._waker_r.setblocking(False)
        self._waker_w.setblocking(False)
        self._waker_buf = bytearray(512)
        self._ACCEPT = object()
        self._WAKER = object()
        self._ADOPT = object()
        self._loop_tid: Optional[int] = None

    def wake(self) -> None:
        # the loop's own queue ops fire the listeners too; it is awake then,
        # and pumps at the end of every pass, so only other threads poke
        if threading.get_ident() == self._loop_tid:
            return
        try:
            self._waker_w.send(b"w")
        except OSError:
            pass  # full: a wakeup is already pending; closed: exiting

    # -- queue state ----------------------------------------------------
    def _qs(self, queue) -> _QueueState:
        qs = self._queues.get(id(queue))
        if qs is None:
            qs = _QueueState(queue)
            self._queues[id(queue)] = qs
            repl = self._srv.replication
            if repl is not None:
                # the sender was mounted at open_named, before any
                # connection bound the queue
                qs.repl = repl.sender_for(queue)
            add = getattr(queue, "add_listener", None)
            if add is not None:
                try:
                    add(self.wake)
                    qs.listened = True
                    remove = getattr(queue, "remove_listener", None)
                    if remove is not None:
                        qs.unlisten = lambda: remove(self.wake)
                except Exception:
                    qs.listened = False
        return qs

    def add_get_waiter(self, conn: _EvConn, deadline: Optional[float]) -> None:
        self._qs(conn.queue).get_waiters.append(conn)
        if deadline is not None:
            self._add_timer(deadline, conn)

    def add_put_waiter(self, conn: _EvConn, deadline: Optional[float]) -> None:
        self._qs(conn.queue).put_waiters.append(conn)
        if deadline is not None:
            self._add_timer(deadline, conn)

    def add_stream(self, conn: _EvConn) -> None:
        self._qs(conn.queue).get_waiters.append(conn)

    def add_rack_waiter(self, conn: _EvConn) -> None:
        """A connection whose answers wait on the replicated ack floor; no
        deadline (the sender's degrade grace bounds a dead link's wait)."""
        rw = self._qs(conn.queue).ra_waiters
        if conn not in rw:
            rw.append(conn)

    def repl_sender(self, queue):
        """The queue's ReplicationSender, or None when it is not chained."""
        if self._srv.replication is None:
            return None
        return self._qs(queue).repl

    def add_liveness_probe(self, conn: _EvConn) -> None:
        """Re-arm a parked, read-paused connection's reads after
        ``PROBE_INTERVAL_S``, so the EOF probe runs again."""
        self._add_timer(time.monotonic() + PROBE_INTERVAL_S, conn, kind="probe")

    def _add_timer(self, deadline: float, conn: _EvConn, kind: str = "op") -> None:
        self._timer_tie += 1
        heapq.heappush(self._timers, (deadline, self._timer_tie, conn, conn.op_gen, kind))

    def requeue_items(self, queue, items) -> None:
        """Head-requeue through the recovery path. A queue without
        ``put_front`` (an shm ring) takes timed retries that can block:
        those run on a short-lived helper thread."""
        if not items:
            return
        if getattr(queue, "put_front", None) is not None:
            self._srv._requeue(queue, items)
        else:
            threading.Thread(target=self._srv._requeue, args=(queue, items), daemon=True,
                             name="tcp-evloop-requeue").start()

    def kill_conn(self, conn: _EvConn, cause, requeue: bool = True) -> None:
        if conn.closed:
            return
        conn.closed = True
        if conn._mask:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass
            conn._mask = 0
        try:
            conn.sock.close()
        except OSError:
            pass
        self._conns.discard(conn)
        EVLOOP.conn_closed()
        if conn._lease is not None:  # a payload died mid-read
            conn._lease.release()
            conn._lease = None
        while conn._out_releases:
            conn._out_releases.popleft()[1].release()
        # a parked 'U'/'W' item was never enqueued: drop it (a windowed
        # producer resends it on reconnect; enqueueing it now would double it).
        # Held answers die too: their producer resends what went unanswered
        conn.pending = None
        conn.held.clear()
        conn.replica = None
        conn._qb_items = []
        if conn.replay is not None:
            # a cursor's deliveries are not popped: what the dead client
            # read and did not commit comes again when its group resumes
            conn.in_flight = []
            conn.replay = None
        if requeue:
            if conn.in_flight:
                self.requeue_items(conn.queue, conn.in_flight)
                conn.in_flight = []
            conn._finish_stream(clean=False)
        elif conn.stream is not None:
            conn._finish_stream(clean=True)

    # -- the loop -------------------------------------------------------
    def run(self) -> None:
        srv = self._srv
        self._loop_tid = threading.get_ident()
        try:
            srv._sock.setblocking(False)
        except OSError:
            return  # shutdown() closed the socket first
        self._sel.register(srv._sock, selectors.EVENT_READ, self._ACCEPT)
        self._sel.register(self._waker_r, selectors.EVENT_READ, self._WAKER)
        if srv.worker_ctx is not None:
            # sibling workers ship the connections of this worker's queues here
            self._sel.register(srv.worker_ctx.sock, selectors.EVENT_READ, self._ADOPT)
        # the loop thread bills to "dispatch" for its whole life, select
        # included: the sampler reads a thread's CPU ticks as a delta since
        # its last sample, so a sample that lands in select bills the CPU of
        # the pass before it (the waiting samples, the select waits)
        set_stage(TAG_DISPATCH)
        try:
            while not srv._stop.is_set():
                t_sel = time.monotonic()
                events = self._sel.select(self._select_timeout())
                t0 = time.monotonic()
                for key, mask in events:
                    data = key.data
                    if data is self._ACCEPT:
                        self._accept()
                    elif data is self._WAKER:
                        self._drain_waker()
                    elif data is self._ADOPT:
                        self._adopt_conns()
                    else:
                        self._dispatch_conn(data, mask)
                self._fire_timers()
                self._pump_all()
                EVLOOP.loop_pass((time.monotonic() - t0) * 1000.0, (t0 - t_sel) * 1000.0)
        finally:
            self._teardown()
            clear_thread()

    def _dispatch_conn(self, conn: _EvConn, mask: int) -> None:
        try:
            if mask & selectors.EVENT_WRITE:
                conn.flush_out()
            if mask & selectors.EVENT_READ and not conn.closed:
                conn.on_readable()
        except Exception as e:  # noqa: BLE001 (one bad connection must not kill the loop)
            self.kill_conn(conn, e)

    def _accept(self) -> None:
        srv = self._srv
        while True:
            try:
                sock, _ = srv._sock.accept()
            except OSError:  # BlockingIOError included: none left
                return
            if srv.max_conns and len(self._conns) >= srv.max_conns:
                EVLOOP.refused()
                _refuse_conn(sock, srv.port, len(self._conns), srv.max_conns)
                continue
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _EvConn(self, sock, srv)
            self._conns.add(conn)
            EVLOOP.conn_opened()
            with srv._conns_lock:  # shutdown() closes them too
                srv._conns = [c for c in srv._conns if c.fileno() != -1]
                srv._conns.append(sock)
            conn._await_op()
            conn._set_interest(read=True)

    # -- the worker fleet's connection handoff ---------------------------
    def migrate_conn(self, conn: _EvConn, target: int, ctx: dict) -> None:
        """Begin shipping ``conn`` to worker ``target``: pause its reads,
        flush what it has queued, then send the fd and ``ctx`` (with the
        connection's codec and tenant) over the adoption socket."""
        ctx = dict(ctx)
        ctx["codec"] = conn.codec.name if conn.codec is not None else None
        if conn.tenant != _TENANT_DEFAULT or conn.weight != 1:
            ctx["tenant"] = conn.tenant
            ctx["weight"] = conn.weight
        conn._migration = {"target": int(target), "ctx": ctx,
                           "deadline": time.monotonic() + MIGRATE_GRACE_S}
        conn._set_interest(read=False)
        if conn.out:
            conn._set_interest(write=True)  # flush_out ships it once drained
            return
        self._try_migrate(conn)

    def _try_migrate(self, conn: _EvConn) -> None:
        """One handoff attempt. A refusal (the owner respawning, its buffer
        full) retries on a timer within the grace period; past it the
        connection dies with redelivery, and the client's reconnect takes
        over."""
        if conn.closed or conn._migration is None:
            return
        mig = conn._migration
        try:
            self._srv.worker_ctx.send_conn(mig["target"], conn.sock, mig["ctx"])
        except OSError as e:
            now = time.monotonic()
            if now >= mig["deadline"]:
                FLIGHT.record("migrate_gave_up", target=mig["target"],
                              err=e.__class__.__name__)
                self.kill_conn(conn, e, requeue=True)
                return
            if not mig.get("retried"):
                mig["retried"] = True
                FLIGHT.record("migrate_retry", target=mig["target"], err=e.__class__.__name__)
            self._add_timer(now + MIGRATE_RETRY_S, conn, kind="migrate")
            return
        FLIGHT.record("conn_migrated", target=mig["target"], kind=mig["ctx"].get("kind"))
        # the datagram holds its own reference to the fd; nothing is in
        # flight at a migration point, so this close redelivers nothing
        conn._migration = None
        self.kill_conn(conn, None, requeue=False)

    def _adopt_conns(self) -> None:
        """Take the connections sibling workers shipped: rebuild each as
        ``_accept`` would, restore its codec and tenant, then finish the
        routed OPEN or run the opcode the sender read."""
        srv = self._srv
        for sock, ctx in srv.worker_ctx.recv_conns():
            conn = None
            try:
                sock.setblocking(False)
                try:
                    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                except OSError:
                    pass
                conn = _EvConn(self, sock, srv)
                if ctx.get("codec"):
                    conn.codec = negotiate_codec([ctx["codec"]])
                conn.tenant = ctx.get("tenant", _TENANT_DEFAULT)
                try:
                    conn.weight = max(1, min(_TENANT_WEIGHT_MAX, int(ctx.get("weight", 1))))
                except (TypeError, ValueError):
                    conn.weight = 1
                self._conns.add(conn)
                EVLOOP.conn_opened()
                with srv._conns_lock:
                    srv._conns = [c for c in srv._conns if c.fileno() != -1]
                    srv._conns.append(sock)
                FLIGHT.record("conn_adopted", worker=srv.worker_ctx.worker_id,
                              kind=ctx.get("kind"))
                if ctx.get("kind") == "open":
                    conn._open_ns = ctx.get("ns", "")
                    conn.queue = srv.open_named(conn._open_ns, ctx.get("nm", ""),
                                                ctx.get("maxsize") or None)
                    conn._send_control(_ST_OK)
                    conn._await_op()
                else:
                    # the sender read exactly the opcode byte: run it here
                    # (this worker owns the queue, so it cannot route again)
                    conn._hdr[0] = int(ctx.get("op", 0))
                    conn._on_op()
                if not conn.closed:
                    conn._set_interest(read=True)
            except Exception as e:  # noqa: BLE001 (one bad adoption must not kill the loop)
                if conn is not None:
                    self.kill_conn(conn, e)
                else:
                    try:
                        sock.close()
                    except OSError:
                        pass

    def _drain_waker(self) -> None:
        while True:
            try:
                if not self._waker_r.recv_into(self._waker_buf):
                    return
            except OSError:
                return

    def _select_timeout(self) -> float:
        t = IDLE_TICK_S
        if self._timers:
            t = min(t, max(0.0, self._timers[0][0] - time.monotonic()))
        for qs in self._queues.values():
            if qs.get_waiters or qs.put_waiters:
                t = min(t, LISTENED_TICK_S if qs.listened else POLL_TICK_S)
        return t

    def _fire_timers(self) -> None:
        now = time.monotonic()
        while self._timers and self._timers[0][0] <= now:
            deadline, _tie, conn, gen, kind = heapq.heappop(self._timers)
            if kind == "migrate":
                # a handoff retry: a migrating connection has no pending op
                if not conn.closed and conn._migration is not None and not conn.out:
                    self._try_migrate(conn)
                continue
            if conn.closed or conn.pending is None or gen != conn.op_gen:
                continue  # served already or superseded
            if kind == "probe":
                conn._set_interest(read=True)  # the next pass probes again
                continue
            EVLOOP.timer_lag((now - deadline) * 1000.0)
            try:
                if conn.pending["kind"] == "D":
                    # one last look, then the (maybe empty) answer
                    try:
                        items = conn._read_batch(conn.pending["max_items"])
                    except TransportClosed:
                        conn._send_control(_ST_CLOSED)
                    else:
                        conn._respond_batch(items)
                    conn.unpark()
                elif conn.pending["kind"] == "U":
                    conn._send_control(_ST_NO)
                    conn.unpark()
                # "W" has no deadline: backpressure, not a timeout
            except OSError as e:  # ConnectionError included
                self.kill_conn(conn, e)

    # -- the pump -------------------------------------------------------
    def _pump_all(self) -> None:
        for qs in list(self._queues.values()):
            if not (qs.get_waiters or qs.put_waiters or qs.ra_waiters):
                continue
            try:
                while self._pump_get(qs) | self._pump_put(qs) | self._pump_rack(qs):
                    pass
            except _QueueClosedSignal:
                self._queue_closed(qs)

    def _pump_get(self, qs: _QueueState) -> bool:
        gw = qs.get_waiters
        if not gw:
            return False
        # a depth check first: the pump runs every pass. size() answers 0 on
        # a closed ring, so closed is checked on its own (streams must see 'X')
        replaying = any(c.replay is not None for c in gw if not c.closed)
        try:
            if getattr(qs.queue, "closed", False):
                raise _QueueClosedSignal
            # replay waiters read the log, not the queue
            if not qs.queue.size() and not replaying:
                return False
        except TransportClosed:
            raise _QueueClosedSignal from None
        weights, n_stream = _stream_tenant_weights(gw)
        if weights and qs.wdrr.all_dry(weights):
            qs.wdrr.replenish(weights, n_stream)
        did = False
        visits = len(gw)
        # streams skipped only for their tenant's spent deficit: if that is
        # all that stopped the pass, a new round starts
        blocked_on_allowance = False
        while visits and gw:
            visits -= 1
            conn = gw[0]
            if conn.closed:
                gw.popleft()
                continue
            if conn.replay is not None:
                # a replay waiter (a parked 'D'): served from its cursor
                if conn.pending is None or conn.pending.get("kind") != "D":
                    gw.popleft()
                    continue
                items = conn.replay.next_batch(conn.pending["max_items"])
                if not items:
                    gw.rotate(-1)  # caught up: its timer answers empty
                    continue
                try:
                    conn._respond_batch(items)
                    gw.popleft()
                    conn.unpark()
                except OSError as e:
                    self.kill_conn(conn, e)
                did = True
                continue
            if conn.stream is not None:
                allow = qs.wdrr.allowance(conn.tenant)
                if allow < 1.0:
                    blocked_on_allowance = True
                    gw.rotate(-1)
                    continue
                # a quantum a visit, so connections of one tenant split its round
                want = min(conn.stream.budget(), _STREAM_POP_MAX, int(allow),
                           _WDRR_QUANTUM * conn.weight)
                if want <= 0:
                    gw.rotate(-1)  # window full: wait for credit
                    continue
            elif conn.pending is not None and conn.pending.get("kind") == "D":
                want = conn.pending["max_items"]
            else:
                gw.popleft()  # answered by a timer
                continue
            try:
                items = qs.queue.get_batch(min(want, 4096), timeout=0.0)
            except TransportClosed:
                raise _QueueClosedSignal from None
            except Exception as e:  # noqa: BLE001 (a corrupt spill read errs this waiter only)
                gw.popleft()
                try:
                    conn._send_control(_ST_ERR)
                    if conn.stream is None:
                        conn.unpark()
                except OSError:
                    self.kill_conn(conn, e)
                did = True
                continue
            if not items:
                if replaying:
                    gw.rotate(-1)  # replay waiters behind may still be served
                    continue
                break  # empty: every remaining waiter waits
            try:
                if conn.stream is not None:
                    qs.wdrr.charge(conn.tenant, len(items))
                    conn.push_stream_items(items)
                    gw.rotate(-1)  # round robin across streams
                else:
                    conn._respond_batch(items)
                    gw.popleft()
                    conn.unpark()
            except OSError as e:  # died with items popped: they redeliver
                self.kill_conn(conn, e)
            did = True
        if not did and blocked_on_allowance:
            # frames wait but every stream that could take them had spent
            # its deficit: force a round (reporting progress re-runs the pump)
            weights, n_stream = _stream_tenant_weights(gw)
            qs.wdrr.replenish(weights, n_stream)
            did = bool(weights)
        return did

    def _pump_put(self, qs: _QueueState) -> bool:
        did = False
        pw = qs.put_waiters
        while pw:
            conn = pw[0]
            if conn.closed or conn.pending is None or conn.pending.get("kind") not in ("U", "W"):
                pw.popleft()
                continue
            try:
                ok, offset = _put_offset(qs.queue, conn.pending["item"])
            except TransportClosed:
                raise _QueueClosedSignal from None
            except Exception as e:  # noqa: BLE001 (answer this one, keep the loop)
                pw.popleft()
                try:
                    conn._send_control(_ST_ERR)
                    conn.unpark()
                except OSError:
                    self.kill_conn(conn, e)
                did = True
                continue
            if not ok:
                break  # still full: nobody behind may jump the line
            pw.popleft()
            windowed = conn.pending["kind"] == "W"
            reply = _ST_OK + struct.pack("<Q", conn.pending["seq"]) if windowed else _ST_OK
            try:
                # the answer may wait on the replicated ack floor now
                conn._answer_put(reply, offset, pipelined=windowed, parked=True)
            except OSError as e:
                self.kill_conn(conn, e)
            did = True
        return did

    def _pump_rack(self, qs: _QueueState) -> bool:
        """Send the held answers whose offsets the follower has logged (all
        of them once the sender degraded)."""
        did = False
        for conn in list(qs.ra_waiters):
            if not conn.closed:
                try:
                    did |= conn.release_held(qs.repl)
                except Exception as e:  # noqa: BLE001 (a failing waiting op kills its conn only)
                    self.kill_conn(conn, e)
            if conn.closed or not conn.held:
                qs.ra_waiters.remove(conn)
        return did

    def _queue_closed(self, qs: _QueueState) -> None:
        """The queue closed mid-pump: every waiter gets 'X' (bounded waits
        resume the connection; streams end)."""
        while qs.get_waiters:
            conn = qs.get_waiters.popleft()
            if conn.closed:
                continue
            try:
                conn._send_control(_ST_CLOSED)
                if conn.stream is not None:
                    conn.stream.queue_closed = True
                    conn._finish_stream(clean=False)
                    conn._begin_close()
                else:
                    conn.unpark()
            except OSError as e:
                self.kill_conn(conn, e)
        while qs.put_waiters:
            conn = qs.put_waiters.popleft()
            if conn.closed or conn.pending is None:
                continue
            try:
                conn._send_control(_ST_CLOSED)
                conn.unpark()
            except OSError as e:
                self.kill_conn(conn, e)
        while qs.ra_waiters:
            # their frames were logged before the close: the true answer
            # goes now, not against a floor that may never move
            conn = qs.ra_waiters.popleft()
            if conn.closed:
                continue
            try:
                conn.release_held(None)
            except OSError as e:
                self.kill_conn(conn, e)

    def _teardown(self) -> None:
        for conn in list(self._conns):
            # stopping: in-flight and unacked deliveries go back to their queues
            self.kill_conn(conn, None, requeue=True)
        for qs in self._queues.values():
            if qs.unlisten is not None:
                try:
                    qs.unlisten()
                except Exception:
                    pass
        for s in (self._waker_r, self._waker_w):
            try:
                self._sel.unregister(s)
            except (KeyError, ValueError, OSError):
                pass
            try:
                s.close()
            except OSError:
                pass
        try:
            self._sel.unregister(self._srv._sock)
        except (KeyError, ValueError, OSError):
            pass
        self._sel.close()
