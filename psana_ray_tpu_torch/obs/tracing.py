"""Sampled per-frame distributed tracing across the pipeline's processes.

The port's copy of ``psana_ray_tpu/obs/tracing.py``: where did this frame
spend its time, across producer, queue server, consumer and card.

- :class:`TraceContext`: trace id, sample flag, origin host and pid, the
  25 bytes (``<QIB12s``) a sampled frame carries on the wire as schema v3;
  an unsampled frame stays v2, byte for byte the untraced format.
- :class:`Tracer`: the process's span sink. Each process appends spans
  (producer: ``produce``/``enqueue``; queue server: ``queue_dwell``/
  ``relay``; consumer: ``dequeue``/``batch``/``device_put``/``dispatch``,
  the boundaries of :mod:`psana_ray_tpu_torch.obs.stages`) to a bounded
  JSONL spool, with ``(wall, monotonic)`` clock anchors and peer anchors
  (the TCP opcode 'A') from which :mod:`~psana_ray_tpu_torch.obs.
  trace_merge` puts the processes on one timeline.

The spool lines, the sampling sequence and the trace ids are the JAX
package's, so either package's ``trace_merge`` reads the other's spools.
Pure stdlib. A sampled frame's span costs one lock and one small list
append; the spool is flushed every ``FLUSH_EVERY`` lines and at exit.
"""

from __future__ import annotations

import atexit
import dataclasses
import itertools
import json
import os
import socket
import struct
import threading
import time
from typing import Any, Dict, Optional

__all__ = [
    "TraceContext",
    "Tracer",
    "TRACER",
    "TRACE_KEY",
    "SPAN_PRODUCE",
    "SPAN_RELAY",
    "add_trace_args",
    "configure_from_args",
    "emit_batch_spans",
    "exchange_anchors",
    "obs_status_suffix",
]

# the key in a record's ``hops`` dict that carries the trace id through
# the batching path (stage observation walks the HOP_* names only)
TRACE_KEY = "trace_id"

SPAN_PRODUCE = "produce"  # instant: source read done
SPAN_RELAY = "relay"  # queue server: response serialization + send

_FLAG_SAMPLED = 0x01

# trace_id:u64, origin_pid:u32, flags:u8, origin_host:12s (utf-8, padded)
_CTX_WIRE = struct.Struct("<QIB12s")


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """A frame's trace context, carried in the record's v3 header."""

    trace_id: int
    sampled: bool = True
    origin_host: str = ""
    origin_pid: int = 0

    WIRE_SIZE = _CTX_WIRE.size  # 25 bytes, on sampled frames only

    def pack(self) -> bytes:
        flags = _FLAG_SAMPLED if self.sampled else 0
        host = self.origin_host.encode("utf-8", "replace")[:12]
        return _CTX_WIRE.pack(self.trace_id & 0xFFFFFFFFFFFFFFFF,
                              self.origin_pid & 0xFFFFFFFF, flags, host)

    @staticmethod
    def unpack_from(buf, offset: int) -> "TraceContext":
        trace_id, pid, flags, host = _CTX_WIRE.unpack_from(buf, offset)
        return TraceContext(
            trace_id=trace_id,
            sampled=bool(flags & _FLAG_SAMPLED),
            origin_host=host.rstrip(b"\0").decode("utf-8", "replace"),
            origin_pid=pid,
        )


# spool lines (one JSON object each): m = meta, a = clock anchor,
# p = peer anchor, s = span, i = instant
FLUSH_EVERY = 128


class Tracer:
    """The process's span sink with a bounded JSONL spool. Disabled (the
    default) every surface is one attribute check; enabled,
    :meth:`maybe_trace` allocates nothing for an unsampled frame."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._every = 0  # sample 1 frame in N; 0 = off
        # itertools.count.__next__ is atomic in CPython: concurrent shard
        # threads get unique frame numbers without a lock
        self._ticker = itertools.count(1)
        self._count = 0  # the latest frame number, a gauge
        self._id_base = 0
        self._host = socket.gethostname()
        self._pid = os.getpid()
        self._process = ""
        self._path: Optional[str] = None
        self._f = None  # guarded-by: _lock
        self._buf: list = []  # guarded-by: _lock
        self._spans = 0  # guarded-by: _lock
        self._drops = 0  # guarded-by: _lock
        self._max_spans = 0
        self._by_name: Dict[str, int] = {}  # guarded-by: _lock
        self._atexit_registered = False

    def configure(
        self,
        spool_dir: str,
        sample_every: int = 100,
        process: str = "proc",
        max_spans: int = 200_000,
    ) -> "Tracer":
        """Sample 1 frame in ``sample_every`` and spool to ``spool_dir``
        (closing any previous spool). Past ``max_spans`` spans are dropped
        and counted, never blocking the pipeline."""
        if sample_every <= 0:
            raise ValueError("sample_every must be >= 1 (frames per sample)")
        with self._lock:
            self._close_locked()
            os.makedirs(spool_dir, exist_ok=True)
            self._process = process
            self._pid = os.getpid()
            self._every = int(sample_every)
            self._ticker = itertools.count(1)
            self._count = 0
            self._spans = 0
            self._drops = 0
            self._by_name = {}
            self._max_spans = max_spans
            # ids unique across processes: the pid in the top bits, a
            # sub-second wall-clock salt against quick restarts
            salt = int(time.time() * 1e6) & 0xFFFFF
            self._id_base = ((self._pid & 0xFFFFFFFF) << 28) ^ (salt << 8)
            self._path = os.path.join(spool_dir,
                                      f"{process}-{self._host}-{self._pid}.trace.jsonl")
            self._f = open(self._path, "w", encoding="utf-8")
            self._buf = [self._line(t="m", process=process, host=self._host, pid=self._pid,
                                    every=self._every, start_wall=time.time(),
                                    start_mono=time.monotonic())]
            self._anchor_locked()
            self._flush_locked()
            self.enabled = True
            if not self._atexit_registered:
                self._atexit_registered = True
                atexit.register(self.close)
        return self

    @property
    def spool_path(self) -> Optional[str]:
        return self._path

    @property
    def sample_every(self) -> int:
        return self._every

    def maybe_trace(self) -> Optional[TraceContext]:
        """The per-frame sampling gate: None for an unsampled frame (counter
        arithmetic only), a fresh :class:`TraceContext` for a sampled one.
        The rate is read once, so a concurrent ``close()`` never divides by
        zero."""
        if not self.enabled:
            return None
        every = self._every
        if every <= 0:  # racing a close()
            return None
        n = next(self._ticker)
        self._count = n
        if n % every:
            return None
        return TraceContext(
            trace_id=(self._id_base + n) & 0xFFFFFFFFFFFFFFFF,
            sampled=True,
            origin_host=self._host,
            origin_pid=self._pid,
        )

    def span(self, trace_id: int, name: str, t0: float, t1: float) -> None:
        """One span ``[t0, t1]`` in this process's monotonic clock."""
        if not self.enabled:
            return
        self._emit(name, self._line(t="s", id=trace_id, n=name, a=t0, b=t1))

    def instant(self, trace_id: int, name: str, t: float) -> None:
        """A zero-length marker (``produce`` at source read done)."""
        if not self.enabled:
            return
        self._emit(name, self._line(t="i", id=trace_id, n=name, a=t))

    def _emit(self, name: str, line: str) -> None:
        with self._lock:
            if self._spans >= self._max_spans:
                self._drops += 1
                return
            self._spans += 1
            self._by_name[name] = self._by_name.get(name, 0) + 1
            self._buf.append(line)
            if len(self._buf) >= FLUSH_EVERY:
                self._anchor_locked()
                self._flush_locked()

    def write_anchor(self) -> None:
        """Record a ``(wall, monotonic)`` pair; the merge takes the median
        of these as the process's clock offset."""
        if not self.enabled:
            return
        with self._lock:
            self._anchor_locked()

    def record_peer_anchor(self, exchange: dict) -> None:
        """Record one clock exchange with the queue server (the send and
        receive times around the server's ``(wall, mono)``): the merge
        aligns this process to the server's clock across hosts."""
        if not self.enabled:
            return
        with self._lock:
            self._buf.append(self._line(t="p", **exchange))

    def _anchor_locked(self) -> None:
        # guarded-by-caller: _lock
        self._buf.append(self._line(t="a", wall=time.time(), mono=time.monotonic()))

    @staticmethod
    def _line(**kw) -> str:
        return json.dumps(kw, separators=(",", ":"))

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        # guarded-by-caller: _lock
        if self._f is None or not self._buf:
            self._buf = self._buf if self._f is not None else []
            return
        self._f.write("\n".join(self._buf) + "\n")
        self._f.flush()
        self._buf = []

    def close(self) -> None:
        """Flush and close the spool, and disable; idempotent (atexit)."""
        with self._lock:
            self._close_locked()

    def _close_locked(self) -> None:
        # guarded-by-caller: _lock
        if self._f is not None:
            self._anchor_locked()
            self._flush_locked()
            try:
                self._f.close()
            except OSError:
                pass
        self._f = None
        self.enabled = False
        self._every = 0

    def snapshot(self) -> dict:
        """Registry source: on or off, the rate, the spans."""
        with self._lock:
            out: Dict[str, Any] = {
                "enabled": self.enabled,
                "sample_every": self._every,
                "frames_seen_total": self._count,
                "spans_total": self._spans,
                "spans_dropped_total": self._drops,
            }
            if self._by_name:
                out["spans_by_name"] = dict(self._by_name)
        return out

    def status_suffix(self, flight=None) -> str:
        """The heartbeat line's suffix: rate, spans, the flight recorder's
        event count; empty while tracing is off."""
        if not self.enabled:
            return ""
        with self._lock:
            every, spans, drops = self._every, self._spans, self._drops
        suffix = f" trace[1/{every} spans={spans}"
        if drops:
            suffix += f" drops={drops}"
        suffix += "]"
        if flight is not None:
            suffix += f" flight={flight.event_count}"
        return suffix


#: The process's tracer, which every program configures.
TRACER = Tracer()


def emit_batch_spans(batch, t_end: float, tracer: Optional[Tracer] = None) -> None:
    """Consumer-side spans of one batch: each traced record's hop stamps
    (``TRACE_KEY`` marks it) become per-stage spans, the last ending at
    ``t_end`` (step done); the walk of
    :func:`~psana_ray_tpu_torch.obs.stages.observe_record_stages`, so spans
    and histograms share their boundaries. The enqueue leg is the
    producer's span and is not repeated here."""
    tr = TRACER if tracer is None else tracer
    if not tr.enabled:
        return
    hops_list = getattr(batch, "hops", None)
    if not hops_list:
        return
    from psana_ray_tpu_torch.obs.stages import HOPS, STAGE_DISPATCH, STAGE_ENQUEUE, STAGES

    for hops in hops_list:
        tid = hops.get(TRACE_KEY)
        if tid is None:
            continue
        prev = None
        for i, hop in enumerate(HOPS):
            t = hops.get(hop)
            if t is None:
                continue
            if prev is not None and STAGES[i - 1] != STAGE_ENQUEUE:
                tr.span(tid, STAGES[i - 1], prev, t)
            prev = t
        if prev is not None:
            tr.span(tid, STAGE_DISPATCH, prev, t_end)


def exchange_anchors(queue, n: int = 3, tracer: Optional[Tracer] = None) -> int:
    """``n`` clock exchanges over a handle with the anchor RPC
    (``TcpQueueClient.anchor``), spooled; returns how many succeeded (0
    for transports without it: in-process and shm share the clock)."""
    tr = TRACER if tracer is None else tracer
    anchor = getattr(queue, "anchor", None)
    if not tr.enabled or anchor is None:
        return 0
    done = 0
    for _ in range(n):
        try:
            tr.record_peer_anchor(anchor())
            done += 1
        except Exception:  # noqa: BLE001 (alignment is best effort)
            break
    return done


def add_trace_args(parser) -> None:
    """``--trace_dir``, ``--trace_sample`` and ``--flight_dir``, the JAX
    package's flags."""
    parser.add_argument(
        "--trace_dir", default=None,
        help="enable sampled per-frame distributed tracing: spool spans to this directory "
             "(one JSONL file a process); merge with `python -m "
             "psana_ray_tpu_torch.obs.trace_merge <dir>` and open the result in Perfetto. "
             "Default off (zero cost)",
    )
    parser.add_argument(
        "--trace_sample", type=int, default=100,
        help="sample 1 frame in N for tracing (1 = every frame); only with --trace_dir",
    )
    parser.add_argument(
        "--flight_dir", default=None,
        help="flight recorder: dump the event ring, a metrics snapshot and the thread "
             "stacks here on a stall, an unhandled exception or SIGUSR2 (default: "
             "--trace_dir when set, else off)",
    )


def configure_from_args(args, process: str, queue=None) -> Optional[Tracer]:
    """Configure the process's tracer and flight recorder from the
    ``add_trace_args`` flags and register both (``trace``, ``flight``) as
    metrics sources; ``queue`` (a TCP client) seeds the clock alignment
    with peer anchors. Returns the tracer, or None when tracing is off."""
    trace_dir = getattr(args, "trace_dir", None)
    flight_dir = getattr(args, "flight_dir", None) or trace_dir
    out = None
    if trace_dir:
        TRACER.configure(trace_dir, sample_every=max(1, args.trace_sample), process=process)
        out = TRACER
    from psana_ray_tpu_torch.obs.flight import FLIGHT

    if flight_dir:
        FLIGHT.install(flight_dir, process=process)
    if trace_dir or flight_dir:
        from psana_ray_tpu_torch.obs.registry import MetricsRegistry

        reg = MetricsRegistry.default()
        if trace_dir:
            reg.register("trace", TRACER)
        reg.register("flight", FLIGHT)
    if out is not None and queue is not None:
        exchange_anchors(queue)
    return out


def obs_status_suffix() -> str:
    """The heartbeat suffix of the process's tracer and flight recorder,
    plus a ``durable[...]`` bracket once any durable-storage breadcrumb
    fired here (segment rollover, spill, recovery, torn tail, replay);
    empty otherwise."""
    from psana_ray_tpu_torch.obs.flight import FLIGHT

    out = TRACER.status_suffix(FLIGHT)
    rolls = FLIGHT.count_of("segment_rollover")
    spills = FLIGHT.count_of("spill_enter")
    recoveries = FLIGHT.count_of("recovery_scan", "durable_reexpose")
    torn = FLIGHT.count_of("torn_tail_repair")
    replays = FLIGHT.count_of("replay_open", "replay_gap")
    if rolls or spills or recoveries or torn or replays:
        out += (f" durable[roll={rolls} spill={spills} recover={recoveries}"
                f" torn={torn} replay={replays}]")
    return out
