"""Reviewed exceptions to the project invariants — with justifications.

Every entry excuses ONE (checker, file-suffix, line-substring) match and
must carry a written ``why``. The framework turns unused entries into
``allowlist-rot`` findings on full runs (generalizing the ``stale``
assert the original hot-path screen of the test suite shipped with):
when the excused code changes or disappears, the entry fails the run
until it is deleted — an allowlist that can only grow would
eventually hide a real finding behind a dead excuse.

Adding an entry is a REVIEW event, not an escape hatch: the ``why`` must
say what bounds the excused behavior (a deadline, a byte count, a
lifecycle contract), because that bound is exactly what the static
checker could not see.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Allow:
    checker: str  # checker name the entry excuses
    file: str  # repo-relative path suffix
    contains: str  # substring of the flagged source line
    why: str  # REQUIRED written justification

    def __post_init__(self):
        if not self.why.strip():
            raise ValueError(
                f"allowlist entry for {self.file!r}/{self.contains!r} has no "
                f"justification — every excuse must say why it is safe"
            )


ALLOWLIST = (
    # -- hot-alloc: reviewed, size-bounded uses on the listed hot files -----
    Allow(
        "hot-alloc", "transport/tcp.py", "return bytes(buf)",
        why="_recv_exact materializes CONTROL fields only: status bytes, "
        "lengths and offsets (<=16 bytes), and the length-prefixed codec "
        "names and JSON control replies (one per RPC, never per frame); "
        "frame payloads go through _recv_into on a pooled lease",
    ),
    Allow(
        "hot-alloc", "transport/codec.py", "return [TAG_RECORD + item.to_bytes()]",
        why="EndOfStream wire form is header-only (tens of bytes), not a frame",
    ),
    Allow(
        "hot-alloc", "transport/codec.py", "return TAG_RECORD + item.to_bytes()",
        why="legacy contiguous encode_payload kept for back-compat callers "
        "OFF the hot path; the hot path uses encode_payload_parts",
    ),
    Allow(
        "hot-alloc", "transport/codec.py", "tag = bytes(buf[:1])",
        why="1-byte tag peek; copying a single byte is not a frame-sized alloc",
    ),
    Allow(
        "hot-alloc", "transport/shm_ring.py", "if bytes(mv[:1]) == TAG_VOID:",
        why="1-byte void-marker peek on the slot view: one byte copied, "
        "never a frame",
    ),
    Allow(
        "hot-alloc", "records.py", "return header + payload.tobytes()",
        why="legacy FrameRecord.to_bytes kept for back-compat callers off "
        "the hot path (codec.encode_payload); wire_parts() is the "
        "zero-copy replacement every transport sends from",
    ),
    Allow(
        "hot-alloc", "records.py", "data = item.to_bytes()  # header-only, tiny",
        why="encode_into EOS arm: header-only marker, tens of bytes",
    ),
    # -- lease-lifecycle --------------------------------------------------
    Allow(
        "lease-lifecycle", "transport/codec.py",
        "dst_lease = pool.lease(panel_nbytes) if pool is not None else None",
        why="LazyFrameRecord inflate: the lease is released in the "
        "except-reraise arm on any decompress failure (which validate() "
        "already proved impossible) and otherwise RETURNED to the panels "
        "property, which attaches it to the record (frozen dataclass -> "
        "object.__setattr__); record.release()/GC returns it. The "
        "conditional-expression form hides the transfer from the checker",
    ),
    # -- thread-hygiene ---------------------------------------------------
    Allow(
        "thread-hygiene", "psana_ray_tpu_torch/producer.py",
        "threading.Thread(target=self._pump",
        why="foreground shard pumps: run(block=True)/join() block on them "
        "by CONTRACT and each pump exits at EOS or stop(); deliberately "
        "non-daemon so an early main-thread exit cannot kill in-flight "
        "shard streaming mid-frame (the CLI's whole job is those pumps)",
    ),
    # -- blocking-hot-path: deadline-bounded poll backoffs the static
    # call-graph cannot prove bounded ------------------------------------
    Allow(
        "blocking-hot-path", "infeed/batcher.py",
        "time.sleep(max(poll_s, 0.02))",
        why="the competing-consumer livelock fix: a deliberate scheduler "
        "yield after returning sibling EOS markers, taken only when "
        "starved, bounded by poll_interval — removing it re-opens the "
        "60+ s EOS livelock (EosTally.flush_duplicates docstring)",
    ),
    Allow(
        "blocking-hot-path", "transport/shm_ring.py", "time.sleep(0.0002)",
        why="_get_batch first-item poll: the caller's timeout deadline is "
        "re-checked before every sleep, so total blocking is caller-bounded",
    ),
    Allow(
        "blocking-hot-path", "transport/shm_ring.py", "time.sleep(poll_s)",
        why="put_wait/get_wait poll backoff: deadline-checked every "
        "iteration; poll_s and timeout are caller-supplied bounds",
    ),
    # -- blocking-hot-path + event-loop-blocking: the worker fleet's
    # supervisor, reached from the drain loops and the event loop only
    # through name-resolved start()/close() edges --------------------------
    Allow(
        "blocking-hot-path", "transport/workers.py", "time.sleep(0.5)",
        why="crash-loop pause in the FORKED CHILD only (the pid == 0 "
        "branch, before the worker builds its loop): 0.5 s once per "
        "respawn of a worker that died within 1 s of its start; the "
        "parent's supervisor, drain loops and event loop never run it",
    ),
    Allow(
        "event-loop-blocking", "transport/workers.py", "time.sleep(0.5)",
        why="crash-loop pause in the FORKED CHILD only (the pid == 0 "
        "branch, before the child's own event loop exists): 0.5 s once "
        "per respawn; no parent thread runs it",
    ),
    Allow(
        "blocking-hot-path", "transport/workers.py", "time.sleep(_REAP_TICK_S)",
        why="WorkerSupervisor.stop's reap poll: 50 ms ticks, deadline-"
        "checked every iteration and bounded by timeout_s (the fleet "
        "parent passes drain_s + 10 s), after which every survivor gets "
        "SIGKILL; stop runs once, at the fleet's teardown, never per frame",
    ),
    Allow(
        "event-loop-blocking", "transport/workers.py", "time.sleep(_REAP_TICK_S)",
        why="WorkerSupervisor.stop's reap poll at teardown: 50 ms ticks "
        "bounded by timeout_s (drain_s + 10 s), then SIGKILL; its one "
        "caller is the fleet parent of queue_server, which runs no event "
        "loop (each worker runs its own), so no connection waits on it",
    ),
    # -- lockset-inference: deliberate lock-free fast paths. Every entry
    # pins a FIELD (the finding anchors at its first store, i.e. the
    # __init__ declaration line), and every justification names what
    # bounds the race — the bar the checker's hint sets. ----------------
    Allow(
        "lockset-inference", "obs/tracing.py", "self.enabled = False",
        why="the tracing on/off gate maybe_trace()/span() read bare — "
        "the documented lock-free hot path (disabled = ONE attribute "
        "check); a frame straddling configure()/close() is at worst "
        "sampled into a spool that is already flushing (maybe_trace "
        "docstring), never an error",
    ),
    Allow(
        "lockset-inference", "obs/tracing.py", "self._every = 0",
        why="sample rate read ONCE per frame in maybe_trace without the "
        "lock; the <=0 re-check after the read makes a racing close() "
        "a clean 'tracing over', never a divide-by-zero (documented in "
        "maybe_trace)",
    ),
    Allow(
        "lockset-inference", "obs/tracing.py", "self._ticker = itertools.count(1)",
        why="itertools.count.__next__ is atomic in CPython — the whole "
        "point of the field: unique frame numbers across producer shard "
        "threads WITHOUT a hot-path lock (declaration comment)",
    ),
    Allow(
        "lockset-inference", "obs/tracing.py", "self._count = 0",
        why="best-effort gauge of the latest ticker value for snapshot() "
        "only (declaration comment says so); a stale read is a stale "
        "status line, not state corruption",
    ),
    Allow(
        "lockset-inference", "obs/tracing.py", "self._id_base = 0",
        why="trace-id base read bare in maybe_trace: written only by "
        "configure() under the lock; a frame racing a reconfigure gets "
        "ids from one epoch or the other, both globally unique (pid+salt "
        "in the top bits)",
    ),
    Allow(
        "lockset-inference", "obs/tracing.py", "self._pid = os.getpid()",
        why="process id: rewritten only by configure() (post-fork "
        "correction) under the lock; bare reads can only see a stable "
        "value for the life of the process",
    ),
    Allow(
        "lockset-inference", "obs/tracing.py", "self._path: Optional[str] = None",
        why="spool path: written under the lock in configure(); the bare "
        "spool_path property is a status probe whose stale read names "
        "the previous spool file — acceptable for its one caller "
        "(--status_interval logging)",
    ),
    Allow(
        "lockset-inference", "transport/tcp.py",
        "self._binding: Optional[tuple] = None",
        why="written under the lock (open/_reconnect); the one bare read "
        "is _side_channel's replay of the binding, which races only a "
        "concurrent rebind of the SAME client — the side channel would "
        "open the old queue, exactly what an in-flight op on the old "
        "binding is allowed to do (tuple assignment is atomic; no torn "
        "read)",
    ),
    Allow(
        "lockset-inference", "transport/tcp.py",
        'self._stream: Optional["TcpStreamReader"] = None',
        why="mode-routing fast path: every public op reads _stream bare "
        "to decide stream-vs-side-channel BEFORE taking the lock. The "
        "field transitions None->reader exactly once under the lock "
        "(stream_open), so a stale None routes to the request/response "
        "path that was correct a moment ago; the reader object itself "
        "is only ever used under the lock",
    ),
    # -- event-loop-blocking: shm backing branches that are dead under the
    # arguments the loop actually passes ---------------------------------
    Allow(
        "event-loop-blocking", "transport/shm_ring.py", "time.sleep(0.0002)",
        why="_get_batch first-item poll: the event loop only ever calls "
        "get_batch(timeout=0.0) (pump + timer-expiry paths), so the "
        "deadline is pre-expired and the sleep branch is unreachable "
        "from the loop; bounded-wait 'D' service is timer state, not a "
        "blocking pop",
    ),
    Allow(
        "event-loop-blocking", "transport/shm_ring.py", "time.sleep(poll_s)",
        why="ShmRingBuffer.put_wait reached only through the recovery "
        "requeue (return_to_queue) for backings WITHOUT put_front — and "
        "EventLoop.requeue_items hands exactly that case to a bounded "
        "daemon helper thread, so the loop thread never runs this branch",
    ),
)
