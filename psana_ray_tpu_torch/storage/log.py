"""SegmentLog: an offset-addressed, append-only record log over a ring of
recycled mmap'd segments, with committed offsets and crash recovery.

The port's copy of ``psana_ray_tpu/storage/log.py``; the directory
layout and both files' formats are the JAX package's. One log backs one
queue (``DurableRingBuffer``). Records get increasing offsets at append;
consumers' positions are committed offsets kept in a small sidecar file,
so a restart re-exposes exactly ``(committed, tail]``: at least once
across process death, duplicates possible (what was delivered after the
last commit comes again), holes never.

Layout of a log directory::

    seg-<base_offset>.seg     pre-allocated mmap'd segments (storage.segment)
    offsets.jsonl             committed offsets per consumer group (JSON
                              lines, compacted in place when large; a torn
                              last line from a crash is ignored)

``fsync`` policy:

- ``none``: never fsync. Survives process death (``kill -9``): the mapped
  writes live in the page cache, which outlives the process. A machine
  crash may lose the unflushed tail (the producer's windowed-put resend
  is the backstop there);
- ``batch``: fsync the active segment every ``fsync_batch_n`` appends, on
  a roll and on every commit. A machine crash loses at most one batch;
- ``always``: fsync after every append.

Retention: segments whose every record lies below the live committed
floor (group ``""``, the queue's own consumption) are kept until more
than ``retain_segments`` sealed segments of consumed history exist, then
recycled (scrubbed and renamed to the new tail, never deleted and
allocated again). Unconsumed records are never recycled, whatever their
count, so disk use is bounded by the queued backlog plus
``retain_segments`` of replayable history.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from psana_ray_tpu_torch.storage.segment import (
    Segment,
    parse_base_offset,
    record_nbytes,
    segment_filename,
)
from psana_ray_tpu_torch.obs.flight import FLIGHT
from psana_ray_tpu_torch.storage.telemetry import DURABLE
from psana_ray_tpu_torch.transport.codec import decode_payload

FSYNC_NONE = "none"
FSYNC_BATCH = "batch"
FSYNC_ALWAYS = "always"
FSYNC_POLICIES = (FSYNC_NONE, FSYNC_BATCH, FSYNC_ALWAYS)

DEFAULT_SEGMENT_BYTES = 64 * 1024 * 1024
DEFAULT_RETAIN_SEGMENTS = 8
DEFAULT_FSYNC_BATCH_N = 64

# replay-open position sentinels (u64 on the wire, 'R')
REPLAY_BEGIN = (1 << 64) - 1  # the earliest retained offset
REPLAY_RESUME = (1 << 64) - 2  # this group's committed offset + 1

# commit sentinel ('J'): commit everything the server has delivered to this
# connection's replay cursor so far (the client never learns raw offsets)
COMMIT_DELIVERED = (1 << 64) - 1

_OFFSETS_FILE = "offsets.jsonl"
_OFFSETS_COMPACT_BYTES = 64 * 1024
# retired segments kept mapped for reuse before they are unlinked: the free
# list that makes a roll one rename
_FREE_SEGMENTS_MAX = 2

# the process's disk-fault hook: called with the operation's name ("append"
# or "sync") before the segment write or flush; an OSError it raises stands
# for a failing or full disk. The log then fails that append or sync (the
# queue server answers the producer 'E') and counts it, and the serving
# loop lives on
_DISK_FAULT_HOOK = None


def set_disk_fault_hook(hook) -> None:
    """Install (or clear, with None) the process-wide disk-fault hook."""
    global _DISK_FAULT_HOOK
    _DISK_FAULT_HOOK = hook


def _disk_fault_check(op: str) -> None:
    hook = _DISK_FAULT_HOOK
    if hook is not None:
        hook(op)


class SegmentLog:
    """See the module docstring. Thread-safe behind one lock."""

    def __init__(self, dirpath: str, segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 retain_segments: int = DEFAULT_RETAIN_SEGMENTS, fsync: str = FSYNC_BATCH,
                 fsync_batch_n: int = DEFAULT_FSYNC_BATCH_N, name: str = "queue"):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"fsync must be one of {FSYNC_POLICIES}, got {fsync!r}")
        self.dir = dirpath
        self.name = name
        self.segment_bytes = int(segment_bytes)
        self.retain_segments = max(1, int(retain_segments))
        self.fsync = fsync
        self.fsync_batch_n = max(1, int(fsync_batch_n))
        self._lock = threading.RLock()
        self._segments: List[Segment] = []  # oldest .. active  # guarded-by: _lock
        self._free: List[Segment] = []  # retired, awaiting reuse  # guarded-by: _lock
        self._committed: Dict[str, int] = {}  # group -> offset  # guarded-by: _lock
        self._next_offset = 0  # guarded-by: _lock
        self._appends_since_sync = 0  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        self._free_id = 0  # guarded-by: _lock
        self.torn_tail_repaired = False
        self.recovered_records = 0
        self.recovery_ms = 0.0
        os.makedirs(dirpath, exist_ok=True)
        with self._lock:
            self._recover()

    # -- recovery ----------------------------------------------------------
    def _recover(self) -> None:
        """The boot scan: load the committed offsets, walk every segment in
        base-offset order checking its records, cut a torn tail and resume
        appends after the last valid record."""
        # guarded-by-caller: _lock
        t0 = time.monotonic()
        self._committed = _load_offsets(os.path.join(self.dir, _OFFSETS_FILE))
        for n in os.listdir(self.dir):
            # a crash can leave retired (scrubbed, renamed) segments: empty
            if n.startswith("free-") and n.endswith(".seg"):
                try:
                    os.unlink(os.path.join(self.dir, n))
                except OSError:
                    pass
        names = sorted(n for n in os.listdir(self.dir) if parse_base_offset(n) is not None)
        torn = False
        records = 0
        next_offset = 0
        for fname in names:
            base = parse_base_offset(fname)
            if not self._segments:
                next_offset = base
            seg = Segment.open_existing(os.path.join(self.dir, fname), base)
            try:
                seg_next, seg_torn = seg.scan(next_offset)
            except BaseException:
                seg.close()  # the mapping must not outlive a failed scan
                raise
            torn = torn or seg_torn
            records += len(seg.index)
            next_offset = seg_next
            if not seg.index and len(names) > 1 and fname != names[-1]:
                # an empty segment before the tail (created, never written
                # before the crash): drop it rather than keep a hole
                seg.close()
                os.unlink(seg.path)
                continue
            self._segments.append(seg)
        self._next_offset = next_offset
        if not self._segments:
            self._segments.append(self._new_segment(self._next_offset))
        self.torn_tail_repaired = torn
        self.recovered_records = records
        self.recovery_ms = (time.monotonic() - t0) * 1000.0
        DURABLE.recovered(self.recovery_ms, records, torn)
        if records or torn:
            FLIGHT.record("recovery_scan", log=self.name, records=records,
                          next_offset=self._next_offset, torn_tail=torn,
                          ms=round(self.recovery_ms, 3))
        if torn:
            FLIGHT.record("torn_tail_repair", log=self.name,
                          truncated_at_offset=self._next_offset)

    # -- the segment ring --------------------------------------------------
    def _new_segment(self, base_offset: int) -> Segment:
        # guarded-by-caller: _lock
        path = os.path.join(self.dir, segment_filename(base_offset))
        if self._free:
            seg = self._free.pop()
            seg.reset(base_offset, path)
            DURABLE.rolled(recycled=True)
            return seg
        DURABLE.rolled(recycled=False)
        return Segment.allocate(path, self.segment_bytes, base_offset)

    def _roll(self) -> Segment:
        # guarded-by-caller: _lock
        active = self._segments[-1]
        if self.fsync != FSYNC_NONE:
            active.sync()
            DURABLE.fsynced()
        seg = self._new_segment(self._next_offset)
        self._segments.append(seg)
        FLIGHT.record("segment_rollover", log=self.name, base_offset=self._next_offset,
                      segments=len(self._segments))
        self._maybe_recycle()
        return seg

    def _maybe_recycle(self) -> None:
        """Recycle consumed history beyond the retention window. Only the
        live group's committed floor gates this: unconsumed records are
        never recycled; named replay groups read within the retained
        window, best effort."""
        # guarded-by-caller: _lock
        floor = self._committed.get("", -1)
        while len(self._segments) > self.retain_segments + 1:
            seg = self._segments[0]
            last = seg.last_offset
            if last is None or last > floor:
                break
            self._segments.pop(0)
            if len(self._free) < _FREE_SEGMENTS_MAX:
                self._free_id += 1
                seg.retire(os.path.join(self.dir, f"free-{self._free_id}.seg"))
                self._free.append(seg)
            else:
                seg.close()
                os.unlink(seg.path)

    def set_fsync_batch_n(self, n: int) -> None:
        """Live fsync-batching dial (an autotune knob): appends per fsync
        under the ``batch`` policy. The pending-appends count is kept, so a
        shrink acts at the next append and a grow stretches the current
        batch; what a machine crash can lose scales with the value, as
        ``--fsync_batch_n`` documents."""
        with self._lock:
            self.fsync_batch_n = max(1, int(n))

    # -- append ------------------------------------------------------------
    def append(self, item) -> int:
        """Append one record; returns its offset."""
        need = self._check_fits(item)
        with self._lock:
            self._check_open()
            offset = self._next_offset
            self._append_locked(offset, item, need)
            self._next_offset = offset + 1
            return offset

    def append_at(self, offset: int, item) -> int:
        """Append one record under an explicit offset: a replica mirrors
        its owner's offsets, so a promoted replica serves the same ones.
        ``offset`` must be the tail; the caller reconciles first
        (:meth:`truncate_to`, :meth:`reset_to`)."""
        need = self._check_fits(item)
        with self._lock:
            self._check_open()
            if offset != self._next_offset:
                raise ValueError(f"append_at out of order: offset {offset} vs tail "
                                 f"{self._next_offset} (reconcile with truncate_to/reset_to "
                                 f"first)")
            self._append_locked(offset, item, need)
            self._next_offset = offset + 1
            return offset

    def _check_fits(self, item) -> int:
        need = record_nbytes(item)
        if need > self.segment_bytes:
            raise ValueError(f"record of {need} framed bytes exceeds segment_bytes="
                             f"{self.segment_bytes}")
        return need

    def _append_locked(self, offset: int, item, need: int) -> None:
        # guarded-by-caller: _lock
        try:
            _disk_fault_check("append")
            seg = self._segments[-1]
            if seg.append(offset, item) is None:
                seg = self._roll()
                if seg.append(offset, item) is None:
                    raise RuntimeError(f"record did not fit a fresh segment ({need} bytes)")
            DURABLE.appended(need)
            if self.fsync == FSYNC_ALWAYS:
                seg.sync()
                DURABLE.fsynced()
            elif self.fsync == FSYNC_BATCH:
                self._appends_since_sync += 1
                if self._appends_since_sync >= self.fsync_batch_n:
                    self._appends_since_sync = 0
                    seg.sync()
                    DURABLE.fsynced()
        except OSError as e:
            # a failing or full disk fails this append, counted; the
            # server answers the producer (or the owner's link) 'E' and
            # serves on
            DURABLE.disk_faulted()
            FLIGHT.record("disk_fault", log=self.name, op="append", error=repr(e))
            raise

    # -- replica reconciliation --------------------------------------------
    def truncate_to(self, offset: int) -> None:
        """Drop every record at ``offset`` or above, so the next append
        lands there: after an owner reconnects, its view of the unacked
        suffix wins. The cut leaves a clean end for a later boot scan.
        Committed offsets are untouched."""
        with self._lock:
            self._check_open()
            if offset >= self._next_offset:
                return
            if offset <= self.first_retained_offset():
                self._reset_locked(offset)
            else:
                while self._segments:
                    seg = self._segments[-1]
                    first = seg.first_offset
                    if first is not None and first < offset:
                        pos = seg.find(offset)
                        if pos is not None:
                            seg.truncate_from(pos)
                        break
                    # the whole tail segment goes, an empty one too
                    self._segments.pop()
                    seg.close()
                    os.unlink(seg.path)
                if not self._segments:
                    self._segments.append(self._new_segment(offset))
                self._next_offset = offset
            DURABLE.truncated()
        FLIGHT.record("replica_truncate", log=self.name, to_offset=offset)

    def reset_to(self, offset: int) -> None:
        """Forget every record and start the offsets again at ``offset``:
        the owner's earliest record lies past this log's tail (its
        retention passed a lagging replica, over consumed history only),
        so a contiguous copy cannot be had."""
        with self._lock:
            self._check_open()
            self._reset_locked(offset)
        FLIGHT.record("replica_reset", log=self.name, to_offset=offset)

    def _reset_locked(self, offset: int) -> None:
        # guarded-by-caller: _lock
        for seg in self._segments:
            seg.close()
            os.unlink(seg.path)
        self._segments = [self._new_segment(offset)]
        self._next_offset = offset

    # -- read --------------------------------------------------------------
    def read(self, offset: int):
        """Decode the record at ``offset``. The item owns its data (the
        panels are copied out of the mapping: a spilled record's segment
        may be recycled once consumption passes it)."""
        with self._lock:
            self._check_open()
            seg = self._find_segment(offset)
            if seg is None:
                raise KeyError(f"offset {offset} is not retained (earliest "
                               f"{self.first_retained_offset()}, next {self._next_offset})")
            pos = seg.find(offset)
            if pos is None:
                raise KeyError(f"offset {offset} missing from {seg!r}")
            mv = seg.payload_at(pos)
            try:
                return decode_payload(mv)
            finally:
                mv.release()

    def payload_span(self, offset: int):
        """The record's payload on disk as a ``sendfile`` span ``(file,
        file_pos, nbytes)``, or None when the offset is not retained.
        Nothing is copied. Safe only for a record whose delivery pins the
        committed floor at or below ``offset`` (the durable queue's
        outstanding deliveries): the pin keeps the segment from being
        recycled while the span is queued. Replay cursors have no pin and
        use :meth:`read`."""
        with self._lock:
            self._check_open()
            seg = self._find_segment(offset)
            if seg is None:
                return None
            pos = seg.find(offset)
            if pos is None:
                return None
            return seg.payload_extent(pos)

    def _find_segment(self, offset: int) -> Optional[Segment]:
        # guarded-by-caller: _lock
        for seg in reversed(self._segments):
            first = seg.first_offset
            if first is not None and first <= offset:
                last = seg.last_offset
                return seg if last is not None and offset <= last else None
        return None

    def offsets_after(self, floor: int) -> List[int]:
        """Every retained offset above ``floor``: the unconsumed range a
        recovering queue re-exposes."""
        with self._lock:
            out: List[int] = []
            for seg in self._segments:
                out.extend(off for (off, _pos) in seg.index if off > floor)
            return out

    # -- offsets -----------------------------------------------------------
    def committed(self, group: str = "") -> int:
        with self._lock:
            return self._committed.get(group, -1)

    def commit(self, offset: int, group: str = "") -> bool:
        """Persist ``group``'s committed offset (monotonic: a stale commit
        does nothing). True when it advanced."""
        with self._lock:
            self._check_open()
            if offset <= self._committed.get(group, -1):
                return False
            self._committed[group] = offset
            _append_offset(os.path.join(self.dir, _OFFSETS_FILE), group, offset,
                           self._committed, durable=self.fsync != FSYNC_NONE)
            DURABLE.committed()
            if not group:
                self._maybe_recycle()
            return True

    def first_retained_offset(self) -> int:
        """The earliest offset still readable (``from=begin``); the next
        offset when the log holds nothing."""
        with self._lock:
            for seg in self._segments:
                first = seg.first_offset
                if first is not None:
                    return first
            return self._next_offset

    @property
    def next_offset(self) -> int:
        with self._lock:
            return self._next_offset

    def resolve_start(self, requested: int, group: str = "") -> int:
        """A replay-open position (an offset or a sentinel) on the retained
        range: ``REPLAY_BEGIN`` the earliest retained, ``REPLAY_RESUME`` the
        group's committed offset + 1, an offset clamped into the range."""
        with self._lock:
            earliest = self.first_retained_offset()
            if requested == REPLAY_BEGIN:
                return earliest
            if requested == REPLAY_RESUME:
                return max(self._committed.get(group, -1) + 1, earliest)
            return min(max(int(requested), earliest), self._next_offset)

    # -- lifecycle ---------------------------------------------------------
    def sync(self) -> None:
        with self._lock:
            if self._closed:
                return
            try:
                _disk_fault_check("sync")
                self._segments[-1].sync()
            except OSError as e:
                DURABLE.disk_faulted()
                FLIGHT.record("disk_fault", log=self.name, op="sync", error=repr(e))
                raise
            DURABLE.fsynced()
            self._appends_since_sync = 0

    def close(self) -> None:
        """Flush and unmap every segment."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for seg in self._segments + self._free:
                try:
                    seg.sync()
                except (ValueError, OSError):
                    pass
                seg.close()
            self._segments = []
            self._free = []

    def _check_open(self):
        # guarded-by-caller: _lock
        if self._closed:
            raise RuntimeError(f"segment log {self.name!r} is closed")

    def stats(self) -> dict:
        with self._lock:
            return {
                "next_offset": self._next_offset,
                "first_retained_offset": self.first_retained_offset(),
                "committed": dict(self._committed),
                "segments": len(self._segments),
                "free_segments": len(self._free),
                "segment_bytes": self.segment_bytes,
                "fsync": self.fsync,
                "torn_tail_repaired": self.torn_tail_repaired,
                "recovered_records": self.recovered_records,
                "recovery_ms": self.recovery_ms,
            }


class ReplayCursor:
    """A non-destructive reader of a log's retained range for one consumer
    group: live consumers are undisturbed (nothing is popped), and the
    cursor follows the tail, so a replay of a finished stream ends on the
    logged EOS markers. :meth:`commit` persists the group's position; a
    crashed reader opens again at ``REPLAY_RESUME``."""

    def __init__(self, log: SegmentLog, group: str, start: int):
        self.log = log
        self.group = group
        self.position = start  # the next offset to read
        self.delivered = start - 1  # the last offset handed out
        DURABLE.replay_opened()
        FLIGHT.record("replay_open", log=log.name, group=group, start=start,
                      end=log.next_offset)

    def next_batch(self, max_items: int) -> list:
        out = []
        while len(out) < int(max_items):
            with self.log._lock:
                if self.log._closed or self.position >= self.log._next_offset:
                    break
                earliest = self.log.first_retained_offset()
                if self.position < earliest:
                    # retention passed a lagging cursor: skip ahead (over
                    # consumed history only, never unconsumed records)
                    FLIGHT.record("replay_gap", log=self.log.name, group=self.group,
                                  skipped_from=self.position, resumed_at=earliest)
                    self.position = earliest
                    continue
                try:
                    item = self.log.read(self.position)
                except KeyError:
                    self.position += 1
                    continue
            out.append(item)
            self.delivered = self.position
            self.position += 1
        return out

    def commit(self, through: Optional[int] = None) -> bool:
        """Persist the group's position (default: everything delivered)."""
        through = self.delivered if through is None else through
        if through < 0:
            return False
        return self.log.commit(through, self.group)


# -- the committed-offset sidecar -------------------------------------------
def _load_offsets(path: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    try:
        with open(path, "r") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    group, off = rec["g"], int(rec["o"])
                except (ValueError, KeyError, TypeError):
                    continue  # a torn last line from a crash
                if off > out.get(group, -1):
                    out[group] = off
    except FileNotFoundError:
        pass
    return out


def _append_offset(path: str, group: str, offset: int, current: Dict[str, int],
                   durable: bool) -> None:
    """Append one commit line; past the size threshold, compact instead (an
    atomic rewrite of the latest offset of each group)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        size = 0
    if size > _OFFSETS_COMPACT_BYTES:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            for g, o in sorted(current.items()):
                f.write(json.dumps({"g": g, "o": o}) + "\n")
            if durable:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        return
    with open(path, "a") as f:
        f.write(json.dumps({"g": group, "o": offset}) + "\n")
        if durable:
            f.flush()
            os.fsync(f.fileno())
