"""DurableRingBuffer: the log-backed ``RingBuffer``.

The port's copy of ``psana_ray_tpu/storage/durable.py``, on the port's
:class:`~psana_ray_tpu_torch.transport.ring.RingBuffer` through its
``_box``/``_unbox`` storage hooks. What it adds to the queue's contract:

- **Every put is logged first.** ``_box`` appends the record to the
  :class:`~psana_ray_tpu_torch.storage.log.SegmentLog` (one ``encode_into``
  into the mapped segment) and the offset rides the queue entry.
- **Bounded spill.** While the RAM-resident count is under ``ram_items``
  the item itself stays queued; past it the RAM copy is released (its
  pooled lease goes back at once: a deep queue must not pin the pool)
  and delivery hands out a :class:`SpilledRecord` that the queue server
  sends from the file with ``sendfile``, or materializes.
- **Committed offsets.** A popped item stays outstanding until
  :meth:`ack_delivered` (the queue server calls it at its implicit-ACK
  points); the committed floor, the offset below every queued or
  outstanding record, is persisted through the log. A restart
  re-exposes exactly ``(floor, tail]``.
- **Replay.** :meth:`open_replay` hands out a non-destructive
  :class:`~psana_ray_tpu_torch.storage.log.ReplayCursor` over the
  retained range for a named consumer group.

``put_front`` (the requeue of a dead connection's deliveries) puts an
outstanding item back under its original offset: no second append, and
the floor stays below it.
"""

from __future__ import annotations

from typing import Any, Optional

from psana_ray_tpu_torch.obs.flight import FLIGHT
from psana_ray_tpu_torch.storage.log import ReplayCursor, SegmentLog
from psana_ray_tpu_torch.storage.telemetry import DURABLE
from psana_ray_tpu_torch.transport.ring import RingBuffer


class _Entry:
    """A queued record: its log offset and its RAM copy (None when
    spilled: delivery reads the log)."""

    __slots__ = ("offset", "item")

    def __init__(self, offset: int, item: Any):
        self.offset = offset
        self.item = item


class SpilledRecord:
    """A delivered spilled record not read into the interpreter.

    The queue server frames and relays items without looking inside, so
    delivery can hand it this handle: on a plain connection it asks
    :meth:`payload_span` for a ``(file, pos, nbytes)`` span and the payload
    goes from the page cache to the socket by ``sendfile``;
    :meth:`materialize` (a compressed connection, a socket that refuses
    ``sendfile``) reads and decodes it from the log. Every delivery contract
    of the server is keyed by ``id(item)``, and while this handle is
    outstanding the committed floor stays at or below ``offset``, which
    keeps the span's segment from being recycled mid-send."""

    __slots__ = ("log", "offset", "_item")

    def __init__(self, log: SegmentLog, offset: int):
        self.log = log
        self.offset = offset
        self._item = None

    def payload_span(self):
        """``(file, file_pos, nbytes)`` of the tagged payload, or None
        (no longer retained: the caller materializes)."""
        return self.log.payload_span(self.offset)

    def materialize(self) -> Any:
        """The decoded record (cached)."""
        if self._item is None:
            DURABLE.spill_read()
            self._item = self.log.read(self.offset)
        return self._item


class DurableRingBuffer(RingBuffer):
    def __init__(self, log: SegmentLog, maxsize: int = 100, name: str = "durable_queue",
                 ram_items: Optional[int] = None):
        super().__init__(maxsize=maxsize, name=name)
        self.log = log
        self.ram_items = int(ram_items) if ram_items else int(maxsize)
        self._resident = 0  # RAM-held entries in _q  # guarded-by: _lock
        self._spilled = 0  # log-only entries in _q  # guarded-by: _lock
        # delivered, not acked: id(item) -> entry. The strong references
        # keep the ids from being reused until the ack or put_front
        self._outstanding: dict = {}  # guarded-by: _lock
        self._floor = log.committed("")  # guarded-by: _lock
        self.reexposed = 0
        self._reexpose()

    # -- recovery ----------------------------------------------------------
    def _reexpose(self) -> None:
        """Boot: what the log retains above the committed floor is
        unconsumed; queue it, spilled. The depth may exceed maxsize here,
        as with put_front: the records were admitted in a previous life."""
        with self._lock:
            offsets = self.log.offsets_after(self._floor)
            if not offsets:
                return
            for off in offsets:
                self._q.append(_Entry(off, None))
            self._spilled += len(offsets)
            self._high_water = max(self._high_water, len(self._q))
            self.reexposed = len(offsets)
            self._not_empty.notify_all()
            self._notify_listeners()
        DURABLE.spill_delta(len(offsets))
        FLIGHT.record("durable_reexpose", queue=self.name, records=len(offsets),
                      from_offset=offsets[0], to_offset=offsets[-1])

    # -- the storage hooks (see RingBuffer._box/_unbox) ---------------------
    def _box(self, item: Any) -> Any:
        # guarded-by-caller: _lock
        offset = self.log.append(item)
        if self._resident < self.ram_items:
            self._resident += 1
            return _Entry(offset, item)
        # spill: the log holds the bytes; the RAM copy's lease goes back now
        if self._spilled == 0:
            FLIGHT.record("spill_enter", queue=self.name, depth=len(self._q))
        self._spilled += 1
        DURABLE.spill_delta(1)
        release = getattr(item, "release", None)
        if release is not None:
            release()
        return _Entry(offset, None)

    def set_ram_items(self, n: int) -> None:
        """Live spill-threshold dial (an autotune knob): the RAM-resident
        records admitted before new puts spill to log-only entries. It
        applies to later puts; a shrink evicts nothing already resident
        (those drain through delivery)."""
        with self._lock:
            self.ram_items = max(1, int(n))

    def _box_front(self, item: Any) -> Any:
        """Head re-insertion: an outstanding item comes back under its
        original offset; anything else (a sibling's EOS marker handed
        back, a materialized copy) is a fresh logged record."""
        # guarded-by-caller: _lock
        entry = self._outstanding.pop(id(item), None)
        if entry is not None:
            entry.item = item
            self._resident += 1
            return entry
        offset = self.log.append(item)
        self._resident += 1
        return _Entry(offset, item)

    def _unbox(self, stored: Any) -> Any:
        # guarded-by-caller: _lock
        entry: _Entry = stored
        if entry.item is None:
            # no read: the server sends the payload from the file, or
            # materializes (which counts the spill read then)
            entry.item = SpilledRecord(self.log, entry.offset)
            self._spilled -= 1
            DURABLE.spill_delta(-1)
            if self._spilled == 0:
                FLIGHT.record("spill_exit", queue=self.name)
        else:
            self._resident -= 1
        item = entry.item
        self._outstanding[id(item)] = entry
        return item

    def put_offset(self, item: Any):
        """``put`` that also gives the record's log offset: ``(ok,
        offset)``, ``(False, None)`` when full."""
        entry = self._admit(item)
        return (False, None) if entry is None else (True, entry.offset)

    @property
    def committed_floor(self) -> int:
        """The live committed offset: it rides on replica appends, so a
        promoted replica re-exposes only what lies above it."""
        with self._lock:
            return self._floor

    # -- committed offsets -------------------------------------------------
    def ack_delivered(self, items) -> int:
        """The delivery of ``items`` is confirmed (the server's
        implicit-ACK points: the next opcode, a stream's cumulative ack, a
        clean BYE). Advances and persists the committed floor; unknown
        items (acked already, another queue's) are ignored. Returns the
        floor."""
        with self._lock:
            changed = False
            for item in items:
                if self._outstanding.pop(id(item), None) is not None:
                    changed = True
            if changed:
                self._commit_floor()
            return self._floor

    def _commit_floor(self) -> None:
        """floor = (the lowest offset queued or outstanding) - 1, or the
        last offset assigned when nothing is pending. O(depth) an ack
        batch, bounded by maxsize."""
        # guarded-by-caller: _lock
        pending = [e.offset for e in self._q]
        pending.extend(e.offset for e in self._outstanding.values())
        floor = (min(pending) - 1) if pending else (self.log.next_offset - 1)
        if floor > self._floor:
            self._floor = floor
            self.log.commit(floor, "")

    def commit_offset(self, offset: int, group: str) -> bool:
        """An explicit commit for a named group (the 'J' opcode; the live
        floor is group ``""``, owned by the acks)."""
        if not group:
            return False
        return self.log.commit(offset, group)

    # -- replay ------------------------------------------------------------
    def open_replay(self, group: str, requested: int) -> ReplayCursor:
        """A non-destructive cursor over the retained range for ``group``
        (sentinels: ``REPLAY_BEGIN``, ``REPLAY_RESUME``)."""
        return ReplayCursor(self.log, group, self.log.resolve_start(requested, group))

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        super().close()
        try:
            self.log.sync()
        except (RuntimeError, OSError):
            pass  # closed already, or a disk fault already counted

    def stats(self) -> dict:
        out = super().stats()
        with self._lock:
            out.update(durable=True, spilled=self._spilled, resident=self._resident,
                       outstanding=len(self._outstanding), committed_offset=self._floor,
                       log=self.log.stats())
        return out
