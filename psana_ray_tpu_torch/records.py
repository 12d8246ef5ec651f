"""Frame records, the typed end-of-stream marker and their wire format.

The port's copy of ``psana_ray_tpu/records.py``: the record with its
buffer lease, the EOS marker with shard coverage, the consumer-side
tally, and the binary wire format that the shared-memory ring carries,
byte for byte the JAX package's:

- a frame is a fixed header (magic, version, shard rank, event index,
  ndim, dtype code, photon energy, timestamp), the shape as ``ndim``
  int64s, on version 3 a 25-byte trace context, then the panel bytes;
- untraced frames encode as version 2, traced ones as version 3, whose
  header carries the frame's :class:`~psana_ray_tpu_torch.obs.tracing.
  TraceContext`;
- an EOS marker is its own small header.

:func:`narrow_panels` is the producer's opt-in lossy wire dtype
(``--wire_dtype``). :meth:`FrameRecord.wire_parts` is the scatter-gather
form the TCP transport sends from the panels' own memory, and
:class:`LazyFrameRecord` a frame received compressed by the queue
server, whose panels inflate at first touch. :func:`mark_hop` stamps a
record's process-local ``hops`` (never on the wire), from which
:mod:`psana_ray_tpu_torch.obs.stages` takes per-stage latencies.
"""

from __future__ import annotations

import dataclasses
import struct
import time
from typing import List, Optional

import numpy as np

from psana_ray_tpu_torch.obs.tracing import TraceContext
from psana_ray_tpu_torch.utils.bufpool import WIRE

SCHEMA_VERSION = 3
_UNTRACED_WIRE_VERSION = 2  # frames without a trace context
TRACE_WIRE_SIZE = TraceContext.WIRE_SIZE  # 25 bytes, "<QIB12s"

_MAGIC = struct.Struct("<I")
_FRAME_MAGIC = 0x50525446  # "PRTF"
_EOS_MAGIC = 0x50525445  # "PRTE"
# magic, version, shard_rank, event_idx, ndim, dtype_code, photon_energy, timestamp
_FRAME_HEADER = struct.Struct("<IIqqII d d")
_EOS_HEADER_V1 = struct.Struct("<IIqq")
_EOS_HEADER = struct.Struct("<IIqqqq")  # v2+: shards_done, total_shards

_DTYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.uint16): 2,
    np.dtype(np.int32): 3,
    np.dtype(np.uint8): 4,
    np.dtype(np.int16): 5,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}


@dataclasses.dataclass(frozen=True, eq=False)
class FrameRecord:
    """One detector event: ``panels`` is always 3-D ``[P, H, W]`` (a 2-D
    frame gets a leading panel axis).

    ``lease`` (never on the wire): when ``panels`` is a zero-copy view
    into transport memory (a shm ring slot), the lease keeps that memory
    checked out; :meth:`release` hands it back once the payload has been
    copied onward (``FrameBatcher.push_view``). ``trace``: the frame's
    :class:`TraceContext` (a sampled frame's; None encodes as version 2).
    ``wire_cache`` (never on the wire): ``(codec_id, lease, payload)``, the
    exact compressed bytes a queue server received the frame as, which it
    re-sends verbatim to a peer of the same codec; released with the
    record. ``hops`` (never on the wire): ``{hop: time.monotonic()}``
    stamped by :func:`mark_hop`; None until a stamp, and after decode."""

    shard_rank: int
    event_idx: int
    panels: np.ndarray
    photon_energy: float
    timestamp: float = 0.0
    lease: Optional[object] = dataclasses.field(default=None, repr=False)
    trace: Optional[TraceContext] = dataclasses.field(default=None, repr=False)
    wire_cache: Optional[tuple] = dataclasses.field(default=None, repr=False)
    hops: Optional[dict] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        panels = np.asarray(self.panels)
        if panels.ndim == 2:
            panels = panels[None]
        if panels.ndim != 3:
            raise ValueError(f"panels must be 2-D or 3-D, got ndim={panels.ndim}")
        object.__setattr__(self, "panels", panels)

    @property
    def nbytes(self) -> int:
        return int(self.panels.nbytes)

    def equals(self, other: "FrameRecord") -> bool:
        return (
            isinstance(other, FrameRecord)
            and self.shard_rank == other.shard_rank
            and self.event_idx == other.event_idx
            and self.photon_energy == other.photon_energy
            and np.array_equal(self.panels, other.panels)
        )

    def release(self) -> None:
        """Hand the leased transport buffer back. Call only after the
        panels were copied onward: the view dies with the lease.
        Idempotent; a no-op for records that own their data. Drops the
        ``wire_cache`` lease too."""
        cache = self.wire_cache
        if cache is not None:
            object.__setattr__(self, "wire_cache", None)
            cache[1].release()
        lease = self.lease
        if lease is not None:
            object.__setattr__(self, "lease", None)
            lease.release()

    def materialize(self) -> "FrameRecord":
        """Self if this record owns its data; else a copy that does, with
        the lease released. Use before re-enqueueing or keeping a
        view-backed record past its transport buffer."""
        if self.lease is None and self.wire_cache is None:
            return self
        panels = self.panels
        if self.lease is not None:
            panels = panels.copy()
            WIRE.add(panels.nbytes)
        self.release()
        # replace() keeps the hops dict: stage timing survives the copy
        return dataclasses.replace(self, panels=panels, lease=None, wire_cache=None)

    def wire_parts(self) -> tuple:
        """``(header_bytes, payload_memoryview)``: :meth:`to_bytes` as two
        parts, the payload a flat byte view of the panels themselves (one
        copy only for strided panels), so a ``sendmsg`` sender never
        builds the frame as one bytes object."""
        panels = self.panels
        if not panels.flags.c_contiguous:
            panels = np.ascontiguousarray(panels)
            WIRE.add(panels.nbytes)
        if panels.dtype not in _DTYPE_CODES:
            raise ValueError(f"dtype {panels.dtype} has no wire code")
        header = _FRAME_HEADER.pack(
            _FRAME_MAGIC, _wire_version(self), self.shard_rank, self.event_idx, panels.ndim,
            _DTYPE_CODES[panels.dtype], float(self.photon_energy), float(self.timestamp),
        ) + struct.pack(f"<{panels.ndim}q", *panels.shape)
        if self.trace is not None:
            header += self.trace.pack()
        return header, panels.data.cast("B")

    def to_bytes(self) -> bytes:
        buf = bytearray(encoded_size(self))
        encode_into(self, buf)
        return bytes(buf)


class LazyFrameRecord(FrameRecord):
    """A frame the queue server received compressed and did not inflate.
    Its header fields are real (they travel uncompressed); ``panels``
    inflates at first touch through a closure of the codec layer. A relay
    that re-sends the cached compressed bytes to a peer of the same codec
    never touches the panels. Built by :func:`make_lazy_frame` only."""

    @property
    def panels(self):  # type: ignore[override]
        p = self.__dict__.get("_panels")
        if p is None:
            # the closure knows nothing of the record: a closure holding the
            # record would be a reference cycle, and the pool's leases would
            # wait for a gc pass instead of the record's death
            p, lease = self.__dict__["_inflate"]()
            object.__setattr__(self, "_panels", p)
            if lease is not None:
                object.__setattr__(self, "lease", lease)
        return p

    @property
    def nbytes(self) -> int:
        return int(self.__dict__["_panel_nbytes"])  # no inflate for a count

    def materialize(self) -> "FrameRecord":
        panels = self.panels.copy()
        WIRE.add(panels.nbytes)
        rec = FrameRecord(self.shard_rank, self.event_idx, panels, self.photon_energy,
                          self.timestamp, trace=self.trace, hops=self.hops)
        self.release()
        return rec


def make_lazy_frame(rank, idx, energy, ts, trace, panel_nbytes, inflate,
                    wire_cache) -> LazyFrameRecord:
    """A :class:`LazyFrameRecord` with its header fields set directly.
    ``inflate`` is a closure of no arguments returning ``(panels, lease)``
    (the lease backing the inflated panels, None off the pooled path); it
    must not reference the record."""
    rec = object.__new__(LazyFrameRecord)
    for name, value in (("shard_rank", rank), ("event_idx", idx), ("photon_energy", energy),
                        ("timestamp", ts), ("lease", None), ("trace", trace),
                        ("wire_cache", wire_cache), ("hops", None),
                        ("_panel_nbytes", int(panel_nbytes)),
                        ("_inflate", inflate)):
        object.__setattr__(rec, name, value)
    return rec


@dataclasses.dataclass(frozen=True)
class EndOfStream:
    """Typed end-of-stream marker. Each producer runtime emits one, carrying
    how many shards it covered (``shards_done``) of how many exist
    (``total_shards``); consumers stop once every shard is covered."""

    producer_rank: int = 0
    total_events: int = -1  # -1 = unknown
    shards_done: int = 1
    total_shards: int = 1

    def to_bytes(self) -> bytes:
        return _EOS_HEADER.pack(_EOS_MAGIC, SCHEMA_VERSION, self.producer_rank,
                                self.total_events, self.shards_done, self.total_shards)

    @staticmethod
    def from_bytes(buf) -> "EndOfStream":
        magic, version, rank, total = _EOS_HEADER_V1.unpack_from(buf, 0)
        if magic != _EOS_MAGIC:
            raise ValueError(f"bad EOS magic {magic:#x}")
        shards_done = total_shards = 1
        if version >= 2:
            shards_done, total_shards = struct.unpack_from("<qq", buf, _EOS_HEADER_V1.size)
        return EndOfStream(rank, total, shards_done, total_shards)


class EosTally:
    """Tallies EOS markers from several producer runtimes.

    :meth:`process` returns True once the ``shards_done`` of distinct
    producer ranks sum to ``total_shards``. Coverage is idempotent per
    rank. A second marker from a rank already seen belongs to a sibling
    consumer: it is held and handed back by :meth:`flush_duplicates`.
    """

    def __init__(self):
        self._shards_by_rank = {}
        self._total = 1
        self._pending_dups: List[EndOfStream] = []

    def markers(self) -> List[EndOfStream]:
        """One marker for each producer rank observed: what a consumer hands
        back to a queue it gives up mid-tally (a cluster rebalance revoking
        a partly drained partition), so the new owner's tally sees the same
        coverage. Held duplicates stay with :meth:`flush_duplicates`."""
        return [EndOfStream(producer_rank=rank, shards_done=done, total_shards=self._total)
                for rank, done in sorted(self._shards_by_rank.items())]

    @property
    def complete(self) -> bool:
        return sum(self._shards_by_rank.values()) >= self._total

    def is_duplicate(self, eos: EndOfStream) -> bool:
        return eos.producer_rank in self._shards_by_rank

    def observe(self, eos: EndOfStream) -> bool:
        self._shards_by_rank[eos.producer_rank] = eos.shards_done
        self._total = max(self._total, eos.total_shards)
        return self.complete

    def process(self, eos: EndOfStream) -> bool:
        if self.is_duplicate(eos):
            self._pending_dups.append(eos)
            return self.complete
        return self.observe(eos)

    def flush_duplicates(self, queue, final: bool = False) -> int:
        """Return held sibling markers to ``queue`` (non-blocking; with
        ``final`` a short blocking put each). Returns how many went back."""
        # imported here: the transports import this module
        from psana_ray_tpu_torch.transport.registry import TransportClosed, TransportWedged

        placed = 0
        while self._pending_dups:
            eos = self._pending_dups[0]
            try:
                ok = queue.put_wait(eos, timeout=1.0) if final else queue.put(eos)
            except TransportWedged:
                if not final:  # a crashed peer is an error, not a drained queue
                    raise
                self._pending_dups.clear()
                break
            except TransportClosed:  # the sibling sees the dead queue itself
                self._pending_dups.clear()
                break
            if not ok:
                break
            self._pending_dups.pop(0)
            placed += 1
        return placed


def mark_hop(rec, hop: str, t: Optional[float] = None) -> None:
    """Stamp ``time.monotonic()`` (or ``t``) on ``rec`` under ``hop``: the
    producer stamps source read and enqueue, the batcher dequeue and
    assembly, the prefetcher the device copy. A no-op on anything but a
    frame; the dict is attached once and then mutated in place."""
    if not isinstance(rec, FrameRecord):
        return
    hops = rec.hops
    if hops is None:
        hops = {}
        object.__setattr__(rec, "hops", hops)
    hops[hop] = time.monotonic() if t is None else t


def is_eos(item) -> bool:
    return isinstance(item, EndOfStream)


# -- wire format -------------------------------------------------------------


def validate_wire_dtype(dtype_str: str) -> np.dtype:
    """The dtype named ``dtype_str`` if the wire format can carry it, else
    ``ValueError``: the one rule the CLI's ``--wire_dtype`` and
    :func:`narrow_panels` share."""
    dtype = np.dtype(dtype_str)
    if dtype not in _DTYPE_CODES:
        raise ValueError(
            f"wire dtype {dtype_str!r} is not wire-codable "
            f"(supported: {sorted(str(d) for d in _DTYPE_CODES)})"
        )
    return dtype


def narrow_panels(panels: np.ndarray, dtype_str: str) -> np.ndarray:
    """Convert panels to a narrower wire dtype before they are encoded
    (lossy, opt-in per stream): an integer target rounds to nearest and
    clips to its range, NaN (a masked pixel) becomes 0. A no-op when the
    panels already have that dtype."""
    dtype = validate_wire_dtype(dtype_str)
    if panels.dtype == dtype:
        return panels
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        if np.issubdtype(panels.dtype, np.floating):
            src = np.rint(panels)
            np.copyto(src, 0.0, where=np.isnan(src))  # NaN -> int is undefined in numpy
        else:
            src = panels
        out = np.clip(src, info.min, info.max).astype(dtype)
    else:
        out = panels.astype(dtype)
    WIRE.add(out.nbytes)
    return out


def _wire_version(rec: FrameRecord) -> int:
    return SCHEMA_VERSION if rec.trace is not None else _UNTRACED_WIRE_VERSION


def parse_frame_header(buf) -> tuple:
    """Parse a frame's wire header without touching the payload:
    ``(shard_rank, event_idx, shape, dtype, photon_energy, timestamp,
    version, trace, header_len)``; ``trace`` is the v3 header's
    :class:`TraceContext` or None. Raises ``ValueError`` on bytes that are no frame."""
    magic, version, rank, idx, ndim, dtype_code, energy, ts = _FRAME_HEADER.unpack_from(buf, 0)
    if magic != _FRAME_MAGIC:
        raise ValueError(f"bad frame magic {magic:#x}")
    if version > SCHEMA_VERSION:
        raise ValueError(f"unsupported schema version {version}")
    if dtype_code not in _CODE_DTYPES:
        raise ValueError(f"unknown dtype code {dtype_code}")
    off = _FRAME_HEADER.size
    shape = struct.unpack_from(f"<{ndim}q", buf, off)
    off += 8 * ndim
    trace = None
    if version >= 3:
        trace = TraceContext.unpack_from(buf, off)
        off += TRACE_WIRE_SIZE
    return rank, idx, shape, _CODE_DTYPES[dtype_code], energy, ts, version, trace, off


def encoded_size(item) -> int:
    """The exact wire size of ``item``, so a transport can reserve its slot."""
    if isinstance(item, FrameRecord):
        trace = TRACE_WIRE_SIZE if item.trace is not None else 0
        return _FRAME_HEADER.size + 8 * item.panels.ndim + trace + item.nbytes
    if isinstance(item, EndOfStream):
        return _EOS_HEADER.size
    raise TypeError(f"not a wire record: {type(item)!r}")


def encode_into(item, buf) -> int:
    """Serialize ``item`` straight into the writable buffer ``buf`` (a shm
    ring slot); the panels land with one ``np.copyto``. Returns the bytes
    written."""
    mv = memoryview(buf)
    if isinstance(item, EndOfStream):
        data = item.to_bytes()
        mv[: len(data)] = data
        return len(data)
    if not isinstance(item, FrameRecord):
        raise TypeError(f"not a wire record: {type(item)!r}")
    panels = np.ascontiguousarray(item.panels)
    if panels.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {panels.dtype} has no wire code")
    _FRAME_HEADER.pack_into(mv, 0, _FRAME_MAGIC, _wire_version(item), item.shard_rank,
                            item.event_idx, panels.ndim, _DTYPE_CODES[panels.dtype],
                            float(item.photon_energy), float(item.timestamp))
    off = _FRAME_HEADER.size
    struct.pack_into(f"<{panels.ndim}q", mv, off, *panels.shape)
    off += 8 * panels.ndim
    if item.trace is not None:
        mv[off:off + TRACE_WIRE_SIZE] = item.trace.pack()
        off += TRACE_WIRE_SIZE
    dst = np.frombuffer(mv, dtype=panels.dtype, count=panels.size, offset=off)
    np.copyto(dst, panels.reshape(-1))
    WIRE.add(panels.nbytes)
    return off + panels.nbytes


def decode(buf, lease=None):
    """Decode one wire message into a :class:`FrameRecord` or
    :class:`EndOfStream`; ``buf`` is any buffer (bytes, a memoryview into
    shared memory).

    Without ``lease`` the record owns its panels (copied out of ``buf``).
    With ``lease`` (a checked-out buffer that ``buf`` views) a frame comes
    back zero-copy: its panels view ``buf`` and the lease rides on the
    record. An EOS never needs the buffer past decode, so its lease is
    released here, after the parse."""
    (magic,) = _MAGIC.unpack_from(buf, 0)
    if magic == _FRAME_MAGIC:
        rank, idx, shape, dtype, energy, ts, _, trace, off = parse_frame_header(buf)
        panels = np.frombuffer(buf, dtype=dtype, count=int(np.prod(shape)), offset=off)
        panels = panels.reshape(shape)
        if lease is None:
            panels = panels.copy()
            WIRE.add(panels.nbytes)
        return FrameRecord(rank, idx, panels, energy, ts, lease=lease, trace=trace)
    try:
        if magic == _EOS_MAGIC:
            return EndOfStream.from_bytes(buf)
        raise ValueError(f"unknown wire magic {magic:#x}")
    finally:
        if lease is not None:
            lease.release()
