"""One mmap'd segment file: pre-allocated, CRC-framed, recycled.

The port's copy of ``psana_ray_tpu/storage/segment.py``; the file format
is the JAX package's, byte for byte. A segment is allocated once at its
fixed size (``ftruncate`` + ``mmap``), filled with framed records and,
once every record in it has fallen below the committed floor and out of
the retention window, scrubbed and renamed to become the log's new tail
instead of being deleted and allocated again. An append is one
``encode_into`` into already-mapped pages: no file creation and no
``bytes`` object for a frame.

Record framing (little-endian, 20-byte header)::

    magic:u32  payload_len:u32  crc32:u32  offset:u64  payload bytes

``payload`` is the tagged codec payload the wire carries (tag byte +
the records wire format, or a pickle), so a logged record and a sent one
are the same bytes. The CRC covers the payload. A crash mid-append
leaves either an all-zero header (a clean end: segments start zeroed) or
a record whose length, CRC or offset fails validation: a torn tail, cut
by the recovery scan (:meth:`Segment.scan`). Offsets increase strictly
within and across segments, which also stops a scan at the stale bytes
of a recycled segment's previous life.
"""

from __future__ import annotations

import bisect
import mmap
import os
import pickle
import struct
import zlib
from typing import List, Optional, Tuple

from psana_ray_tpu_torch.records import EndOfStream, FrameRecord, encode_into, encoded_size
from psana_ray_tpu_torch.transport.codec import TAG_PICKLE, TAG_RECORD

_SEG_REC_MAGIC = 0x50525453  # "PRTS": psana-ray-tpu segment record
_REC_HEADER = struct.Struct("<IIIQ")
REC_OVERHEAD = _REC_HEADER.size

# zero block reused to scrub a recycled segment's previous records
_ZEROS = bytes(1 << 20)


def segment_filename(base_offset: int) -> str:
    return f"seg-{base_offset:020d}.seg"


def parse_base_offset(filename: str) -> Optional[int]:
    if not (filename.startswith("seg-") and filename.endswith(".seg")):
        return None
    try:
        return int(filename[4:-4])
    except ValueError:
        return None


def record_nbytes(item) -> int:
    """Framed size of ``item`` in a segment (header + tag + payload),
    serializing only where the codec must (a pickle)."""
    if isinstance(item, (FrameRecord, EndOfStream)):
        return REC_OVERHEAD + 1 + encoded_size(item)
    return REC_OVERHEAD + 1 + len(pickle.dumps(item, protocol=pickle.HIGHEST_PROTOCOL))


class Segment:
    """One pre-allocated mmap'd segment. Make it with :meth:`allocate` (a
    new or recycled file) or :meth:`open_existing` (the recovery scan);
    every path ends in :meth:`close` or :meth:`retire`."""

    def __init__(self, path: str, f, mm: mmap.mmap, base_offset: int):
        self.path = path
        self._f = f
        self._mm = mm
        self._mv = memoryview(mm)
        self.base_offset = base_offset
        self.capacity = len(mm)
        self.write_pos = 0
        # (offset, file position) a record, in append order: offsets
        # increase strictly, so readers bisect
        self.index: List[Tuple[int, int]] = []
        self.closed = False

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def allocate(cls, path: str, nbytes: int, base_offset: int) -> "Segment":
        f = open(path, "a+b")
        try:
            f.truncate(nbytes)
            mm = mmap.mmap(f.fileno(), nbytes)
        except BaseException:
            f.close()
            raise
        return cls(path, f, mm, base_offset)

    @classmethod
    def open_existing(cls, path: str, base_offset: int) -> "Segment":
        f = open(path, "r+b")
        try:
            size = os.fstat(f.fileno()).st_size
            mm = mmap.mmap(f.fileno(), size)
        except BaseException:
            f.close()
            raise
        return cls(path, f, mm, base_offset)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self._mv.release()
        self._mm.close()
        self._f.close()

    def retire(self, free_path: str) -> None:
        """Move to the free list: scrub the written region (stale records
        must not survive into the next life) and rename out of the
        ``seg-*`` names, so that a crash with free segments on disk cannot
        make the next boot scan them as history."""
        self._scrub(0, self.write_pos)
        os.rename(self.path, free_path)
        self.path = free_path
        self.write_pos = 0
        self.index = []

    def reset(self, new_base_offset: int, new_path: str) -> None:
        """Reuse a retired (already scrubbed) segment as the log's new
        tail: rename it into place and rewind."""
        os.rename(self.path, new_path)
        self.path = new_path
        self.base_offset = new_base_offset
        self.write_pos = 0
        self.index = []

    def _scrub(self, start: int, end: int) -> None:
        pos = start
        while pos < end:
            n = min(len(_ZEROS), end - pos)
            self._mv[pos:pos + n] = _ZEROS[:n]
            pos += n

    # -- append ------------------------------------------------------------
    def append(self, offset: int, item) -> Optional[int]:
        """Frame ``item`` at the write position; returns the record's file
        position, or None when it does not fit (the log rolls). A record's
        payload lands with one ``encode_into``; the header is written
        after the payload, so a crash mid-copy leaves an all-zero header,
        not a half-framed record."""
        pos = self.write_pos
        data_start = pos + REC_OVERHEAD
        if isinstance(item, (FrameRecord, EndOfStream)):
            need = 1 + encoded_size(item)
            if data_start + need > self.capacity:
                return None
            self._mv[data_start:data_start + 1] = TAG_RECORD
            payload_len = 1 + encode_into(item, self._mv[data_start + 1:])
        else:
            data = TAG_PICKLE + pickle.dumps(item, protocol=pickle.HIGHEST_PROTOCOL)
            payload_len = len(data)
            if data_start + payload_len > self.capacity:
                return None
            self._mv[data_start:data_start + payload_len] = data
        crc = zlib.crc32(self._mv[data_start:data_start + payload_len])
        _REC_HEADER.pack_into(self._mv, pos, _SEG_REC_MAGIC, payload_len, crc, offset)
        self.write_pos = data_start + payload_len
        self.index.append((offset, pos))
        return pos

    # -- read --------------------------------------------------------------
    def _payload_len(self, pos: int) -> int:
        magic, payload_len, _crc, _off = _REC_HEADER.unpack_from(self._mv, pos)
        if magic != _SEG_REC_MAGIC:
            raise ValueError(f"bad segment record magic {magic:#x} at {pos}")
        return payload_len

    def payload_at(self, pos: int) -> memoryview:
        """Zero-copy view of the payload of the record at ``pos``. Decode
        it (which copies the panels out) before anything that could reset
        or close this segment."""
        start = pos + REC_OVERHEAD
        return self._mv[start:start + self._payload_len(pos)]

    def payload_extent(self, pos: int):
        """``(file, file_pos, nbytes)`` of the payload at ``pos``: the
        ``sendfile`` span of the record (its payload is the wire payload).
        The file is the segment's own open handle; the durable queue's
        floor pin keeps the segment alive while the span is queued."""
        return self._f, pos + REC_OVERHEAD, self._payload_len(pos)

    def find(self, offset: int) -> Optional[int]:
        """File position of the record with exactly ``offset``."""
        i = bisect.bisect_left(self.index, (offset, -1))
        if i < len(self.index) and self.index[i][0] == offset:
            return self.index[i][1]
        return None

    def truncate_from(self, pos: int) -> None:
        """Discard every record at file position ``pos`` or later: the
        region is scrubbed, so later appends and any later recovery scan
        see a clean end."""
        if pos >= self.write_pos:
            return
        self._scrub(pos, self.write_pos)
        self.index = [(off, p) for (off, p) in self.index if p < pos]
        self.write_pos = pos

    # -- recovery ----------------------------------------------------------
    def scan(self, expect_from: int) -> Tuple[int, bool]:
        """Rebuild the index from disk after a restart: walk the records
        from position 0, checking magic, bounds, CRC and offsets that
        increase strictly from ``expect_from`` (the previous segment's
        last offset + 1). Sets ``write_pos`` to the end of the last valid
        record. Returns ``(last valid offset + 1, torn)``; ``torn`` reports
        a tail cut off (nonzero bytes that failed validation), which is
        then scrubbed to the segment's end."""
        self.index = []
        pos = 0
        next_offset = expect_from
        torn = False
        while pos + REC_OVERHEAD <= self.capacity:
            header = bytes(self._mv[pos:pos + REC_OVERHEAD])
            if header == b"\0" * REC_OVERHEAD:
                break  # a clean end: segments start zeroed
            magic, payload_len, crc, offset = _REC_HEADER.unpack(header)
            data_start = pos + REC_OVERHEAD
            if (magic != _SEG_REC_MAGIC or payload_len == 0
                    or data_start + payload_len > self.capacity or offset != next_offset
                    or zlib.crc32(self._mv[data_start:data_start + payload_len]) != crc):
                torn = True
                break
            self.index.append((offset, pos))
            next_offset = offset + 1
            pos = data_start + payload_len
        self.write_pos = pos
        if torn:
            self._scrub(pos, self.capacity)
        return next_offset, torn

    # -- durability --------------------------------------------------------
    def sync(self) -> None:
        self._mm.flush()

    @property
    def first_offset(self) -> Optional[int]:
        return self.index[0][0] if self.index else None

    @property
    def last_offset(self) -> Optional[int]:
        return self.index[-1][0] if self.index else None

    def __repr__(self):
        return (f"<Segment {os.path.basename(self.path)} base={self.base_offset} "
                f"records={len(self.index)} used={self.write_pos}/{self.capacity}>")
