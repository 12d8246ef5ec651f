"""Size-classed receive-buffer pool with lease/release semantics.

The port's copy of ``psana_ray_tpu/utils/bufpool.py``. The TCP transport
receives every payload into a recycled buffer of this pool instead of a
fresh allocation, and decodes a frame as a view of it: steady-state
receive costs no allocation.

- :class:`BufferPool`: power-of-two size classes, free lists whose length
  follows the peak number of buffers of a class leased at once;
- :class:`Lease`: one checked-out buffer; ``release()`` is idempotent and
  also runs when the lease is collected, so a leaked record can delay
  reuse but never corrupts it (a buffer is never handed out while its
  lease is alive).

A record decoded with a lease views the leased buffer for its lifetime:
``FrameBatcher.push_view`` releases the lease right after the frame's one
copy into its batch arena.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

_MIN_CLASS = 1 << 12  # 4 KB: below this, pooling costs more than malloc


def _size_class(nbytes: int) -> int:
    c = _MIN_CLASS
    while c < nbytes:
        c <<= 1
    return c


class Lease:
    """One buffer checked out of a :class:`BufferPool`.

    ``mv`` is a writable memoryview of exactly the requested size (the
    buffer behind it is the whole size class). ``release()`` returns the
    buffer to the pool; it is idempotent and also fires from ``__del__``.
    Never release before the last read of any view into the buffer."""

    __slots__ = ("_pool", "_buf", "mv", "_released", "__weakref__")

    def __init__(self, pool: "BufferPool", buf: bytearray, nbytes: int):
        self._pool = pool
        self._buf = buf
        self.mv = memoryview(buf)[:nbytes]
        self._released = False

    @property
    def pool(self) -> "BufferPool":
        """The owning pool: a decoder handed only a lease (the wire
        decompressor) stages its output in a sibling lease of it."""
        return self._pool

    def release(self):
        if self._released:
            return
        self._released = True
        self.mv = None  # drop the exported view before the buffer moves on
        self._pool._give_back(self._buf)
        self._buf = None

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass


class BufferPool:
    """Recycles byte buffers by power-of-two size class.

    ``lease(n)`` pops a free buffer of the smallest class >= n (a hit) or
    allocates one (a miss); ``Lease.release`` pushes it back. A class
    keeps up to ``max(min_per_class, peak concurrently leased)`` free
    buffers, and every ``DECAY_EVERY`` releases its peak decays a quarter
    toward the live count, so a one-time burst stops pinning its memory.
    Thread-safe."""

    _default: Optional["BufferPool"] = None  # guarded-by: _default_lock
    _default_lock = threading.Lock()
    DECAY_EVERY = 256

    def __init__(self, min_per_class: int = 4):
        self.min_per_class = min_per_class
        self._lock = threading.Lock()
        self._free: Dict[int, List[bytearray]] = {}  # guarded-by: _lock
        self._out_by_class: Dict[int, int] = {}  # guarded-by: _lock
        self._peak_by_class: Dict[int, int] = {}  # guarded-by: _lock
        self._rel_by_class: Dict[int, int] = {}  # guarded-by: _lock
        self._hits = 0  # guarded-by: _lock
        self._misses = 0  # guarded-by: _lock
        self._leases = 0  # guarded-by: _lock
        self._bytes_pooled = 0  # guarded-by: _lock

    @classmethod
    def default(cls) -> "BufferPool":
        """The process-wide pool every transport shares, registered with
        :data:`WIRE` as the ``bufpool`` and ``wire`` sources of the
        process's metrics registry when first made."""
        with cls._default_lock:
            if cls._default is None:
                cls._default = BufferPool()
                from psana_ray_tpu_torch.obs.registry import MetricsRegistry

                MetricsRegistry.default().register("bufpool", cls._default)
                MetricsRegistry.default().register("wire", WIRE)
            return cls._default

    def lease(self, nbytes: int) -> Lease:
        cls_bytes = _size_class(nbytes)
        with self._lock:
            free = self._free.get(cls_bytes)
            if free:
                buf = free.pop()
                self._bytes_pooled -= cls_bytes
                self._hits += 1
            else:
                buf = None
                self._misses += 1
            self._leases += 1
            out = self._out_by_class.get(cls_bytes, 0) + 1
            self._out_by_class[cls_bytes] = out
            if out > self._peak_by_class.get(cls_bytes, 0):
                self._peak_by_class[cls_bytes] = out
        if buf is None:
            buf = bytearray(cls_bytes)
        return Lease(self, buf, nbytes)

    def _give_back(self, buf: bytearray):
        cls_bytes = len(buf)
        with self._lock:
            self._leases -= 1
            out = self._out_by_class.get(cls_bytes, 1) - 1
            self._out_by_class[cls_bytes] = out
            rel = self._rel_by_class.get(cls_bytes, 0) + 1
            peak = self._peak_by_class.get(cls_bytes, 0)
            if rel >= self.DECAY_EVERY:
                rel = 0
                peak = max(out, peak - max(1, peak >> 2))
                self._peak_by_class[cls_bytes] = peak
            self._rel_by_class[cls_bytes] = rel
            free = self._free.setdefault(cls_bytes, [])
            keep = max(self.min_per_class, peak)
            while len(free) >= keep and free:  # trim after a decay
                free.pop()
                self._bytes_pooled -= cls_bytes
            if len(free) < keep:
                free.append(buf)
                self._bytes_pooled += cls_bytes

    def set_min_per_class(self, n: int) -> None:
        """Live retention-floor dial (an autotune knob): the least number
        of free buffers each size class keeps whatever its peak. A shrink
        trims on the next release (the decay path), a grow keeps more on
        later releases; nothing is allocated here."""
        with self._lock:
            self.min_per_class = max(0, int(n))

    def stats(self) -> dict:
        """Outstanding leases, hits, misses, bytes held in free lists and
        the number of size classes seen."""
        with self._lock:
            return {"leases": self._leases, "hits": self._hits, "misses": self._misses,
                    "bytes_pooled": self._bytes_pooled, "classes": len(self._free)}


class WireCounters:
    """The process's frame-sized host copies on the wire datapath (a decode
    with a copy, an encode into a slot, the batcher's arena copy), counted
    as the JAX package counts them."""

    __slots__ = ("_lock", "bytes_copied", "copies")

    def __init__(self):
        self._lock = threading.Lock()
        self.bytes_copied = 0  # guarded-by: _lock
        self.copies = 0  # guarded-by: _lock

    def add(self, nbytes: int):
        with self._lock:
            self.bytes_copied += int(nbytes)
            self.copies += 1

    def stats(self) -> dict:
        with self._lock:
            return {"bytes_copied_total": self.bytes_copied, "copies_total": self.copies}

    def snapshot(self) -> dict:
        return self.stats()


WIRE = WireCounters()
