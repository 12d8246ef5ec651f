"""Fixed-shape batching with zero padding and a validity mask.

The port's copy of what the serving path needs from
``psana_ray_tpu/infeed/batcher.py``. The batcher assembles ``[B, P, H, W]``
stacks in batch arenas; at end of stream the tail batch is padded to B
with zero rows and ``valid`` marks the real ones, so the model always
sees one shape. ``num_valid`` is a host int, so counting rows never syncs
the device.

A frame is copied once on the consumer's host: from the record (a view
into a shm ring slot, for transports that hand out views) into its row
of the arena, after which :meth:`FrameBatcher.push_view` releases the
slot. An arena can be pinned memory that the prefetcher copies to the
card directly (:func:`psana_ray_tpu_torch.infeed.pipeline.pinned_arena`);
its ``fence`` is the event behind that copy, and the batcher waits on it
before writing into the arena again.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, List, Optional

import numpy as np

from psana_ray_tpu_torch.records import EndOfStream, EosTally, FrameRecord
from psana_ray_tpu_torch.transport.registry import TransportClosed, TransportWedged

# the [B] metadata arrays of a batch, after the frames: valid, shard_rank,
# event_idx, photon_energy
META_DTYPES = (np.uint8, np.int32, np.int64, np.float32)


@dataclasses.dataclass
class Batch:
    """One fixed-shape batch of frames + aligned per-row metadata. The
    array fields are numpy on the host and tensors once placed."""

    frames: object  # [B, P, H, W]
    valid: object  # [B] uint8
    shard_rank: object  # [B] int32
    event_idx: object  # [B] int64
    photon_energy: object  # [B] float32
    num_valid: int = -1
    arena: Optional["Arena"] = None  # the host memory a batcher assembled this batch in
    copied_bytes: int = 0  # frame bytes the batcher copied into it

    def __post_init__(self):
        if self.num_valid < 0:
            self.num_valid = int(np.asarray(self.valid).sum())

    @property
    def batch_size(self) -> int:
        return len(self.frames)

    def arrays(self) -> tuple:
        return (self.frames, self.valid, self.shard_rank, self.event_idx, self.photon_energy)


def arena_layout(batch_size: int, frame_shape: tuple, dtype) -> list:
    """``(shape, dtype)`` of a batch's five arrays: the frames, then the
    metadata."""
    return [((batch_size, *frame_shape), np.dtype(dtype))] + [
        ((batch_size,), np.dtype(d)) for d in META_DTYPES]


class Arena:
    """One batch's host memory: ``arrays`` (numpy: the frames and the four
    metadata arrays) and, when the memory is pinned, ``tensors``: the same
    memory as CPU torch tensors, which the prefetcher copies to the card
    straight away. ``fence`` is the event recorded behind that copy (any
    object with ``synchronize()``); :meth:`wait` blocks on it."""

    __slots__ = ("arrays", "tensors", "fence")

    def __init__(self, arrays: tuple, tensors: Optional[tuple] = None):
        self.arrays = arrays
        self.tensors = tensors
        self.fence = None

    def wait(self) -> None:
        """Block until the last copy out of this arena has finished."""
        fence, self.fence = self.fence, None
        if fence is not None:
            fence.synchronize()


def host_arena(batch_size: int, frame_shape: tuple, dtype) -> Arena:
    """A pageable numpy arena."""
    return Arena(tuple(np.empty(shape, dt) for shape, dt in
                       arena_layout(batch_size, frame_shape, dtype)))


class FrameBatcher:
    """Accumulates FrameRecords into fixed-shape Batches.

    ``push`` copies the record into the batch arena at once and returns a
    completed Batch or None; ``push_view`` does the same and then releases
    the record's transport lease; ``flush`` pads and returns the tail. The
    frame shape and dtype are locked by the first record. ``new_arena``
    makes an arena (``(batch_size, frame_shape, dtype) -> Arena``;
    pageable numpy by default).

    ``n_buffers > 0`` makes all ``n_buffers`` arenas at the first record
    and reuses them round-robin; before writing into one the batcher waits
    on its ``fence``. On the CPU a batch's tensors alias its arena, so
    ``n_buffers`` must also exceed the number of batches alive downstream
    at once (``InfeedPipeline`` checks its bound).
    """

    def __init__(self, batch_size: int, n_buffers: int = 0,
                 new_arena: Callable[..., Arena] = host_arena):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.batch_size = batch_size
        self.n_buffers = n_buffers
        self.new_arena = new_arena
        self.dtype: Optional[np.dtype] = None
        self._frame_shape: Optional[tuple] = None
        self.pool: List[Arena] = []
        self._pool_i = 0
        self._cur: Optional[Arena] = None
        self._fill = 0
        self._copied = 0

    def _acquire(self) -> Arena:
        if self.n_buffers <= 0:
            return self.new_arena(self.batch_size, self._frame_shape, self.dtype)
        if not self.pool:
            self.pool = [self.new_arena(self.batch_size, self._frame_shape, self.dtype)
                         for _ in range(self.n_buffers)]
        arena = self.pool[self._pool_i % self.n_buffers]
        self._pool_i += 1
        arena.wait()  # its last copy to the card has finished
        return arena

    def push(self, rec: FrameRecord) -> Optional[Batch]:
        if self._frame_shape is None:
            self._frame_shape = rec.panels.shape
            self.dtype = rec.panels.dtype
        elif rec.panels.shape != self._frame_shape:
            raise ValueError(f"frame shape {rec.panels.shape} != locked shape {self._frame_shape}")
        if self._cur is None:
            self._cur = self._acquire()
            self._fill = 0
            self._copied = 0
        frames, valid, rank, idx, energy = self._cur.arrays
        i = self._fill
        frames[i] = rec.panels  # the consumer's one host copy of the frame
        self._copied += rec.panels.nbytes
        valid[i] = 1
        rank[i] = rec.shard_rank
        idx[i] = rec.event_idx
        energy[i] = rec.photon_energy
        self._fill += 1
        if self._fill == self.batch_size:
            return self._emit()
        return None

    def push_view(self, rec: FrameRecord) -> Optional[Batch]:
        """``push`` for zero-copy records: copy the panels into the arena,
        then release the record's lease (its shm ring slot). The release
        comes strictly after the copy, and also when the push raises; a
        no-op for records that own their data."""
        try:
            return self.push(rec)
        finally:
            rec.release()

    def flush(self) -> Optional[Batch]:
        """Pad + emit the tail batch; None when nothing pends."""
        if self._cur is None:
            return None
        return self._emit()

    @property
    def pending(self) -> int:
        return self._fill if self._cur is not None else 0

    def _emit(self) -> Batch:
        arena, n = self._cur, self._fill
        if n < self.batch_size:  # padded tail: zero only the padding rows
            for a in arena.arrays:
                a[n:] = 0
        self._cur = None
        self._fill = 0
        return Batch(*arena.arrays, num_valid=n, arena=arena, copied_bytes=self._copied)


def batches_from_queue(
    queue,
    batch_size: int,
    poll_interval_s: float = 0.01,
    max_wait_s: Optional[float] = None,
    stop=None,
    n_buffers: int = 0,
    batcher: Optional[FrameBatcher] = None,
) -> Iterator[Batch]:
    """Drain a queue into fixed-shape batches until end of stream.

    Pops with ``get_batch_view`` where the queue has it (the shm ring: each
    frame views its slot until ``push_view`` has copied it into the arena
    and released it), else ``get_batch``; either takes many items at once.
    Every record of a pop is copied and released before any batch is
    yielded, so a generator suspended at a yield holds no slot. The stream
    ends when the :class:`EosTally` covers every shard, or when the
    transport closes; the padded tail is yielded first. A wedged transport
    (a crashed peer) raises instead. ``max_wait_s`` bounds starvation
    (None: wait forever). ``stop`` (a ``threading.Event``) cancels from
    another thread without a flush. ``batcher`` is the
    :class:`FrameBatcher` to fill (default: one with ``n_buffers``, made at
    the first record).
    """
    starved_since: Optional[float] = None
    tally = EosTally()
    pop = getattr(queue, "get_batch_view", None) or queue.get_batch
    try:
        while True:
            if stop is not None and stop.is_set():
                return
            try:
                items = pop(batch_size, timeout=poll_interval_s)
            except TransportWedged:
                raise  # lost data, not a clean end of stream
            except TransportClosed:
                if batcher is not None and (tail := batcher.flush()) is not None:
                    yield tail
                return
            if not items:
                if tally.flush_duplicates(queue):
                    time.sleep(max(poll_interval_s, 0.02))
                now = time.monotonic()
                starved_since = starved_since if starved_since is not None else now
                if max_wait_s is not None and now - starved_since >= max_wait_s:
                    if batcher is not None and (tail := batcher.flush()) is not None:
                        yield tail
                    return
                continue
            starved_since = None
            tally.flush_duplicates(queue)
            ready: List[Batch] = []
            done = False
            for pos, item in enumerate(items):
                if isinstance(item, EndOfStream):
                    if tally.process(item):
                        # records popped after the completing marker belong
                        # to the queue (or are sibling markers): hand them
                        # back, each copied out of its slot first, since a
                        # put into a full ring would wait on that very slot
                        rest = []
                        for other in items[pos + 1:]:
                            if isinstance(other, EndOfStream):
                                tally.process(other)
                            else:
                                rest.append(other.materialize()
                                            if isinstance(other, FrameRecord) else other)
                        for other in rest:
                            queue.put_wait(other, timeout=1.0)
                        if batcher is not None and (tail := batcher.flush()) is not None:
                            ready.append(tail)
                        done = True
                        break
                    continue
                if batcher is None:
                    batcher = FrameBatcher(batch_size, n_buffers=n_buffers)
                out = batcher.push_view(item)
                if out is not None:
                    ready.append(out)
            del items
            yield from ready
            if done:
                return
    finally:
        tally.flush_duplicates(queue, final=True)
