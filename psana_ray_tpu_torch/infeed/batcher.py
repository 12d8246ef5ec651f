"""Fixed-shape batching with zero padding and a validity mask.

The port's copy of what the serving path needs from
``psana_ray_tpu/infeed/batcher.py``. The batcher assembles ``[B, P, H, W]``
stacks; at end of stream the tail batch is padded to B with zero rows and
``valid`` marks the real ones, so the model always sees one shape.
``num_valid`` is a host int, so counting rows never syncs the device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Optional

import numpy as np

from psana_ray_tpu_torch.records import EndOfStream, EosTally, FrameRecord
from psana_ray_tpu_torch.transport.ring import TransportClosed


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

    def __post_init__(self):
        if self.num_valid < 0:
            self.num_valid = int(np.asarray(self.valid).sum())

    @property
    def batch_size(self) -> int:
        return len(self.frames)

    def arrays(self) -> tuple:
        return (self.frames, self.valid, self.shard_rank, self.event_idx, self.photon_energy)


class FrameBatcher:
    """Accumulates FrameRecords into fixed-shape Batches.

    ``push`` copies the record into the batch buffer at once and returns a
    completed Batch or None; ``flush`` pads and returns the tail. The frame
    shape and dtype are locked by the first record. ``n_buffers > 0``
    reuses that many preallocated buffer sets round-robin: a pooled Batch
    is overwritten
    ``n_buffers`` batches later, so ``n_buffers`` must exceed the number of
    batches alive downstream at once (``InfeedPipeline`` checks its bound).
    """

    def __init__(self, batch_size: int, n_buffers: int = 0):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.batch_size = batch_size
        self.n_buffers = n_buffers
        self.dtype: Optional[np.dtype] = None
        self._frame_shape: Optional[tuple] = None
        self._pool: List[tuple] = []
        self._pool_i = 0
        self._cur: Optional[tuple] = None
        self._fill = 0

    def _alloc(self) -> tuple:
        b = self.batch_size
        return (
            np.empty((b, *self._frame_shape), dtype=self.dtype),
            np.empty((b,), np.uint8),
            np.empty((b,), np.int32),
            np.empty((b,), np.int64),
            np.empty((b,), np.float32),
        )

    def _acquire(self) -> tuple:
        if self.n_buffers > 0:
            if not self._pool:
                self._pool = [self._alloc() for _ in range(self.n_buffers)]
            buf = self._pool[self._pool_i % self.n_buffers]
            self._pool_i += 1
            return buf
        return self._alloc()

    def push(self, rec: FrameRecord) -> Optional[Batch]:
        if self._frame_shape is None:
            self._frame_shape = rec.panels.shape
            self.dtype = rec.panels.dtype
        elif rec.panels.shape != self._frame_shape:
            raise ValueError(f"frame shape {rec.panels.shape} != locked shape {self._frame_shape}")
        if self._cur is None:
            self._cur = self._acquire()
            self._fill = 0
        frames, valid, rank, idx, energy = self._cur
        i = self._fill
        frames[i] = rec.panels
        valid[i] = 1
        rank[i] = rec.shard_rank
        idx[i] = rec.event_idx
        energy[i] = rec.photon_energy
        self._fill += 1
        if self._fill == self.batch_size:
            return self._emit()
        return None

    def flush(self) -> Optional[Batch]:
        """Pad + emit the tail batch; None when nothing pends."""
        if self._cur is None:
            return None
        return self._emit()

    @property
    def pending(self) -> int:
        return self._fill if self._cur is not None else 0

    def _emit(self) -> Batch:
        frames, valid, rank, idx, energy = self._cur
        n = self._fill
        if n < self.batch_size:  # padded tail: zero only the padding rows
            for a in (frames, valid, rank, idx, energy):
                a[n:] = 0
        self._cur = None
        self._fill = 0
        return Batch(frames, valid, rank, idx, energy, num_valid=n)


def batches_from_queue(
    queue,
    batch_size: int,
    poll_interval_s: float = 0.01,
    max_wait_s: Optional[float] = None,
    stop=None,
    n_buffers: int = 0,
) -> Iterator[Batch]:
    """Drain a queue into fixed-shape batches until end of stream.

    Pops with ``get_batch`` (one lock acquisition for many items). The
    stream ends when the :class:`EosTally` covers every shard, or when the
    transport closes; the padded tail is yielded first. ``max_wait_s``
    bounds starvation (None: wait forever). ``stop`` (a
    ``threading.Event``) cancels from another thread without a flush.
    """
    batcher: Optional[FrameBatcher] = None
    starved_since: Optional[float] = None
    tally = EosTally()
    try:
        while True:
            if stop is not None and stop.is_set():
                return
            try:
                items = queue.get_batch(batch_size, timeout=poll_interval_s)
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
                        # to the queue (or are sibling markers): hand back
                        for rest in items[pos + 1:]:
                            if isinstance(rest, EndOfStream):
                                tally.process(rest)
                            else:
                                queue.put_wait(rest, timeout=1.0)
                        if batcher is not None and (tail := batcher.flush()) is not None:
                            ready.append(tail)
                        done = True
                        break
                    continue
                if batcher is None:
                    batcher = FrameBatcher(batch_size, n_buffers=n_buffers)
                out = batcher.push(item)
                if out is not None:
                    ready.append(out)
            del items
            yield from ready
            if done:
                return
    finally:
        tally.flush_duplicates(queue, final=True)
