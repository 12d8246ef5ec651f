"""Device prefetch + the end-to-end infeed pipeline.

The port's counterpart of ``psana_ray_tpu/infeed/pipeline.py``. A
background thread stages the next ``prefetch_depth`` batches onto the
card while the current batch computes:

- with pooled batch arenas (``InfeedPipeline(batcher_buffers > 0)``) on
  the card, the arenas are **pinned** and allocated once, at the first
  record. The batcher copies each frame once, into its row of an arena;
  the H2D copy goes straight from the arena with ``non_blocking=True`` on
  a side stream, and the event recorded behind it is the arena's fence:
  the batcher refills the arena only after it has fired;
- without them (``batcher_buffers=0``, the JAX package's default) every
  batch gets a fresh pageable arena, which is copied a second time on the
  host, into one of a small ring of pinned buffers, and from there to the
  card; a pinned buffer is refilled only after its last copy's event;
- the consumer's stream waits on the copy's event (``wait_event``) before
  using the batch, and every device tensor gets ``record_stream`` so the
  allocator does not recycle it under the consumer's work.

On ``device="cpu"`` batches become CPU tensors (zero-copy views of the
batcher's arrays). With ``stage_meta=False`` only the frames go to the
device; the per-row metadata (``valid``, ``shard_rank``, ``event_idx``,
``photon_energy``) stays in host numpy arrays, for consumers that use it
on the host and must not read it back from the card. Errors in the
staging thread surface in the consumer. The staging thread times its two
host stages per batch (assembling the batch from the queue, staging it
to the card) into the pipeline's :class:`PipelineMetrics`, and counts the
frame bytes the host copied and the batches copied to the card straight
from their arena. On the profiler's timeline each batch's H2D enqueue is
a ``stage.device_put`` range and each step a ``stage.dispatch`` range
(:func:`~psana_ray_tpu_torch.utils.trace.annotate_stage`).
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from psana_ray_tpu_torch.device import resolve_device
from psana_ray_tpu_torch.infeed.batcher import (
    Arena,
    Batch,
    FrameBatcher,
    arena_layout,
    batches_from_queue,
    host_arena,
)
from psana_ray_tpu_torch.obs.stages import STAGE_DEVICE_PUT, STAGE_DISPATCH
from psana_ray_tpu_torch.utils.hostmem import enable_large_alloc_reuse
from psana_ray_tpu_torch.utils.metrics import PipelineMetrics
from psana_ray_tpu_torch.utils.trace import annotate_stage


def pinned_arena(batch_size: int, frame_shape: tuple, dtype) -> Arena:
    """A batch arena in pinned (page-locked) host memory: torch tensors
    from ``pin_memory=True`` with numpy views of the same memory, which
    the batcher writes and the prefetcher copies to the card."""
    tensors = tuple(
        torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dt)).dtype, pin_memory=True)
        for shape, dt in arena_layout(batch_size, frame_shape, dtype))
    return Arena(tuple(t.numpy() for t in tensors), tensors)


class StopStream(Exception):
    """Raise from a ``run()`` step to end the loop early (consumer-side
    stop); ``run()`` closes the pipeline and returns the count so far."""


class _PinnedSlot:
    __slots__ = ("host", "event")

    def __init__(self):
        self.host: Optional[tuple] = None
        self.event: Optional[torch.cuda.Event] = None


class DevicePrefetcher:
    """Wrap a host Batch iterator; yield batches resident on ``device``.

    Always ``close()`` it (or use it as a context manager, or exhaust it):
    an abandoned prefetcher pins its staged batches and its thread."""

    def __init__(
        self,
        batches: Iterator[Batch],
        device=None,
        prefetch_depth: int = 2,
        stop_event: Optional[threading.Event] = None,
        metrics: Optional[PipelineMetrics] = None,
        stage_meta: bool = True,
    ):
        if prefetch_depth < 1:
            raise ValueError("prefetch_depth must be >= 1")
        self.device = resolve_device(device)
        self.metrics = metrics if metrics is not None else PipelineMetrics()
        self.stage_meta = stage_meta
        self._src = batches
        self.prefetch_depth = prefetch_depth
        self._buf: _queue.Queue = _queue.Queue(maxsize=prefetch_depth)
        self._err: Optional[BaseException] = None
        self._stop = stop_event if stop_event is not None else threading.Event()
        self._done = False
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(self.device)
            self._slots = [_PinnedSlot() for _ in range(prefetch_depth + 1)]
            self._slot_i = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _stage(self, batch: Batch):
        """Host batch -> (device batch, copy-done event or None, frame
        bytes copied on the host, whether it went straight from a pinned
        arena)."""
        arrays = batch.arrays() if self.stage_meta else batch.arrays()[:1]
        arena = batch.arena
        direct = self._cuda and arena is not None and arena.tensors is not None
        if direct:  # one H2D from the pinned arena, no host copy
            staged, event = self._to_device(arena.tensors[:len(arrays)])
            arena.fence = event
            copied = 0
        else:
            staged, event = self._stage_arrays(arrays)
            copied = batch.frames.nbytes if self._cuda else 0
        if not self.stage_meta:
            # the metadata stays on the host, copied: a pooled batcher reuses its arrays
            staged = [staged[0], *(np.array(a) for a in batch.arrays()[1:])]
        return Batch(*staged, num_valid=batch.num_valid), event, copied, direct

    def _to_device(self, tensors):
        """Pinned host tensors -> (tensors on the card, the copy's event),
        copied on the side stream."""
        with torch.cuda.stream(self._copy_stream):
            dev = [t.to(self.device, non_blocking=True) for t in tensors]
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return dev, event

    def _stage_arrays(self, arrays):
        """Host arrays -> (tensors on the device, copy-done event or None);
        on the card through the next pinned slot, a host copy."""
        if not self._cuda:
            return [torch.from_numpy(a) for a in arrays], None
        slot = self._slots[self._slot_i % len(self._slots)]
        self._slot_i += 1
        if slot.event is not None:
            slot.event.synchronize()  # its last H2D copy has finished
        arrays = [np.ascontiguousarray(a) for a in arrays]
        if slot.host is None or any(
            h.shape != a.shape or h.numpy().dtype != a.dtype for h, a in zip(slot.host, arrays)
        ):
            slot.host = tuple(
                torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype, pin_memory=True)
                for a in arrays
            )
        for h, a in zip(slot.host, arrays):
            h.copy_(torch.from_numpy(a))
        dev, event = self._to_device(slot.host)
        slot.event = event
        return dev, event

    def _put(self, item) -> bool:
        """Bounded put that gives up when close() is called."""
        while not self._stop.is_set():
            try:
                self._buf.put(item, timeout=0.05)
                return True
            except _queue.Full:
                continue
        return False

    def _run(self):
        try:
            src = iter(self._src)
            while True:
                t0 = time.monotonic()
                batch = next(src, None)  # queue pops + batcher copies
                if batch is None:
                    break
                t1 = time.monotonic()
                with annotate_stage(STAGE_DEVICE_PUT):
                    staged, event, copied, direct = self._stage(batch)  # H2D enqueue
                self.metrics.observe_host(t1 - t0, time.monotonic() - t1)
                self.metrics.observe_copies(batch.num_valid, batch.copied_bytes + copied, direct)
                if not self._put((staged, event)):
                    return
        except BaseException as e:  # surfaced in the consumer's __next__
            self._err = e
        finally:
            self._put(None)

    def set_prefetch_depth(self, n: int) -> int:
        """Resize the staging queue live; staged batches are never dropped.
        Returns the depth now in effect."""
        n = max(1, int(n))
        with self._buf.mutex:
            self._buf.maxsize = n
            self._buf.not_full.notify_all()
        self.prefetch_depth = n
        return n

    def close(self, timeout: float = 5.0):
        """Stop the staging thread and release staged batches."""
        self._stop.set()
        try:
            while True:
                self._buf.get_nowait()
        except _queue.Empty:
            pass
        self._thread.join(timeout=timeout)
        try:
            self._buf.put_nowait(None)
        except _queue.Full:
            pass
        self._done = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        return use_on_current_stream(*self.next_staged())

    def next_staged(self) -> tuple:
        """The next ``(batch, event)``: the batch on the device and the
        event behind its copy (None off the card), without waiting on it;
        the thread that uses the batch passes both to
        :func:`use_on_current_stream`. Raises ``StopIteration`` at the end
        of the stream, and the staging thread's error if it failed."""
        if self._done:
            raise StopIteration
        item = self._buf.get()
        if item is None:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def use_on_current_stream(batch: Batch, event) -> Batch:
    """Make the calling thread's current stream wait for ``event`` (the
    batch's copy to the card) and mark every device tensor of the batch as
    used on that stream, so that the allocator does not recycle it under
    the consumer's work; returns the batch. A no-op for ``event=None``."""
    if event is not None:
        stream = torch.cuda.current_stream(batch.frames.device)
        stream.wait_event(event)
        for t in batch.arrays():
            if torch.is_tensor(t):
                t.record_stream(stream)
    return batch


def _frames_nbytes(frames) -> int:
    return int(frames.numel() * frames.element_size()) if torch.is_tensor(frames) else int(
        getattr(frames, "nbytes", 0))


def drive_step(
    metrics: PipelineMetrics,
    step: Callable[[Batch], Any],
    batch: Batch,
    block_until_ready: bool = False,
):
    """Run one step over a device batch and record frames, bytes and
    latency. ``block_until_ready`` synchronises the batch's stream, making
    the latency a true per-batch device latency instead of enqueue time."""
    t0 = time.monotonic()
    with annotate_stage(STAGE_DISPATCH):
        out = step(batch)
        if block_until_ready and torch.is_tensor(batch.frames) and batch.frames.is_cuda:
            torch.cuda.current_stream(batch.frames.device).synchronize()
    metrics.observe_batch(batch.num_valid, time.monotonic() - t0, _frames_nbytes(batch.frames))
    return out


class _Either:
    """``is_set()`` of any of several events."""

    def __init__(self, *events):
        self.events = [e for e in events if e is not None]

    def is_set(self) -> bool:
        return any(e.is_set() for e in self.events)


class InfeedPipeline:
    """queue -> batcher -> device prefetch -> step function.

    ``batcher_buffers > 0`` pools that many batch arenas, pinned on the
    card (see the module docstring); it must be at least
    ``prefetch_depth + 4``. ``stage_meta=False`` keeps the per-row
    metadata on the host; ``stop`` (a ``threading.Event``) ends the stream
    from another thread. The constructor raises glibc's mmap threshold
    (:func:`enable_large_alloc_reuse`), as the JAX package's consumer
    does at start."""

    def __init__(
        self,
        queue,
        batch_size: int,
        device=None,
        prefetch_depth: int = 2,
        poll_interval_s: float = 0.01,
        max_wait_s: Optional[float] = None,
        metrics: Optional[PipelineMetrics] = None,
        batcher_buffers: int = 0,
        stage_meta: bool = True,
        stop=None,
    ):
        if batcher_buffers > 0 and batcher_buffers < prefetch_depth + 4:
            # the floor where tensors alias their arena (the CPU): alive at
            # once are prefetch_depth queued + 1 with the consumer + 1 being
            # filled + 1 un-yielded in the batch source + 1 margin. On the
            # card the arena's fence is what guards it.
            raise ValueError(
                f"batcher_buffers={batcher_buffers} can recycle a batch still alive "
                f"downstream; need >= prefetch_depth + 4 = {prefetch_depth + 4}"
            )
        enable_large_alloc_reuse()
        device = resolve_device(device)
        self.queue = queue
        self.batch_size = batch_size
        self._batcher_buffers = batcher_buffers
        self.metrics = metrics if metrics is not None else PipelineMetrics()
        halt = threading.Event()
        pinned = device.type == "cuda" and batcher_buffers > 0
        self.batcher = FrameBatcher(batch_size, n_buffers=batcher_buffers,
                                    new_arena=pinned_arena if pinned else host_arena)
        self._batches = batches_from_queue(
            queue, batch_size, poll_interval_s=poll_interval_s, max_wait_s=max_wait_s,
            stop=_Either(halt, stop), batcher=self.batcher,
        )
        self._prefetcher = DevicePrefetcher(
            self._batches, device=device, prefetch_depth=prefetch_depth, stop_event=halt,
            metrics=self.metrics, stage_meta=stage_meta,
        )
        self.device = self._prefetcher.device

    def __iter__(self) -> Iterator[Batch]:
        return iter(self._prefetcher)

    def staged(self) -> Iterator[tuple]:
        """``(batch, event)`` pairs with no wait on the copy's event: for a
        consumer that hands each batch to another thread, which calls
        :func:`use_on_current_stream` on its own stream."""
        while True:
            try:
                yield self._prefetcher.next_staged()
            except StopIteration:
                return

    @property
    def prefetch_depth(self) -> int:
        return self._prefetcher.prefetch_depth

    def set_prefetch_depth(self, n: int) -> int:
        """Live prefetch-depth dial, clipped to ``batcher_buffers - 4``
        when batch arenas are pooled. Returns the depth now in effect."""
        n = max(1, int(n))
        if self._batcher_buffers > 0:
            n = min(n, max(1, self._batcher_buffers - 4))
        return self._prefetcher.set_prefetch_depth(n)

    def close(self):
        self._prefetcher.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def run(
        self,
        step: Callable[[Batch], Any],
        on_result: Optional[Callable] = None,
        block_until_ready: bool = False,
    ) -> int:
        """Drive ``step`` over every batch until end of stream; returns the
        frames seen. The pipeline is closed on exit, normal or not."""
        n = 0
        try:
            for batch in self:
                out = drive_step(self.metrics, step, batch, block_until_ready)
                n += batch.num_valid
                if on_result is not None:
                    on_result(out, batch)
        except StopStream:
            pass
        finally:
            self.close()
        return n
