"""Multi-detector fan-in: N detector streams -> one consumer loop.

The port's counterpart of ``psana_ray_tpu/infeed/fanin.py`` (BASELINE
config 5: epix10k2M and jungfrau4M streams fanned into one consumer).

- **One InfeedPipeline per detector.** Each detector keeps its own frame
  shape, batcher and (on the card) pinned batch arenas, so each step
  sees one shape and no batch pads a small detector's frames to a large
  one's.
- **Ready-ordered merge.** Each leg runs transport -> batcher -> staging
  on its own thread and deposits staged batches into one bounded merge
  queue; the consumer takes them in arrival order, so a fast detector
  never waits behind a slow one (no head-of-line blocking).
- **Per-detector steps.** ``run`` hands each batch to its detector's
  step.
- **The consumer's stream waits.** A leg's thread only stages: the event
  behind each batch's copy to the card travels with the batch through
  the merge queue, and the consumer's thread makes its own current
  stream wait on it (:func:`use_on_current_stream`), so a step run under
  ``torch.cuda.stream(s)`` sees the copied data.

EOS: each leg ends on its own queue's EOS; the loop ends when every leg
has. A leg's error is raised to the consumer as soon as that leg winds
down (batches of it still in the merge may be dropped), not deferred
until the healthy detectors also finish: a dead detector in a continuous
multi-run deployment must surface at once. A leg's error and its end
are flight-recorder events (``fanin_leg_error``, ``fanin_leg_done``), and
each leg's metrics are the ``infeed.<detector>`` source of the process's
metrics registry while the leg runs.
"""

from __future__ import annotations

import dataclasses
import logging
import queue as _queue
import threading
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Sequence, Tuple

from psana_ray_tpu_torch.infeed.batcher import Batch
from psana_ray_tpu_torch.infeed.pipeline import (
    InfeedPipeline,
    StopStream,
    drive_step,
    use_on_current_stream,
)
from psana_ray_tpu_torch.obs.flight import FLIGHT
from psana_ray_tpu_torch.utils.metrics import PipelineMetrics

log = logging.getLogger(__name__)


@dataclasses.dataclass
class DetectorStream:
    """One detector's leg of the fan-in: its transport queue and batching
    geometry. ``device`` ``None`` stages batches on the card; ``"cpu"``
    gives CPU tensors that view the batcher's arrays (a host-only leg).
    ``batcher_buffers > 0`` pools that many batch arenas (pinned on the
    card); :class:`FanInPipeline` requires at least ``prefetch_depth`` +
    the merge's capacity + 4."""

    name: str
    queue: Any
    batch_size: int
    device: Any = None
    prefetch_depth: int = 2
    poll_interval_s: float = 0.01
    max_wait_s: Optional[float] = None
    batcher_buffers: int = 0


class FanInPipeline:
    """Merge N detector streams into one consumer iterator.

    Iteration yields ``(detector_name, batch)`` in arrival order until
    every stream has delivered EOS. ``run(steps)`` drives a mapping of
    per-detector step callables and returns per-detector frame counts.
    ``pipes`` and ``metrics`` hold each leg's :class:`InfeedPipeline` and
    its :class:`PipelineMetrics`.
    """

    _DONE = object()

    def __init__(self, streams: Sequence[DetectorStream], merge_depth: int = 2):
        if not streams:
            raise ValueError("need at least one DetectorStream")
        names = [s.name for s in streams]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate detector names: {names}")
        self.streams = list(streams)
        merge_maxsize = max(1, merge_depth) * len(self.streams)
        for s in self.streams:
            floor = s.prefetch_depth + merge_maxsize + 4
            if 0 < s.batcher_buffers < floor:
                # worst case every merge slot holds this leg's batches on
                # top of its own prefetch queue + consumer + fill + the
                # batch source's deferred un-yielded batch + margin
                raise ValueError(
                    f"stream {s.name!r}: batcher_buffers={s.batcher_buffers} "
                    f"can recycle a batch still alive in the merge; need "
                    f">= prefetch_depth + merge capacity + 4 = {floor}"
                )
        self.pipes: Dict[str, InfeedPipeline] = {}
        try:
            for s in self.streams:
                self.pipes[s.name] = InfeedPipeline(
                    s.queue,
                    s.batch_size,
                    device=s.device,
                    prefetch_depth=s.prefetch_depth,
                    poll_interval_s=s.poll_interval_s,
                    max_wait_s=s.max_wait_s,
                    batcher_buffers=s.batcher_buffers,
                    name=s.name,  # the infeed.<detector> metrics source
                )
        except BaseException:
            # a later leg failed to build; already-started legs are live
            # threads draining real queues: stop them before surfacing
            for pipe in self.pipes.values():
                pipe.close()
            raise
        self.metrics: Dict[str, PipelineMetrics] = {
            name: pipe.metrics for name, pipe in self.pipes.items()
        }
        # bounded so a stalled consumer backpressures every leg's
        # prefetcher rather than buffering unbounded staged batches
        self._merge: _queue.Queue = _queue.Queue(maxsize=merge_maxsize)
        self._stop = threading.Event()
        self._errors: list = []
        self._threads = [
            threading.Thread(
                target=self._pump, args=(s.name,), name=f"fanin-{s.name}", daemon=True
            )
            for s in self.streams
        ]
        self._live = len(self._threads)
        for t in self._threads:
            t.start()

    def _pump(self, name: str):
        pipe = self.pipes[name]
        try:
            for batch, event in pipe.staged():
                if not self._put((name, batch, event)):
                    return
        except BaseException as e:  # noqa: BLE001 (re-raised in the consumer)
            log.error("fan-in leg %r failed: %r", name, e)
            FLIGHT.record("fanin_leg_error", leg=name, error=repr(e))
            self._errors.append(e)
        finally:
            FLIGHT.record("fanin_leg_done", leg=name)
            pipe.close()
            self._put((name, self._DONE, None), force=True)

    def _put(self, item, force: bool = False) -> bool:
        """Bounded put. A full queue backpressures (the consumer is
        draining it); entries are only sacrificed to make room for a
        forced DONE marker once the consumer is gone (``close()`` set
        ``_stop`` and stopped draining)."""
        while True:
            stopped = self._stop.is_set()
            if stopped and not force:
                return False
            try:
                self._merge.put(item, timeout=0.05)
                return True
            except _queue.Full:
                if stopped and force:
                    try:
                        self._merge.get_nowait()
                    except _queue.Empty:
                        pass

    def __iter__(self) -> Iterator[Tuple[str, Batch]]:
        while self._live > 0:
            try:
                name, item, event = self._merge.get(timeout=0.05)
            except _queue.Empty:
                # a cross-thread close() may have drained DONE markers we
                # were counting on: checking _stop here keeps a blocked
                # consumer from waiting on markers that will never come
                if self._stop.is_set():
                    return
                continue
            if item is self._DONE:
                self._live -= 1
                if self._errors:
                    raise self._errors[0]
                continue
            yield name, use_on_current_stream(item, event)

    def close(self):
        """Stop every leg (unblocking pump threads parked on starved
        prefetchers) and release buffered batches."""
        self._stop.set()
        for pipe in self.pipes.values():
            pipe.close()
        try:
            while True:
                self._merge.get_nowait()
        except _queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def run(
        self,
        steps: Mapping[str, Callable[[Batch], Any]],
        on_result: Optional[Callable] = None,
        block_until_ready: bool = False,
    ) -> Dict[str, int]:
        """Drive per-detector ``steps`` until every stream's EOS.

        Each batch goes to ``steps[detector_name]``; a detector without a
        step raises ``KeyError`` before any batch is taken. ``on_result(name,
        out, batch)`` is called after each step. Returns
        ``{detector_name: frames_processed}``; the pipeline is closed on
        exit, normal or not.
        """
        missing = {s.name for s in self.streams} - set(steps)
        if missing:
            self.close()  # a config error must not leave legs draining queues
            raise KeyError(f"no step for detector(s): {sorted(missing)}")
        counts = {s.name: 0 for s in self.streams}
        try:
            for name, batch in self:
                out = drive_step(self.metrics[name], steps[name], batch, block_until_ready)
                counts[name] += batch.num_valid
                if on_result is not None:
                    on_result(name, out, batch)
        except StopStream:
            pass  # consumer-side early stop; close() below
        finally:
            self.close()
        return counts
