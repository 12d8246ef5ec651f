"""The measured window and the program's per-batch record.

:func:`recorder` makes the program's own ``PipelineMetrics`` with every
batch's observation also kept here, whole: when the batch's result
reached the host (``observe_batch``: the program's latency from dispatch
to result, and its frames) and the staging thread's seconds to assemble
and stage it (``observe_host``). Nothing is sampled.

:class:`Window` opens when the warm-up's last batch has completed and
closes at the first completion ``seconds`` later; a batch counts when
its result reached the host inside ``(t0, t1]``. Opening and closing
call the hooks given (the source's stop, the traced run's markers).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, List, Optional, Tuple


class Window:
    def __init__(self, seconds: float, warmup_batches: int,
                 on_open: Optional[Callable[[], float]] = None,
                 on_close: Optional[Callable[[], float]] = None):
        self.seconds = float(seconds)
        self.warmup_batches = int(warmup_batches)
        self.on_open, self.on_close = on_open, on_close
        self.t0: Optional[float] = None  # the window's start and end (monotonic s)
        self.t1: Optional[float] = None
        self.opened_at: Optional[float] = None  # when the hooks ran
        self.closed_at: Optional[float] = None
        self.batches: List[Tuple[float, int, float]] = []  # (done, frames, latency s)
        self.host: List[Tuple[float, float, float]] = []  # (done, batch s, stage s)
        self._lock = threading.Lock()

    @property
    def is_open(self) -> bool:
        return self.t0 is not None and self.closed_at is None

    def batch_done(self, t: float, frames: int, latency_s: float) -> None:
        self.batches.append((t, frames, latency_s))
        if self.t0 is None and len(self.batches) == self.warmup_batches:
            self.t0, self.t1 = t, t + self.seconds
            self.opened_at = self.on_open() if self.on_open else t
        elif self.t1 is not None and self.closed_at is None and t >= self.t1:
            self.closed_at = self.on_close() if self.on_close else t

    def host_done(self, t: float, batch_s: float, stage_s: float) -> None:
        with self._lock:
            self.host.append((t, batch_s, stage_s))

    def in_window(self) -> List[Tuple[float, int, float]]:
        """The batches whose result reached the host inside the window."""
        if self.t0 is None:
            return []
        return [b for b in self.batches if self.t0 < b[0] <= self.t1]

    def summary(self) -> dict:
        """What the window saw besides the metrics: the frames completed a
        second, the median batch latency and the staging thread's host ms a
        batch (assembling, staging)."""
        rows = self.in_window()
        host = self.host_between(self.t0, self.t1) if rows else []
        lat = sorted(lat for _, _, lat in rows)
        return {
            "window_frames_per_s": sum(n for _, n, _ in rows) / self.seconds,
            "batch_p50_ms": 1e3 * lat[len(lat) // 2] if lat else None,
            "host_batch_ms": 1e3 * sum(h[1] for h in host) / len(host) if host else None,
            "host_stage_ms": 1e3 * sum(h[2] for h in host) / len(host) if host else None,
        }

    def host_between(self, lo: float, hi: float) -> List[Tuple[float, float, float]]:
        with self._lock:
            return [h for h in self.host if lo < h[0] <= hi]


def recorder(window: Window):
    """The program's ``PipelineMetrics``, with each observation also handed
    to ``window``."""
    from psana_ray_tpu_torch.utils.metrics import PipelineMetrics

    class Recorder(PipelineMetrics):
        def observe_batch(self, n_frames: int, latency_s: float, nbytes: int = 0):
            super().observe_batch(n_frames, latency_s, nbytes)
            window.batch_done(time.monotonic(), int(n_frames), float(latency_s))

        def observe_host(self, batch_s: float, stage_s: float) -> None:
            super().observe_host(batch_s, stage_s)
            window.host_done(time.monotonic(), float(batch_s), float(stage_s))

    return Recorder()


class Sample:
    """A reservoir of ``k`` items drawn with the run's seed from those
    offered while the window is open: the batches the comparison reads."""

    def __init__(self, seed: int, k: int):
        self.k = int(k)
        self.items: list = []
        self.offered = 0
        self._rng = random.Random(int(seed))

    def offer(self, item) -> None:
        self.offered += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self._rng.randrange(self.offered)
            if j < self.k:
                self.items[j] = item
