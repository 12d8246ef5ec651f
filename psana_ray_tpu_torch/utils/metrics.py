"""Metrics: throughput meters, latency quantiles, per-stage histograms and
the one :class:`PipelineMetrics` of the port.

The port's copy of ``psana_ray_tpu/utils/metrics.py``: :class:`Meter`
(a count and its rate over a trailing 10 s window), :class:`LatencyStats`
(reservoir-sampled quantiles), :class:`StageTimes` (one histogram a stage
name of :mod:`psana_ray_tpu_torch.obs.stages`) and :class:`PipelineMetrics`
with the JAX package's surface (``observe_frame``, ``observe_batch``,
``attach_queue``, ``snapshot``, ``status_line``). The same class carries
what the infeed records: a warm-up left out of frames, bytes, times and
rates, the host seconds of its staging thread, its copy counts and
``summary()``. Thread-safe and free of torch, so a producer process can
afford it.
"""

from __future__ import annotations

import collections
import random
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np


def probe_queue_stats(queue) -> Dict:
    """The queue's ``stats()`` where it has one, else its depth alone.
    Raises what the queue raises."""
    stats = getattr(queue, "stats", None)
    if callable(stats):
        return dict(stats())
    return {"depth": queue.size()}


class Meter:
    """Monotonic counter + windowed rate. A meter compares equal to, and
    converts to, its count as an integer."""

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._count = 0  # guarded-by: _lock
        self._t0 = time.monotonic()
        self._window: collections.deque = collections.deque()  # (t, cumulative); guarded-by: _lock

    def add(self, n: int = 1):
        with self._lock:
            self._count += n
            now = time.monotonic()
            self._window.append((now, self._count))
            cutoff = now - 10.0
            while self._window and self._window[0][0] < cutoff:
                self._window.popleft()

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def rate(self) -> float:
        """Events/s over the trailing 10 s window (the lifetime rate while
        the window has fewer than 2 samples)."""
        with self._lock:
            if len(self._window) >= 2:
                (t_a, c_a), (t_b, c_b) = self._window[0], self._window[-1]
                if t_b > t_a:
                    return (c_b - c_a) / (t_b - t_a)
            dt = time.monotonic() - self._t0
            return self._count / dt if dt > 0 else 0.0

    def snapshot(self) -> Dict[str, float]:
        return {"total": self.count, "per_second": round(self.rate(), 3)}

    def __int__(self) -> int:
        return self.count

    def __eq__(self, other):
        if isinstance(other, int):
            return self.count == other
        return NotImplemented

    __hash__ = object.__hash__

    def __repr__(self) -> str:
        return f"Meter({self.name!r}, count={self.count})"


# exemplar bucket bounds in ms (upper-inclusive; the last is +inf)
EXEMPLAR_BUCKETS_MS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
    2500.0, float("inf"),
)


def _bucket_of(ms: float) -> int:
    for i, le in enumerate(EXEMPLAR_BUCKETS_MS):
        if ms <= le:
            return i
    return len(EXEMPLAR_BUCKETS_MS) - 1


class LatencyStats:
    """Reservoir-sampled latency quantiles (fixed memory, unbiased). The
    sorted view is cached until the next sample enters the reservoir.
    ``observe(seconds, exemplar=...)`` also keeps the last exemplar (a
    trace id) seen in each latency bucket."""

    def __init__(self, reservoir_size: int = 4096, seed: int = 0):
        self._lock = threading.Lock()
        self._size = reservoir_size
        self._n = 0  # guarded-by: _lock
        self._sum = 0.0  # guarded-by: _lock
        self._samples: List[float] = []  # guarded-by: _lock
        self._sorted: Optional[List[float]] = None  # guarded-by: _lock
        self._rng = random.Random(seed)
        self._exemplars: Dict[int, tuple] = {}  # bucket -> (trace id, ms); guarded-by: _lock

    def observe(self, seconds: float, exemplar: Optional[int] = None):
        with self._lock:
            self._n += 1
            self._sum += seconds
            if exemplar is not None:
                self._exemplars[_bucket_of(seconds * 1e3)] = (exemplar, seconds * 1e3)
            if len(self._samples) < self._size:
                self._samples.append(seconds)
                self._sorted = None
            else:
                j = self._rng.randrange(self._n)
                if j < self._size:
                    self._samples[j] = seconds
                    self._sorted = None

    def exemplars(self) -> Dict[str, Dict[str, float]]:
        """``{"le_<bound_ms>": {"trace_id": "0x...", "ms": ...}}`` for each
        bucket that holds one."""
        with self._lock:
            items = list(self._exemplars.items())
        out: Dict[str, Dict[str, float]] = {}
        for idx, (tid, ms) in items:
            le = EXEMPLAR_BUCKETS_MS[idx]
            label = "le_inf" if le == float("inf") else f"le_{le:g}"
            out[label] = {"trace_id": f"{int(tid):#x}", "ms": round(ms, 3)}
        return out

    def _sorted_view(self) -> List[float]:
        # guarded-by-caller: _lock
        if self._sorted is None:
            self._sorted = sorted(self._samples)
        return self._sorted

    def quantile(self, q: float) -> float:
        with self._lock:
            s = self._sorted_view()
            if not s:
                return float("nan")
            return s[min(len(s) - 1, max(0, int(q * len(s))))]

    def quantiles(self, qs: Sequence[float]) -> List[float]:
        """Every quantile asked for, under one lock and one sort."""
        with self._lock:
            s = self._sorted_view()
            if not s:
                return [float("nan")] * len(qs)
            return [s[min(len(s) - 1, max(0, int(q * len(s))))] for q in qs]

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    @property
    def mean(self) -> float:
        """The mean over every observation, not only the reservoir's."""
        with self._lock:
            return self._sum / self._n if self._n else float("nan")

    def summary_ms(self) -> Dict[str, float]:
        p50, p95, p99 = self.quantiles((0.50, 0.95, 0.99))
        return {"p50_ms": p50 * 1e3, "p95_ms": p95 * 1e3, "p99_ms": p99 * 1e3}

    def snapshot(self) -> Dict[str, float]:
        """JSON-safe summary; the quantile keys only once there are samples."""
        with self._lock:
            n, total = self._n, self._sum
            s = self._sorted_view()
        out: Dict[str, float] = {"count": n}
        if not s:
            return out
        out["mean_ms"] = round((total / n) * 1e3, 6)
        for name, q in (("p50_ms", 0.50), ("p95_ms", 0.95), ("p99_ms", 0.99)):
            out[name] = round(s[min(len(s) - 1, max(0, int(q * len(s))))] * 1e3, 6)
        ex = self.exemplars()
        if ex:
            out["exemplars"] = ex
        return out


class StageTimes:
    """One :class:`LatencyStats` a stage name, made at its first
    observation."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, LatencyStats] = {}  # guarded-by: _lock

    def observe(self, stage: str, seconds: float, exemplar: Optional[int] = None):
        with self._lock:
            st = self._stats.get(stage)
            if st is None:
                st = self._stats[stage] = LatencyStats()
        st.observe(seconds, exemplar=exemplar)

    def stat(self, stage: str) -> Optional[LatencyStats]:
        with self._lock:
            return self._stats.get(stage)

    def stages(self) -> List[str]:
        with self._lock:
            return sorted(self._stats)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            items = list(self._stats.items())
        return {name: st.snapshot() for name, st in items}


class PipelineMetrics:
    """One bundle per producer, consumer or pipeline.

    ``frames``, ``bytes`` and ``batches`` are :class:`Meter` s,
    ``step_latency`` the per-batch latency's quantiles and ``stages`` the
    per-stage histograms; :meth:`status_line` and :meth:`snapshot` render
    them with the depth of the queue attached.

    For the infeed: the first ``warmup`` batches are left out of frames,
    bytes, batches, latencies and rates (their allocations, a ring still
    filling), so a run reads at steady state; :meth:`observe_host` adds up
    the staging thread's seconds to assemble and to stage a batch (after
    the same warm-up); :meth:`observe_copies` counts every batch's frames
    staged (``staged_frames``), the frame bytes the host copied
    (``host_frame_bytes``) and the batches copied to the card straight from
    their pinned arena (``arena_copies``). ``latencies_s`` keeps the last
    ``window`` batch latencies, from which :meth:`summary` takes its
    quantiles."""

    def __init__(self, queue=None, window: int = 4096, warmup: int = 0):
        self.frames = Meter("frames")
        self.bytes = Meter("bytes")
        self.batches = Meter("batches")
        self.step_latency = LatencyStats()
        self.stages = StageTimes()
        self._queue = queue
        self.latencies_s = collections.deque(maxlen=window)
        self.staged = 0
        self.host_batch_s = 0.0
        self.host_stage_s = 0.0
        self.host_frame_bytes = 0
        self.staged_frames = 0
        self.arena_copies = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        # each skip is counted down by one thread only: the consumer's
        # batches and the staging thread's host observations
        self._skip_batches = warmup
        self._skip_host = warmup

    def attach_queue(self, queue):
        """Bind the queue whose depth :meth:`status_line` and
        :meth:`snapshot` report (None unbinds)."""
        self._queue = queue

    @property
    def has_queue(self) -> bool:
        return self._queue is not None

    def observe_frame(self, nbytes: int = 0):
        self.frames.add(1)
        if nbytes:
            self.bytes.add(nbytes)

    def observe_batch(self, n_frames: int, latency_s: float, nbytes: int = 0):
        if self._skip_batches > 0:
            self._skip_batches -= 1
            return
        now = time.monotonic()
        if self._t_first is None:
            self._t_first = now - latency_s
        self._t_last = now
        self.batches.add(1)
        self.frames.add(int(n_frames))
        if nbytes:
            self.bytes.add(int(nbytes))
        self.step_latency.observe(latency_s)
        self.latencies_s.append(latency_s)

    def observe_copies(self, num_valid: int, frame_bytes: int, from_arena: bool) -> None:
        self.staged_frames += int(num_valid)
        self.host_frame_bytes += int(frame_bytes)
        self.arena_copies += int(from_arena)

    def observe_host(self, batch_s: float, stage_s: float) -> None:
        if self._skip_host > 0:
            self._skip_host -= 1
            return
        self.staged += 1
        self.host_batch_s += batch_s
        self.host_stage_s += stage_s

    def latency_ms(self, q: float = 0.5) -> float:
        """The ``q`` quantile of the window's batch latencies, in ms."""
        if not self.latencies_s:
            return float("nan")
        return float(np.quantile(np.asarray(self.latencies_s), q) * 1e3)

    def fps(self) -> float:
        """Frames over the span from the first timed batch's start to the
        last one's end."""
        if self._t_first is None or self._t_last <= self._t_first:
            return float("nan")
        return self.frames.count / (self._t_last - self._t_first)

    def summary(self) -> dict:
        return {
            "frames": self.frames.count,
            "batches": self.batches.count,
            "bytes": self.bytes.count,
            "fps": self.fps(),
            "p50_ms": self.latency_ms(0.5),
            "p99_ms": self.latency_ms(0.99),
            "host_batch_ms": 1e3 * self.host_batch_s / max(self.staged, 1),
            "host_stage_ms": 1e3 * self.host_stage_s / max(self.staged, 1),
            "host_frame_bytes_per_frame": self.host_frame_bytes / max(self.staged_frames, 1),
            "arena_copies": self.arena_copies,
        }

    def _queue_stats(self) -> Optional[dict]:
        q = self._queue
        if q is None:
            return None
        try:
            return probe_queue_stats(q)
        except Exception:  # a dead queue: no depth to report
            return None

    def snapshot(self) -> dict:
        """JSON-safe nested dict of the meters, the latency, the stages and
        the queue's stats."""
        out = {
            "frames_total": self.frames.count,
            "frames_per_second": round(self.frames.rate(), 3),
            "bytes_total": self.bytes.count,
            "bytes_per_second": round(self.bytes.rate(), 3),
            "batches_total": self.batches.count,
            "batches_per_second": round(self.batches.rate(), 3),
            "step_latency": self.step_latency.snapshot(),
        }
        stages = self.stages.snapshot()
        if stages:
            out["stages"] = stages
        qs = self._queue_stats()
        if qs is not None:
            out["queue"] = qs
        return out

    def status_line(self) -> str:
        lat = self.step_latency.summary_ms()
        depth = ""
        if self._queue is not None:
            try:
                depth = f" depth={self._queue.size()}"
            except Exception:  # a dead queue
                depth = " depth=?"
        gbps = self.bytes.rate() * 8 / 1e9
        return (
            f"frames={self.frames.count} ({self.frames.rate():.1f}/s, {gbps:.2f} Gbit/s)"
            f" batches={self.batches.count}"
            f" p50={lat['p50_ms']:.2f}ms p99={lat['p99_ms']:.2f}ms{depth}"
        )
