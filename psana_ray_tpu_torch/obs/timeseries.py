# lint: hot-path
"""The process's metrics history: a bounded ring of registry snapshots.

The port's copy of ``psana_ray_tpu/obs/timeseries.py``. A
:class:`HistorySampler` thread flattens the process's
:class:`~psana_ray_tpu_torch.obs.registry.MetricsRegistry` snapshot every
interval (the grammar of the Prometheus renderer,
:func:`~psana_ray_tpu_torch.obs.registry.flatten_numeric`) into one
:class:`SeriesRing` a key.

- bounded: a ring a key, of fixed capacity, in preallocated
  ``array('d')`` columns;
- nothing allocated on a sample: :meth:`SeriesRing.append` is index
  arithmetic; a ring is allocated once, when its key first appears;
- views at read time: delta, windowed rate, EWMA and percentile are
  computed from the ring when asked.

The flight recorder appends :meth:`TimeSeriesStore.tail` to every dump.
Pure stdlib.
"""

from __future__ import annotations

import threading
import time
from array import array
from typing import Dict, List, Optional, Tuple

from psana_ray_tpu_torch.obs.registry import MetricsRegistry, flatten_numeric

__all__ = [
    "SeriesRing",
    "TimeSeriesStore",
    "HistorySampler",
    "add_history_args",
    "configure_history_from_args",
    "default_history",
    "start_default_history",
    "stop_default_history",
]

DEFAULT_CAPACITY = 600  # 10 minutes at the default 1 s interval
DEFAULT_INTERVAL_S = 1.0


class SeriesRing:
    """A fixed-capacity ``(t, value)`` ring for one key: twin preallocated
    ``array('d')`` columns; append is two indexed stores."""

    __slots__ = ("_t", "_v", "_cap", "_n", "_i")

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity <= 1:
            raise ValueError("SeriesRing capacity must be > 1")
        self._cap = int(capacity)
        self._t = array("d", [0.0]) * self._cap
        self._v = array("d", [0.0]) * self._cap
        self._n = 0  # samples held (saturates at _cap)
        self._i = 0  # next write slot

    def append(self, t: float, v: float) -> None:  # lint: sample-path
        i = self._i
        self._t[i] = t
        self._v[i] = v
        self._i = i + 1 if i + 1 < self._cap else 0
        if self._n < self._cap:
            self._n += 1

    def __len__(self) -> int:
        return self._n

    @property
    def capacity(self) -> int:
        return self._cap

    def samples(self, n: Optional[int] = None) -> List[Tuple[float, float]]:
        """The last ``n`` ``(t, value)`` pairs in time order (all for None)."""
        count = self._n if n is None else min(int(n), self._n)
        if count <= 0:
            return []
        start = (self._i - count) % self._cap
        out = []
        for k in range(count):
            j = (start + k) % self._cap
            out.append((self._t[j], self._v[j]))
        return out

    def last(self) -> Optional[Tuple[float, float]]:
        if not self._n:
            return None
        j = (self._i - 1) % self._cap
        return (self._t[j], self._v[j])


class TimeSeriesStore:
    """``{key: SeriesRing}`` and the views computed when read."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._capacity = int(capacity)
        self._lock = threading.Lock()
        self._rings: Dict[str, SeriesRing] = {}  # guarded-by: _lock
        self._samples_total = 0  # guarded-by: _lock
        self._last_t = 0.0  # guarded-by: _lock

    def record(self, tree: dict, now: Optional[float] = None) -> int:
        """Append every numeric leaf of one snapshot tree to its ring (a
        ring is made only at a key's first sight); returns the keys
        written."""
        now = time.time() if now is None else now
        leaves: List[Tuple[str, float]] = []
        flatten_numeric((), tree, leaves)
        with self._lock:
            rings = self._rings
            for key, value in leaves:
                ring = rings.get(key)
                if ring is None:
                    ring = rings[key] = SeriesRing(self._capacity)
                ring.append(now, value)
            self._samples_total += 1
            self._last_t = now
        return len(leaves)

    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._rings)

    def series(self, key: str, n: Optional[int] = None) -> List[Tuple[float, float]]:
        # copied out under the lock: a record() moving the head would tear it
        with self._lock:
            ring = self._rings.get(key)
            return ring.samples(n) if ring is not None else []

    def last(self, key: str) -> Optional[float]:
        with self._lock:
            ring = self._rings.get(key)
            lt = ring.last() if ring is not None else None
        return lt[1] if lt is not None else None

    def delta(self, key: str, window_s: Optional[float] = None) -> Optional[float]:
        """Last value minus the first inside the window (the whole ring
        for None); None with fewer than 2 samples."""
        pts = self._window(key, window_s)
        if len(pts) < 2:
            return None
        return pts[-1][1] - pts[0][1]

    def rate(self, key: str, window_s: Optional[float] = None) -> Optional[float]:
        """Delta over elapsed time in the window: a counter as a rate."""
        pts = self._window(key, window_s)
        if len(pts) < 2 or pts[-1][0] <= pts[0][0]:
            return None
        return (pts[-1][1] - pts[0][1]) / (pts[-1][0] - pts[0][0])

    def ewma(self, key: str, alpha: float = 0.2,
             window_s: Optional[float] = None) -> Optional[float]:
        pts = self._window(key, window_s)
        if not pts:
            return None
        acc = pts[0][1]
        for _, v in pts[1:]:
            acc += alpha * (v - acc)
        return acc

    def percentile(self, key: str, q: float,
                   window_s: Optional[float] = None) -> Optional[float]:
        pts = self._window(key, window_s)
        if not pts:
            return None
        vals = sorted(v for _, v in pts)
        return vals[min(len(vals) - 1, max(0, int(q * len(vals))))]

    def _window(self, key: str, window_s: Optional[float]) -> List[Tuple[float, float]]:
        pts = self.series(key)
        if window_s is None or not pts:
            return pts
        cutoff = pts[-1][0] - window_s
        return [p for p in pts if p[0] >= cutoff]

    def tail(self, n: int = 32, keys: Optional[List[str]] = None) -> Dict[str, list]:
        """The last ``n`` samples of each key as JSON-safe rows."""
        out: Dict[str, list] = {}
        for key in (keys if keys is not None else self.keys()):
            pts = self.series(key, n)
            if pts:
                out[key] = [[round(t, 3), v] for t, v in pts]
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "keys": len(self._rings),
                "capacity": self._capacity,
                "samples_total": self._samples_total,
                "last_sample_age_s": round(time.time() - self._last_t, 3)
                if self._last_t else -1.0,
            }


class HistorySampler:
    """Every ``interval_s``, one registry snapshot recorded into the store,
    on a daemon thread; :meth:`sample_once` drives it by hand."""

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        store: Optional[TimeSeriesStore] = None,
        interval_s: float = DEFAULT_INTERVAL_S,
        capacity: int = DEFAULT_CAPACITY,
    ):
        if interval_s <= 0:
            raise ValueError("interval_s must be positive (0 = don't build one)")
        self.registry = registry  # None: default() at each sample
        self.store = store if store is not None else TimeSeriesStore(capacity)
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._sweeps = 0  # guarded-by: _lock
        self._last_ms = 0.0  # guarded-by: _lock
        self._max_ms = 0.0  # guarded-by: _lock

    def sample_once(self, now: Optional[float] = None) -> int:
        reg = self.registry if self.registry is not None else MetricsRegistry.default()
        t0 = time.perf_counter()
        n = self.store.record(reg.snapshot(), now=now)
        ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self._sweeps += 1
            self._last_ms = ms
            if ms > self._max_ms:
                self._max_ms = ms
        return n

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 (history outlives a bad source)
                pass

    def start(self) -> "HistorySampler":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="history-sampler")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "HistorySampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "interval_s": self.interval_s,
                "sweeps_total": self._sweeps,
                "sweep_last_ms": round(self._last_ms, 3),
                "sweep_max_ms": round(self._max_ms, 3),
            }
        out.update(self.store.snapshot())
        return out


_default_lock = threading.Lock()
_default_sampler: Optional[HistorySampler] = None  # guarded-by: _default_lock


def default_history() -> Optional[TimeSeriesStore]:
    """The process's history store, or None when no sampler was started."""
    with _default_lock:
        return _default_sampler.store if _default_sampler is not None else None


def start_default_history(
    interval_s: float = DEFAULT_INTERVAL_S,
    capacity: int = DEFAULT_CAPACITY,
    registry: Optional[MetricsRegistry] = None,
) -> HistorySampler:
    """Start (or return) the process's sampler, registered as the
    ``timeseries`` source; the first caller's interval and capacity win."""
    global _default_sampler
    with _default_lock:
        if _default_sampler is None:
            _default_sampler = HistorySampler(registry=registry, interval_s=interval_s,
                                              capacity=capacity).start()
            reg = registry if registry is not None else MetricsRegistry.default()
            reg.register("timeseries", _default_sampler)
        return _default_sampler


def stop_default_history() -> None:
    """Stop and forget the process's sampler."""
    global _default_sampler
    with _default_lock:
        sampler, _default_sampler = _default_sampler, None
    if sampler is not None:
        sampler.stop()


def add_history_args(parser) -> None:
    """``--history_interval`` and ``--history_samples``, the JAX package's
    flags."""
    parser.add_argument(
        "--history_interval", type=float, default=DEFAULT_INTERVAL_S,
        help="sample the metrics registry into the in-process history ring every N seconds "
             "(flight-dump tails); 0 = off",
    )
    parser.add_argument(
        "--history_samples", type=int, default=DEFAULT_CAPACITY,
        help="ring capacity a key for --history_interval (memory is keys x samples, "
             "preallocated)",
    )


def configure_history_from_args(args) -> Optional[HistorySampler]:
    """Start the process's sampler from the ``add_history_args`` flags
    (None for ``--history_interval 0``)."""
    interval = getattr(args, "history_interval", 0.0) or 0.0
    if interval <= 0:
        return None
    return start_default_history(
        interval_s=interval,
        capacity=max(2, int(getattr(args, "history_samples", DEFAULT_CAPACITY))),
    )
