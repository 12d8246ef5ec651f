"""The per-frame cost model: the ``prof`` registry source.

The port's copy of ``psana_ray_tpu/obs/profiling/costmodel.py``. About
once a second, on the sampler's housekeeping tick, it differences the
process's CPU time (``os.times``) against a frame counter and a byte
counter:

- ``cpu_frac``: process CPU seconds a wall second, also kept in a
  :class:`SeriesRing` so that a spool carries the timeline;
- ``cpu_ns_per_frame``: CPU nanoseconds a frame;
- ``py_bytes_per_frame``: bytes copied through Python a frame.

Every value is numeric, so it flows through ``flatten_numeric`` into
``/metrics``, the history and the federation payload; the hot frames'
names ride outside it (``registry.federation_payload``'s ``profile``).

The counters default to the process's wire copy counters
(:data:`psana_ray_tpu_torch.utils.bufpool.WIRE`), as in the JAX package.
A process whose frames are not one wire copy each passes its own
``frames_fn`` (and ``bytes_fn``): the port's programs pass their frame
counts, and the WIRE bytes as ``bytes_fn``.
"""

from __future__ import annotations

import os
import threading
import time

from psana_ray_tpu_torch.obs.timeseries import SeriesRing

__all__ = ["ProfTelemetry", "CPU_SERIES_CAPACITY", "wire_bytes"]

CPU_SERIES_CAPACITY = 600  # ten minutes of 1 Hz ticks, as the history rings


def wire_bytes() -> int:
    """The bytes the process's WIRE counters saw copied: the ``bytes_fn``
    of a program that counts its own frames."""
    from psana_ray_tpu_torch.utils.bufpool import WIRE

    return int(WIRE.stats()["bytes_copied_total"])


class ProfTelemetry:
    """The cost model's state, written by the sampler's tick
    (:meth:`tick_cost_model`) and read by scrapes under ``_lock``."""

    def __init__(self, sampler=None, frames_fn=None, bytes_fn=None):
        self._sampler = sampler
        self._frames_fn = frames_fn
        self._bytes_fn = bytes_fn
        self._lock = threading.Lock()
        self.cpu_frac = 0.0  # guarded-by: _lock
        self.cpu_ns_per_frame = 0.0  # guarded-by: _lock
        self.py_bytes_per_frame = 0.0  # guarded-by: _lock
        self.frames_seen = 0  # guarded-by: _lock
        self.ticks_total = 0  # guarded-by: _lock
        self._last_mono = 0.0  # guarded-by: _lock
        self._last_cpu = 0.0  # guarded-by: _lock
        self._last_frames = 0  # guarded-by: _lock
        self._last_bytes = 0  # guarded-by: _lock
        self.cpu_series = SeriesRing(CPU_SERIES_CAPACITY)  # guarded-by: _lock

    def _frame_counters(self):
        """(frames, bytes) from the injected counters or the WIRE counters."""
        if self._frames_fn is not None:
            frames = int(self._frames_fn())
            nbytes = int(self._bytes_fn()) if self._bytes_fn is not None else 0
            return frames, nbytes
        try:
            from psana_ray_tpu_torch.utils.bufpool import WIRE

            s = WIRE.stats()
            return int(s["copies_total"]), int(s["bytes_copied_total"])
        except Exception:  # noqa: BLE001 (the model must not fail the sampler)
            return 0, 0

    def tick_cost_model(self, now=None) -> None:
        """One step: CPU, frames and bytes since the previous tick."""
        if now is None:
            now = time.monotonic()
        t = os.times()
        cpu = t.user + t.system
        frames, nbytes = self._frame_counters()
        with self._lock:
            dt = now - self._last_mono
            if self._last_mono > 0.0 and dt > 0.0:
                d_cpu = max(0.0, cpu - self._last_cpu)
                self.cpu_frac = d_cpu / dt
                d_frames = frames - self._last_frames
                if d_frames > 0:
                    self.cpu_ns_per_frame = d_cpu * 1e9 / d_frames
                    self.py_bytes_per_frame = (nbytes - self._last_bytes) / float(d_frames)
            self._last_mono = now
            self._last_cpu = cpu
            self._last_frames = frames
            self._last_bytes = nbytes
            self.frames_seen = frames
            self.ticks_total += 1
            self.cpu_series.append(now, self.cpu_frac)

    def cpu_timeline(self):
        """``[(mono, cpu_frac), ...]``, the spool's ``cpu_series``."""
        with self._lock:
            return self.cpu_series.samples()

    # -- registry source ------------------------------------------------
    def snapshot(self) -> dict:
        s = self._sampler
        with self._lock:
            out = {
                "enabled": 1 if (s is not None and s.running) else 0,
                "cpu_frac": self.cpu_frac,
                "cpu_ns_per_frame": self.cpu_ns_per_frame,
                "py_bytes_per_frame": self.py_bytes_per_frame,
                "frames_seen": self.frames_seen,
                "ticks_total": self.ticks_total,
            }
        if s is not None:
            trie = s.trie
            out["hz"] = s.hz
            out["samples_total"] = trie.samples_total
            out["on_cpu_total"] = trie.on_cpu_total
            out["waiting_total"] = trie.waiting_total
            out["nodes"] = trie.n_nodes
            out["overflow_total"] = trie.overflow_total
            out["stage_cpu_ms"] = s.stage_cpu_ms()
        return out

    def stats(self) -> dict:
        return self.snapshot()
