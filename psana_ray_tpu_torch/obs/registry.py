"""The process's metrics registry: aggregate, snapshot, render as
Prometheus text.

The port's copy of ``psana_ray_tpu/obs/registry.py``. One
:class:`MetricsRegistry` a process holds every metrics-bearing object
(``PipelineMetrics``, ``Meter``, ``LatencyStats``, queue ``stats()``
callables, stall detectors) under a source name; :meth:`~MetricsRegistry.
snapshot` returns the tree as a JSON-safe dict and :meth:`~MetricsRegistry.
render_prometheus` flattens it into exposition text-format 0.0.4.

Names: nested dict paths join with ``_`` under the ``psana_ray`` prefix,
and the top-level source name is the ``source`` label::

    psana_ray_frames_total{source="producer"} 4096
    psana_ray_stages_queue_dwell_p99_ms{source="infeed.epix"} 1.84

A name ending in ``_total`` is typed ``counter``, every other one
``gauge``. :func:`federation_payload` is the host-tagged snapshot that the
queue server's 'N' ``{"op": "metrics"}`` RPC and the exporter's
``/federate`` route both answer. Pure stdlib.
"""

from __future__ import annotations

import math
import os
import re
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

# PipelineMetrics, Meter, LatencyStats, StageTimes, a stall detector: any
# object with snapshot() or stats(), a dict, or a callable returning one
Source = Union[Any, dict, Callable[[], dict]]


def _sanitize(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def flatten_numeric(path: Tuple[str, ...], value: Any, out: List[Tuple[str, float]]) -> None:
    """Flatten a snapshot tree's numeric leaves into ``(dotted.path,
    float)`` pairs: the one grammar of the Prometheus renderer and the
    history ring, so a history key is its /metrics name with ``.`` for the
    ``_`` joins. Bools become 0/1; non-finite and non-numeric leaves are
    skipped, and so is a latency snapshot's ``exemplars`` subtree (trace
    id links, not series)."""
    if isinstance(value, dict):
        for k, v in value.items():
            if k == "exemplars":
                continue
            flatten_numeric(path + (str(k),), v, out)
        return
    if isinstance(value, bool):
        out.append((".".join(path), 1.0 if value else 0.0))
        return
    if isinstance(value, (int, float)):
        v = float(value)
        if math.isfinite(v):
            out.append((".".join(path), v))


def snapshot_source(src: Source) -> dict:
    """One source as a JSON-safe dict: ``snapshot()`` where it has one, a
    dict as it is, a callable called, else ``stats()``."""
    snap = getattr(src, "snapshot", None)
    if callable(snap):
        return snap() or {}
    if isinstance(src, dict):
        return dict(src)
    if callable(src):
        return src() or {}
    stats = getattr(src, "stats", None)
    if callable(stats):
        return stats() or {}
    raise TypeError(f"not a metrics source: {type(src)!r}")


class MetricsRegistry:
    """Named metrics sources and the two export surfaces. ``default()`` is
    the process's instance, which every program registers into; tests
    build their own."""

    _global: Optional["MetricsRegistry"] = None
    _global_lock = threading.Lock()

    def __init__(self, prefix: str = "psana_ray"):
        self.prefix = _sanitize(prefix)
        self._lock = threading.Lock()
        self._sources: Dict[str, Source] = {}  # guarded-by: _lock

    @classmethod
    def default(cls) -> "MetricsRegistry":
        with cls._global_lock:
            if cls._global is None:
                cls._global = MetricsRegistry()
            return cls._global

    @classmethod
    def reset_default(cls):
        with cls._global_lock:
            cls._global = None

    def register(self, name: str, source: Source) -> Source:
        """Add or replace a source (the last registration under a name wins)."""
        with self._lock:
            self._sources[name] = source
        return source

    def unregister(self, name: str):
        with self._lock:
            self._sources.pop(name, None)

    def sources(self) -> List[str]:
        with self._lock:
            return sorted(self._sources)

    def snapshot(self) -> Dict[str, dict]:
        """``{source_name: {...}}``; a source that raises gives an
        ``error`` entry instead of failing the scrape."""
        with self._lock:
            items = list(self._sources.items())
        out: Dict[str, dict] = {}
        for name, src in items:
            try:
                out[name] = snapshot_source(src)
            except Exception as e:  # noqa: BLE001 (the scrape must survive)
                out[name] = {"error": repr(e)}
        return out

    def render_prometheus(self) -> str:
        """Exposition text-format 0.0.4: the snapshot's numeric leaves, a
        family each with HELP and TYPE lines, the source as a label."""
        families: Dict[str, List[Tuple[str, float]]] = {}
        for source, tree in self.snapshot().items():
            leaves: List[Tuple[str, float]] = []
            flatten_numeric((), tree, leaves)
            for path, value in leaves:
                metric = f"{self.prefix}_{_sanitize(path)}"
                families.setdefault(metric, []).append((source, value))
        lines: List[str] = []
        for metric in sorted(families):
            mtype = "counter" if metric.endswith("_total") else "gauge"
            lines.append(f"# HELP {metric} psana-ray-tpu pipeline metric")
            lines.append(f"# TYPE {metric} {mtype}")
            for source, value in sorted(families[metric]):
                label = _escape_label(source)
                lines.append(f'{metric}{{source="{label}"}} {_format_value(value)}')
        return "\n".join(lines) + "\n" if lines else ""


def _format_value(v: float) -> str:
    if v == int(v) and abs(v) < 2**53:
        return str(int(v))
    return repr(v)


def federation_payload(registry: Optional[MetricsRegistry] = None) -> dict:
    """One host-tagged registry snapshot: ``ok``, ``host``, ``pid``,
    ``wall``, ``mono``, ``metrics``, on a ``--workers`` fleet the
    ``worker`` id, and ``profile``: the continuous profiler's summary
    (:func:`~psana_ray_tpu_torch.obs.profiling.profile_summary`), outside
    ``metrics`` because its frame names are strings; null while the
    profiler is off."""
    reg = registry if registry is not None else MetricsRegistry.default()
    payload = {
        "ok": True,
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "wall": time.time(),
        "mono": time.monotonic(),
        "metrics": reg.snapshot(),
    }
    from psana_ray_tpu_torch.transport.workers import current_worker_id

    wid = current_worker_id()
    if wid is not None:
        payload["worker"] = wid
    from psana_ray_tpu_torch.obs.profiling import profile_summary

    payload["profile"] = profile_summary()
    return payload


def ensure_registered(name: str, source: Source) -> None:
    """Register ``source`` as ``name`` in the process's registry unless a
    source of that name is there: the first-use hook of the process-wide
    counters (``durable``, ``replication``, ``cluster``, ``wire_codec``,
    ``stream``, ``splice``)."""
    reg = MetricsRegistry.default()
    with reg._lock:
        reg._sources.setdefault(name, source)
