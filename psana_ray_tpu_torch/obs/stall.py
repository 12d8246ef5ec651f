"""Stall and backpressure detection over transport queues.

The port's copy of ``psana_ray_tpu/obs/stall.py``. A slow or dead
consumer is otherwise silent: the queue fills, producers spin in backoff,
and nothing says why. :class:`StallDetector` polls queue ``stats()`` and
emits structured events:

- ``backpressure``: the queue sat at maxsize longer than
  ``full_threshold_s`` (consumers not keeping up, or dead);
- ``consumer_stall``: depth > 0 and the get counter has not moved for
  ``idle_threshold_s``;
- ``producer_idle``: depth == 0 and the put counter has not moved for
  ``idle_threshold_s`` (a clean end of stream looks the same, so these
  are warnings with context, not errors).

An event is logged once an episode (it re-arms when the condition
clears), handed to ``on_event``, kept in a bounded ``events`` deque and
counted; the detector is a registry source. While any episode is active
the ``degraded`` gauge is up; ``on_clear`` fires when the last one
clears. A bound serving gateway (:meth:`StallDetector.bind_gateway`) is
escalated on the first firing and restored when the last episode clears.
``poll_once(now=...)`` lets tests drive time.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from psana_ray_tpu_torch.utils.metrics import probe_queue_stats as _queue_stats

logger = logging.getLogger(__name__)

EVENT_BACKPRESSURE = "backpressure"
EVENT_CONSUMER_STALL = "consumer_stall"
EVENT_PRODUCER_IDLE = "producer_idle"


@dataclasses.dataclass(frozen=True)
class StallEvent:
    kind: str
    queue: str
    duration_s: float
    depth: int
    maxsize: int
    detail: str = ""

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


class _QueueState:
    __slots__ = (
        "last_puts", "last_gets", "last_t",
        "full_since", "full_warned",
        "idle_since", "idle_warned",
        "starved_since", "starved_warned",
        "put_rate", "get_rate",
    )

    def __init__(self):
        self.last_puts: Optional[int] = None
        self.last_gets: Optional[int] = None
        self.last_t: Optional[float] = None
        self.full_since: Optional[float] = None
        self.full_warned = False
        self.idle_since: Optional[float] = None
        self.idle_warned = False
        self.starved_since: Optional[float] = None
        self.starved_warned = False
        self.put_rate = 0.0
        self.get_rate = 0.0


class StallDetector:
    """Poll watched queues; warn when the stream degenerates."""

    def __init__(
        self,
        poll_interval_s: float = 1.0,
        full_threshold_s: float = 5.0,
        idle_threshold_s: float = 10.0,
        on_event: Optional[Callable[[StallEvent], None]] = None,
        on_clear: Optional[Callable[[], None]] = None,
        max_events: int = 256,
    ):
        self.poll_interval_s = poll_interval_s
        self.full_threshold_s = full_threshold_s
        self.idle_threshold_s = idle_threshold_s
        self.on_event = on_event
        self.on_clear = on_clear  # fired when the last active episode clears
        self.events: deque = deque(maxlen=max_events)
        self._counts: Dict[str, int] = {
            EVENT_BACKPRESSURE: 0,
            EVENT_CONSUMER_STALL: 0,
            EVENT_PRODUCER_IDLE: 0,
        }  # guarded-by: _lock
        self._lock = threading.Lock()
        self._watched: Dict[str, Any] = {}  # guarded-by: _lock
        self._provider: Optional[Callable[[], Dict[str, Any]]] = None
        self._states: Dict[str, _QueueState] = {}  # guarded-by: _lock
        self._degraded = False  # guarded-by: _lock
        self._gateways: list = []  # escalate/restore targets  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def watch(self, name: str, queue) -> "StallDetector":
        """Watch one queue (anything with ``stats()`` or ``size()``)."""
        with self._lock:
            self._watched[name] = queue
        return self

    def watch_provider(self, provider: Callable[[], Dict[str, Any]]) -> "StallDetector":
        """Watch a changing population: ``provider()`` returns ``{name:
        queue}`` at each poll (a queue server's named queues appear as
        clients open them)."""
        self._provider = provider
        return self

    def bind_gateway(self, gateway) -> "StallDetector":
        """Escalate a :class:`~psana_ray_tpu_torch.serving.gateway.
        ServingGateway` while any stall episode is active: its shed
        threshold rises on the first firing and comes back when the last
        episode clears. Bound mid-episode, it is escalated at once."""
        with self._lock:
            self._gateways.append(gateway)
            degraded = self._degraded
        if degraded:
            gateway.escalate("stall-detector (bound mid-episode)")
        return self

    def start(self) -> "StallDetector":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="stall-detector")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "StallDetector":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _run(self):
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 (the watchdog outlives faults)
                logger.exception("stall detector poll failed")

    def _queues(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self._watched)
        if self._provider is not None:
            try:
                out.update(self._provider() or {})
            except Exception:  # noqa: BLE001
                logger.exception("stall detector queue provider failed")
        return out

    def poll_once(self, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        seen = set()
        for name, queue in self._queues().items():
            seen.add(name)
            try:
                stats = _queue_stats(queue)
            except Exception:
                # a dead transport: its episode can never be seen clearing,
                # so its state goes (or it would hold the gauge up for ever)
                with self._lock:
                    self._states.pop(name, None)
                continue
            self._check_queue(name, stats, now)
        with self._lock:  # queues that left the population too
            for name in [n for n in self._states if n not in seen]:
                self._states.pop(name)
        self._check_cleared()

    @property
    def degraded(self) -> bool:
        """True while any stall episode is active."""
        with self._lock:
            return self._degraded

    def _check_cleared(self):
        with self._lock:
            if not self._degraded:
                return
            if any(st.full_warned or st.idle_warned or st.starved_warned
                   for st in self._states.values()):
                return
            self._degraded = False
            gateways = list(self._gateways)
        logger.info("STALL cleared: all episodes resolved")
        for gw in gateways:
            try:
                gw.restore()
            except Exception:  # noqa: BLE001 (the watchdog outlives faults)
                logger.exception("stall gateway restore failed")
        if self.on_clear is not None:
            try:
                self.on_clear()
            except Exception:  # noqa: BLE001
                logger.exception("stall on_clear callback failed")

    def _check_queue(self, name: str, stats: dict, now: float):
        with self._lock:  # scrapes iterate _states from the HTTP thread
            st = self._states.setdefault(name, _QueueState())
        depth = int(stats.get("depth", 0))
        maxsize = int(stats.get("maxsize", 0) or 0)
        puts = stats.get("puts")
        gets = stats.get("gets")

        if st.last_t is not None and now > st.last_t:
            dt = now - st.last_t
            if puts is not None and st.last_puts is not None:
                st.put_rate = (puts - st.last_puts) / dt
            if gets is not None and st.last_gets is not None:
                st.get_rate = (gets - st.last_gets) / dt

        if maxsize and depth >= maxsize:  # pegged at maxsize
            st.full_since = now if st.full_since is None else st.full_since
            if not st.full_warned and now - st.full_since >= self.full_threshold_s:
                st.full_warned = True
                self._emit(StallEvent(
                    EVENT_BACKPRESSURE, name, now - st.full_since, depth, maxsize,
                    "queue pegged at maxsize; consumers not keeping up",
                ))
        else:
            st.full_since, st.full_warned = None, False

        # data waiting, gets frozen; a depth-only source has no get counter
        # and would cry wolf under healthy steady-state consumption
        gets_frozen = gets is not None and gets == st.last_gets
        if depth > 0 and gets_frozen:
            st.idle_since = now if st.idle_since is None else st.idle_since
            if not st.idle_warned and now - st.idle_since >= self.idle_threshold_s:
                st.idle_warned = True
                self._emit(StallEvent(
                    EVENT_CONSUMER_STALL, name, now - st.idle_since, depth, maxsize,
                    "items queued but no consumer progress",
                ))
        else:
            st.idle_since, st.idle_warned = None, False

        puts_frozen = puts is not None and puts == st.last_puts
        if depth == 0 and puts_frozen:  # consumers starved, puts frozen
            st.starved_since = now if st.starved_since is None else st.starved_since
            if not st.starved_warned and now - st.starved_since >= self.idle_threshold_s:
                st.starved_warned = True
                self._emit(StallEvent(
                    EVENT_PRODUCER_IDLE, name, now - st.starved_since, depth, maxsize,
                    "queue empty and no producer progress (stalled, or done without EOS)",
                ))
        else:
            st.starved_since, st.starved_warned = None, False

        st.last_puts, st.last_gets, st.last_t = puts, gets, now

    def _emit(self, event: StallEvent):
        with self._lock:
            self._counts[event.kind] = self._counts.get(event.kind, 0) + 1
            self._degraded = True
            gateways = list(self._gateways)
        self.events.append(event)
        logger.warning("STALL %s", event.to_json())
        for gw in gateways:  # a firing acts, not only warns
            try:
                gw.escalate(f"{event.kind}:{event.queue}")
            except Exception:  # noqa: BLE001 (the watchdog outlives faults)
                logger.exception("stall gateway escalate failed")
        if self.on_event is not None:
            try:
                self.on_event(event)
            except Exception:  # noqa: BLE001
                logger.exception("stall on_event callback failed")

    def snapshot(self) -> dict:
        with self._lock:
            counts = dict(self._counts)
            states = list(self._states.items())
            degraded = self._degraded
        out: dict = {f"{k}_total": v for k, v in counts.items()}
        out["degraded"] = 1 if degraded else 0
        for name, st in states:
            out[name] = {
                "put_rate": round(st.put_rate, 3),
                "get_rate": round(st.get_rate, 3),
            }
        return out
