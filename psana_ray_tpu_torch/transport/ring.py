"""In-process bounded ring buffer with the reference queue's semantics.

The port's copy of ``psana_ray_tpu/transport/ring.py``: non-blocking
``put -> False`` when full and ``get -> EMPTY`` when empty, blocking
``put_wait``/``get_wait`` with timeouts, ``get_batch`` that drains up to N
items in one lock acquisition, and ``close()``, which wakes every waiter
and makes further operations raise :class:`TransportClosed`.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, List, Optional

from psana_ray_tpu_torch.transport.registry import TransportClosed


class _Sentinel:
    __slots__ = ("_name",)

    def __init__(self, name: str):
        self._name = name

    def __repr__(self):
        return f"<{self._name}>"


EMPTY = _Sentinel("EMPTY")  # queue momentarily empty: try again
FULL = _Sentinel("FULL")  # queue full: backpressure


class RingBuffer:
    """Thread-safe bounded FIFO with non-blocking and blocking interfaces."""

    def __init__(self, maxsize: int = 100, name: str = "shared_queue"):
        if maxsize <= 0:
            raise ValueError("maxsize must be positive")
        self.maxsize = int(maxsize)
        self.name = name
        self._q: deque = deque()  # guarded-by: _lock
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False  # guarded-by: _lock

    def put(self, item: Any) -> bool:
        """Append if not full; False when full (never drops)."""
        with self._lock:
            self._check_open()
            if len(self._q) >= self.maxsize:
                return False
            self._q.append(item)
            self._not_empty.notify()
            return True

    def get(self) -> Any:
        """Pop the oldest item, or :data:`EMPTY`."""
        with self._lock:
            self._check_open()
            if not self._q:
                return EMPTY
            item = self._q.popleft()
            self._not_full.notify()
            return item

    def size(self) -> int:
        with self._lock:
            return len(self._q)

    def put_wait(self, item: Any, timeout: Optional[float] = None) -> bool:
        """Block until there is space (or timeout). Returns success."""
        with self._not_full:
            ok = self._not_full.wait_for(
                lambda: self._closed or len(self._q) < self.maxsize, timeout=timeout
            )
            self._check_open()
            if not ok:
                return False
            self._q.append(item)
            self._not_empty.notify()
            return True

    def get_wait(self, timeout: Optional[float] = None) -> Any:
        """Block until an item is available (or timeout -> :data:`EMPTY`)."""
        with self._not_empty:
            ok = self._not_empty.wait_for(lambda: self._closed or bool(self._q), timeout=timeout)
            self._check_open()
            if not ok or not self._q:
                return EMPTY
            item = self._q.popleft()
            self._not_full.notify()
            return item

    def get_batch(self, max_items: int, timeout: Optional[float] = None) -> List[Any]:
        """Drain up to ``max_items`` in one lock acquisition. Blocks for the
        first item up to ``timeout``; never blocks for the rest."""
        with self._not_empty:
            ok = self._not_empty.wait_for(lambda: self._closed or bool(self._q), timeout=timeout)
            self._check_open()
            if not ok:
                return []
            out = [self._q.popleft() for _ in range(min(max_items, len(self._q)))]
            if out:
                self._not_full.notify_all()
            return out

    def close(self) -> None:
        """Mark dead: wake all waiters; further operations raise."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def _check_open(self) -> None:
        # guarded-by-caller: _lock
        if self._closed:
            raise TransportClosed(f"queue {self.name!r} is closed")
