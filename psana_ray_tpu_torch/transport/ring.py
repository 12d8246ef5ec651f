"""In-process bounded ring buffer with the reference queue's semantics.

The port's copy of ``psana_ray_tpu/transport/ring.py``: non-blocking
``put -> False`` when full and ``get -> EMPTY`` when empty, blocking
``put_wait``/``get_wait`` with timeouts, ``get_batch`` that drains up to N
items in one lock acquisition, ``close()``, which wakes every waiter
and makes further operations raise :class:`TransportClosed`, and
``stats()``: depth and lifetime counters.

What the TCP queue server's event loop needs besides: ``put_front``
(head re-insertion of deliveries a dead connection had in flight),
change listeners (non-blocking callbacks that poke the loop's waker
after every state change), ``begin_drain`` (refuse producers, keep
serving consumers) and the ``_box``/``_unbox`` storage hooks.
"""

from __future__ import annotations

import threading
import time
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
        self._draining = False  # guarded-by: _lock
        self._listeners: list = []  # guarded-by: _lock
        self._n_put = 0  # guarded-by: _lock
        self._n_get = 0  # guarded-by: _lock
        self._n_put_rejected = 0  # guarded-by: _lock
        self._high_water = 0  # guarded-by: _lock
        self._last_put_t = -1.0  # guarded-by: _lock
        self._last_get_t = -1.0  # guarded-by: _lock

    # -- storage hooks: a stored form for an item and back (a log-backed
    # variant overrides them); the base class stores items as themselves
    def _box(self, item: Any) -> Any:
        # guarded-by-caller: _lock
        return item

    def _box_front(self, item: Any) -> Any:
        # guarded-by-caller: _lock
        return self._box(item)

    def _unbox(self, stored: Any) -> Any:
        # guarded-by-caller: _lock
        return stored

    def put(self, item: Any) -> bool:
        """Append if not full; False when full (never drops)."""
        return self._admit(item) is not None

    def _admit(self, item: Any) -> Any:
        """``put``'s body: the item's stored form, or None when full."""
        with self._lock:
            self._check_open()
            self._check_accepting()
            if len(self._q) >= self.maxsize:
                self._n_put_rejected += 1
                return None
            stored = self._box(item)
            self._q.append(stored)
            self._note_put()
            self._not_empty.notify()
            return stored

    def get(self) -> Any:
        """Pop the oldest item, or :data:`EMPTY`."""
        with self._lock:
            self._check_open()
            if not self._q:
                return EMPTY
            item = self._unbox(self._q[0])  # unbox before the pop: a failure leaves it queued
            self._q.popleft()
            self._note_get()
            self._not_full.notify()
            return item

    def size(self) -> int:
        with self._lock:
            return len(self._q)

    def put_front(self, item: Any) -> bool:
        """Return an item to the head of the queue: an item popped but
        never delivered must come back before anything behind it, EOS
        markers above all. May exceed maxsize by the returned item (it was
        counted when first enqueued)."""
        with self._lock:
            self._check_open()
            self._q.appendleft(self._box_front(item))
            self._high_water = max(self._high_water, len(self._q))
            self._not_empty.notify()
            self._notify_listeners()
            return True

    def add_listener(self, cb) -> None:
        """Register a non-blocking callback, called with the queue's lock
        held after every put, get, close and drain (the TCP event loop's
        waker: a self-pipe write)."""
        with self._lock:
            self._listeners.append(cb)

    def remove_listener(self, cb) -> None:
        with self._lock:
            try:
                self._listeners.remove(cb)
            except ValueError:
                pass

    def _notify_listeners(self) -> None:
        # guarded-by-caller: _lock
        for cb in self._listeners:
            try:
                cb()
            except Exception:  # a broken listener must not break the queue
                pass

    def put_wait(self, item: Any, timeout: Optional[float] = None) -> bool:
        """Block until there is space (or timeout). Returns success."""
        with self._not_full:
            ok = self._not_full.wait_for(
                lambda: self._closed or self._draining or len(self._q) < self.maxsize,
                timeout=timeout,
            )
            self._check_open()
            self._check_accepting()
            if not ok:
                return False
            self._q.append(self._box(item))
            self._note_put()
            self._not_empty.notify()
            return True

    def get_wait(self, timeout: Optional[float] = None) -> Any:
        """Block until an item is available (or timeout -> :data:`EMPTY`)."""
        with self._not_empty:
            ok = self._not_empty.wait_for(lambda: self._closed or bool(self._q), timeout=timeout)
            self._check_open()
            if not ok or not self._q:
                return EMPTY
            item = self._unbox(self._q[0])
            self._q.popleft()
            self._note_get()
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
            out: List[Any] = []
            try:
                for _ in range(min(max_items, len(self._q))):
                    out.append(self._unbox(self._q[0]))
                    self._q.popleft()
            except BaseException:  # put the popped prefix back: no item delivered to nobody
                for item in reversed(out):
                    self._q.appendleft(self._box_front(item))
                raise
            if out:
                self._note_get(len(out))
                self._not_full.notify_all()
            return out

    def close(self) -> None:
        """Mark dead: wake all waiters; further operations raise."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
            self._notify_listeners()

    def begin_drain(self) -> None:
        """Half-close for a graceful teardown: producers are refused (they
        see the dead-queue signal and exit) while consumers read on."""
        with self._lock:
            self._draining = True
            self._not_full.notify_all()
            self._notify_listeners()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def _note_put(self) -> None:
        # guarded-by-caller: _lock
        self._n_put += 1
        self._high_water = max(self._high_water, len(self._q))
        self._last_put_t = time.monotonic()
        self._notify_listeners()

    def _note_get(self, n: int = 1) -> None:
        # guarded-by-caller: _lock
        self._n_get += n
        self._last_get_t = time.monotonic()
        self._notify_listeners()

    def stats(self) -> dict:
        """Depth, capacity, lifetime puts, gets and rejected puts, the
        highest depth seen, and the seconds since the last put and get
        (-1: never), and whether it is closed or draining."""
        with self._lock:
            now = time.monotonic()

            def age(t):
                return round(now - t, 3) if t >= 0 else -1.0

            return {
                "depth": len(self._q), "maxsize": self.maxsize, "puts": self._n_put,
                "gets": self._n_get, "puts_rejected": self._n_put_rejected,
                "high_water": self._high_water, "last_put_age_s": age(self._last_put_t),
                "last_get_age_s": age(self._last_get_t), "closed": self._closed,
                "draining": self._draining,
            }

    def _check_open(self) -> None:
        # guarded-by-caller: _lock
        if self._closed:
            raise TransportClosed(f"queue {self.name!r} is closed")

    def _check_accepting(self) -> None:
        # guarded-by-caller: _lock
        if self._draining:
            raise TransportClosed(f"queue {self.name!r} is draining (shutdown)")
