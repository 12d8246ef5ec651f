"""Named-queue rendezvous and the transports' errors.

The port's copy of ``psana_ray_tpu/transport/registry.py``: the two
exceptions its transports raise, :class:`RendezvousTimeout`, and the
in-process :class:`Registry` that ``auto``/``local`` addresses resolve
through (the role Ray's GCS actor registry plays in the reference): a
producer get-or-creates the named queue, a consumer resolves it with a
retry loop, and the queue outlives its creator until destroyed.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple


class TransportClosed(RuntimeError):
    """The transport was closed: no further puts or gets."""


class TransportWedged(TransportClosed):
    """A peer process died mid-operation (it claimed a slot and never
    committed or released it), blocking the queue at that slot for good.

    A subclass of :class:`TransportClosed` so it is never mistaken for
    starvation. Handlers that treat closure as a clean end of stream (the
    batcher's tail flush) re-raise this subclass: a wedge means lost data.
    Recovery: destroy and recreate the ring; the items in the wedged
    region are lost."""


class RendezvousTimeout(TimeoutError):
    """The named queue never appeared within the retry loop."""


class Registry:
    """Process-wide named-object registry with detached lifetimes, keyed by
    ``(namespace, name)``."""

    _global: Optional["Registry"] = None
    _global_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self._objects: Dict[Tuple[str, str], Any] = {}  # guarded-by: _lock
        self._cond = threading.Condition(self._lock)

    @classmethod
    def default(cls) -> "Registry":
        with cls._global_lock:
            if cls._global is None:
                cls._global = Registry()
            return cls._global

    @classmethod
    def reset_default(cls) -> None:
        with cls._global_lock:
            cls._global = None

    def get_or_create(self, namespace: str, name: str, factory: Callable[[], Any]) -> Any:
        """The object named ``(namespace, name)``, made by ``factory`` if it
        does not exist yet; atomic, so of two racing creators one wins."""
        with self._lock:
            key = (namespace, name)
            if key not in self._objects:
                self._objects[key] = factory()
                self._cond.notify_all()
            return self._objects[key]

    def resolve(self, namespace: str, name: str, retries: int = 10,
                interval_s: float = 1.0) -> Any:
        """The object named ``(namespace, name)``, waiting for it up to
        ``retries * interval_s`` seconds; raises :class:`RendezvousTimeout`."""
        deadline = time.monotonic() + retries * interval_s
        with self._lock:
            key = (namespace, name)
            while key not in self._objects:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RendezvousTimeout(
                        f"queue {name!r} in namespace {namespace!r} not found "
                        f"after {retries} x {interval_s}s")
                self._cond.wait(timeout=min(remaining, interval_s))
            return self._objects[key]

    def destroy(self, namespace: str, name: str) -> None:
        """Unregister ``(namespace, name)`` and close it, waking every
        producer and consumer blocked on it."""
        with self._lock:
            obj = self._objects.pop((namespace, name), None)
        if obj is not None and hasattr(obj, "close"):
            obj.close()
