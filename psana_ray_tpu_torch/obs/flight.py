"""The flight recorder: a bounded in-memory ring of structured events,
dumped to disk with a metrics snapshot, the history tail and every
thread's stack when the pipeline wedges.

The port's copy of ``psana_ray_tpu/obs/flight.py``. Counters say that a
run degenerated; the recorder says what happened just before (queue ops,
reconnects, EOS markers, stall events, errors) and what every thread was
doing at the dump. Recording is always on and cheap (one deque append
under a lock, at rare control-plane events only, never per frame);
dumping needs :meth:`FlightRecorder.install` with a directory.

Dump triggers:

- a :class:`~psana_ray_tpu_torch.obs.stall.StallDetector` event (wire
  ``on_event=FLIGHT.on_stall``; the queue server does);
- an unhandled exception (``install`` chains ``sys.excepthook`` and
  ``threading.excepthook``);
- ``SIGUSR2`` (``kill -USR2 <pid>``).

A dump document has the JAX package's keys. It is written under a
temporary name in the dump directory and renamed into place, so a reader
never sees a half-written file. ``profile_top`` holds the continuous
profiler's hottest frames and each stage's on-CPU ms (null while it is
off). Pure stdlib.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import socket
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)

__all__ = ["FlightRecorder", "FLIGHT"]

# one automatic dump a window: several queues can degenerate at once
DUMP_MIN_INTERVAL_S = 5.0

# samples of each history key a dump carries: at the default 1 s sampling
# the last minute before the trigger
TAIL_SAMPLES = 64


def _thread_stacks() -> Dict[str, list]:
    """Every live thread's current stack, keyed ``name-ident``."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        key = f"{names.get(ident, 'unknown')}-{ident}"
        out[key] = [ln.rstrip("\n") for ln in traceback.format_stack(frame)]
    return out


def _write_atomic(path: str, doc: dict) -> None:
    """``doc`` as JSON at ``path``: written to a temporary name in the same
    directory, then renamed over ``path``."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class FlightRecorder:
    """Bounded ring of structured events + the dump machinery."""

    def __init__(self, maxlen: int = 1024):
        # reentrant: the SIGUSR2 handler runs in the main thread between
        # bytecodes and records; a plain lock held by that thread would
        # deadlock the process being diagnosed
        self._lock = threading.RLock()
        self._events: deque = deque(maxlen=maxlen)
        self._counts: Dict[str, int] = {}
        self._total = 0
        self._dumps = 0
        self._last_dump = 0.0
        self._dir: Optional[str] = None
        self._process = ""
        self._host = socket.gethostname()
        self._prev_sighandler = None
        self._prev_excepthook = None
        self._prev_threading_excepthook = None
        self._installed_signum: Optional[int] = None

    # -- recording --------------------------------------------------------
    def record(self, kind: str, /, **detail) -> None:
        """Append one event; never blocks on disk and never raises into the
        caller. ``kind``, ``wall`` and ``mono`` win over same-named detail
        fields."""
        try:
            evt = dict(detail)
            evt["kind"] = kind
            evt["wall"] = time.time()
            evt["mono"] = time.monotonic()
            with self._lock:
                self._events.append(evt)
                self._total += 1
                self._counts[kind] = self._counts.get(kind, 0) + 1
        except Exception:  # noqa: BLE001
            logger.debug("flight record failed", exc_info=True)

    @property
    def event_count(self) -> int:
        with self._lock:
            return self._total

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def count_of(self, *kinds: str) -> int:
        """Lifetime count over the named kinds (survives ring eviction)."""
        with self._lock:
            return sum(self._counts.get(k, 0) for k in kinds)

    # -- dumping ----------------------------------------------------------
    def install(
        self,
        dump_dir: str,
        process: str = "",
        signum: Optional[int] = None,
        excepthook: bool = True,
    ) -> "FlightRecorder":
        """Arm dumping into ``dump_dir``: SIGUSR2 (or ``signum``) dumps on
        demand and unhandled exceptions dump before the interpreter dies
        (the previous hooks still run). Off the main thread the signal is
        not installed (a Python rule); the hooks still are."""
        os.makedirs(dump_dir, exist_ok=True)
        with self._lock:
            self._dir = dump_dir
            self._process = process or self._process
            proc = self._process
        if signum is None:
            signum = getattr(signal, "SIGUSR2", None)
        if signum is not None and threading.current_thread() is threading.main_thread():
            try:
                self._prev_sighandler = signal.signal(signum, self._on_signal)
                self._installed_signum = signum
            except (ValueError, OSError):
                self._installed_signum = None
        if excepthook:
            self._prev_excepthook = sys.excepthook
            sys.excepthook = self._on_exception
            # a worker thread's uncaught exception goes to threading.excepthook
            self._prev_threading_excepthook = threading.excepthook
            threading.excepthook = self._on_thread_exception
        self.record("flight_installed", dir=dump_dir, process=proc)
        return self

    def uninstall(self) -> None:
        """Restore the previous signal handler and hooks."""
        if self._installed_signum is not None and self._prev_sighandler is not None:
            try:
                signal.signal(self._installed_signum, self._prev_sighandler)
            except (ValueError, OSError):
                pass
        self._installed_signum = None
        self._prev_sighandler = None
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        if self._prev_threading_excepthook is not None:
            threading.excepthook = self._prev_threading_excepthook
            self._prev_threading_excepthook = None
        with self._lock:
            self._dir = None

    def _on_signal(self, signum, frame):
        self.record("sigusr2", signum=int(signum))
        # dump from another thread: the registry snapshot takes other
        # sources' plain locks, which the interrupted thread may hold
        threading.Thread(target=self.dump, args=("signal",), kwargs={"force": True},
                         daemon=True, name="flight-dump").start()
        prev = self._prev_sighandler
        if callable(prev):
            prev(signum, frame)

    def _on_thread_exception(self, hook_args):
        name = getattr(hook_args.thread, "name", "?")
        exc_type = getattr(hook_args.exc_type, "__name__", str(hook_args.exc_type))
        self.record("unhandled_thread_exception", thread=name, exc_type=exc_type,
                    message=str(hook_args.exc_value))
        self.dump("thread_exception", trigger={
            "thread": name, "exc_type": exc_type, "message": str(hook_args.exc_value),
            "traceback": traceback.format_exception(
                hook_args.exc_type, hook_args.exc_value, hook_args.exc_traceback),
        }, force=True)
        prev = self._prev_threading_excepthook or threading.__excepthook__
        prev(hook_args)

    def _on_exception(self, exc_type, exc, tb):
        name = getattr(exc_type, "__name__", str(exc_type))
        self.record("unhandled_exception", exc_type=name, message=str(exc))
        self.dump("exception", trigger={
            "exc_type": name, "message": str(exc),
            "traceback": traceback.format_exception(exc_type, exc, tb),
        }, force=True)
        prev = self._prev_excepthook or sys.__excepthook__
        prev(exc_type, exc, tb)

    def on_stall(self, event) -> None:
        """``StallDetector(on_event=...)`` hook: record the stall and dump."""
        detail = (dataclasses.asdict(event) if dataclasses.is_dataclass(event)
                  else {"event": repr(event)})
        self.record("stall", stall_kind=detail.get("kind"),
                    **{k: v for k, v in detail.items() if k != "kind"})
        self.dump("stall", trigger=detail)

    def dump(
        self,
        reason: str,
        trigger: Optional[dict] = None,
        path: Optional[str] = None,
        force: bool = False,
    ) -> Optional[str]:
        """Write the event ring, a registry snapshot, the history tail and
        every thread's stack. Returns the path, or None when no directory
        is armed or the rate limit held the dump back. Never raises."""
        try:
            with self._lock:
                if self._dir is None and path is None:
                    return None
                now = time.monotonic()
                if not force and now - self._last_dump < DUMP_MIN_INTERVAL_S:
                    return None
                self._last_dump = now
                self._dumps += 1
                seq = self._dumps
                events = list(self._events)
                counts = dict(self._counts)
                # the write runs outside the lock: take a coherent pair here
                dump_dir, proc = self._dir, self._process
            try:
                from psana_ray_tpu_torch.obs.registry import MetricsRegistry

                metrics = MetricsRegistry.default().snapshot()
            except Exception as e:  # noqa: BLE001
                metrics = {"error": repr(e)}
            tail = None
            try:
                from psana_ray_tpu_torch.obs.timeseries import default_history

                hist = default_history()
                if hist is not None:
                    tail = hist.tail(TAIL_SAMPLES)
            except Exception as e:  # noqa: BLE001
                tail = {"error": repr(e)}
            # what the process burned its CPU on: null while the profiler is off
            try:
                from psana_ray_tpu_torch.obs.profiling import profile_top

                prof_top = profile_top(16)
            except Exception as e:  # noqa: BLE001
                prof_top = {"error": repr(e)}
            doc = {
                "reason": reason,
                "trigger": trigger,
                "host": self._host,
                "pid": os.getpid(),
                "process": proc,
                "wall": time.time(),
                "mono": time.monotonic(),
                "event_counts": counts,
                "events": events,
                "metrics": metrics,
                "timeseries_tail": tail,
                "profile_top": prof_top,
                "threads": _thread_stacks(),
            }
            if path is None:
                stamp = time.strftime("%Y%m%d-%H%M%S")
                path = os.path.join(
                    dump_dir, f"flight-{proc or 'proc'}-{os.getpid()}-{stamp}-{seq}.json")
            _write_atomic(path, doc)
            logger.warning("flight recorder dump (%s) -> %s", reason, path)
            return path
        except Exception:  # noqa: BLE001 (the recorder must not crash the plane)
            logger.exception("flight recorder dump failed")
            return None

    # -- registry source ----------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            out: Dict[str, Any] = {
                "events_total": self._total,
                "dumps_total": self._dumps,
                "armed": self._dir is not None,
            }
            for kind, n in self._counts.items():
                out[f"events_{kind}_total"] = n
        return out


#: The process's recorder: call sites record into it unconditionally (rare
#: control-plane events only); programs arm dumping with ``install``.
FLIGHT = FlightRecorder()
