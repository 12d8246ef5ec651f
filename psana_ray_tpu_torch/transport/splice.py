"""Payload bytes from a segment file to a socket inside the kernel.

The port's copy of ``psana_ray_tpu/transport/splice.py``. A spilled
record's bytes at rest in a segment are the wire payload (tag byte +
record body, written verbatim at append), so the queue server need not
read them into the interpreter to send them:

- :class:`FileSpan`: a ``(file, pos, nbytes)`` region the event loop's
  write queue holds beside ordinary buffers; the flush pump moves it
  with ``os.sendfile``, and only the frame header stays in Python;
- :func:`sendfile_capable`: whether ``sendfile`` works here (answered
  once a process). A socket that refuses it at call time (an errno of
  :func:`fallback_errno`) downgrades that span to the ``sendmsg`` path;
- :func:`zerocopy_capable`: ``MSG_ZEROCOPY``, probed and reported, not
  used (its completions arrive on the socket's error queue, and a lease
  released before them would corrupt a send in flight).

:data:`SPLICE` counts what went by ``sendfile`` and each fallback.
"""

from __future__ import annotations

import errno
import os
import socket
import tempfile
import threading
from typing import Dict, Optional

from psana_ray_tpu_torch.obs.flight import FLIGHT
from psana_ray_tpu_torch.utils.bufpool import WIRE

__all__ = ["FileSpan", "SPLICE", "fallback_errno", "probe_report", "sendfile_capable",
           "zerocopy_capable"]

# errnos that mean "this socket and file cannot splice": downgrade the span,
# keep the connection (any other is a real send error)
_FALLBACK_ERRNOS = frozenset(
    getattr(errno, n) for n in ("EINVAL", "ENOSYS", "ENOTSOCK", "ENOTSUP", "EOPNOTSUPP", "EBADF")
    if hasattr(errno, n))


class FileSpan:
    """A payload region of an on-disk segment, queued to be sent by the
    kernel. Holds the segment's open file object: a span is queued only
    while its record is outstanding in the durable queue, which keeps the
    segment from being recycled, so the file outlives every queued span.
    :meth:`advance` moves it in place after a partial ``sendfile``."""

    __slots__ = ("_file", "pos", "nbytes")

    def __init__(self, file, pos: int, nbytes: int):
        self._file = file
        self.pos = int(pos)
        self.nbytes = int(nbytes)

    def fileno(self) -> int:
        return self._file.fileno()

    def advance(self, sent: int) -> None:
        """Consume ``sent`` bytes off the front."""
        self.pos += sent
        self.nbytes -= sent

    def materialize(self) -> bytes:
        """The rest of the span as bytes (one ``pread``: the file's own
        position is untouched): the ``sendmsg`` fallback."""
        buf = os.pread(self._file.fileno(), self.nbytes, self.pos)
        WIRE.add(len(buf))  # the bytes the spliced path keeps out of the interpreter
        return buf

    def __repr__(self) -> str:
        return f"FileSpan(fd={self._file.fileno()}, pos={self.pos}, nbytes={self.nbytes})"


class SpliceTelemetry:
    """What went by ``sendfile``, and the fallbacks by reason."""

    def __init__(self):
        self._lock = threading.Lock()
        self.spliced_frames = 0  # guarded-by: _lock
        self.spliced_bytes = 0  # guarded-by: _lock
        self.sendfile_calls = 0  # guarded-by: _lock
        self.fallbacks: Dict[str, int] = {}  # reason -> count  # guarded-by: _lock

    def note_sendfile(self, nbytes: int) -> None:
        with self._lock:
            self.spliced_bytes += nbytes
            self.sendfile_calls += 1

    def note_frame(self) -> None:
        with self._lock:
            self.spliced_frames += 1

    def note_fallback(self, reason: str) -> None:
        """Count a fallback to ``sendmsg``; a reason's first sight is also a
        flight-recorder event."""
        with self._lock:
            first = reason not in self.fallbacks
            self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1
        if first:
            FLIGHT.record("splice_fallback", reason=reason)

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "spliced_frames_total": self.spliced_frames,
                "spliced_bytes_total": self.spliced_bytes,
                "sendfile_calls_total": self.sendfile_calls,
                "fallback_total": sum(self.fallbacks.values()),
            }
            for reason, n in self.fallbacks.items():
                out[f"fallback_{reason}_total"] = n
        out["capable"] = 1 if sendfile_capable() else 0
        out["zerocopy_capable"] = 1 if zerocopy_capable() else 0
        return out


SPLICE = SpliceTelemetry()

_sendfile_capable: Optional[bool] = None
_zerocopy_capable: Optional[bool] = None


def sendfile_capable() -> bool:
    """Does ``os.sendfile`` move file bytes to a socket here? Probed once a
    process with a socketpair and a temporary file (a platform may export
    the call and refuse sockets)."""
    global _sendfile_capable
    if _sendfile_capable is not None:
        return _sendfile_capable
    if not hasattr(os, "sendfile"):
        _sendfile_capable = False
        SPLICE.note_fallback("no_os_sendfile")
        return False
    try:
        a, b = socket.socketpair()
        try:
            with tempfile.TemporaryFile() as f:
                f.write(b"probe")
                f.flush()
                # the kernel taking all 5 bytes is the proof; nothing reads
                # them back (a telemetry snapshot must never wait on a socket)
                _sendfile_capable = os.sendfile(a.fileno(), f.fileno(), 0, 5) == 5
        finally:
            a.close()
            b.close()
    except OSError:
        _sendfile_capable = False
    if not _sendfile_capable:
        SPLICE.note_fallback("probe_refused")
    return _sendfile_capable


def zerocopy_capable() -> bool:
    """``MSG_ZEROCOPY`` support (Linux 4.14 and later): reported, not used."""
    global _zerocopy_capable
    if _zerocopy_capable is not None:
        return _zerocopy_capable
    if not (hasattr(socket, "SO_ZEROCOPY") and hasattr(socket, "MSG_ZEROCOPY")):
        _zerocopy_capable = False
        return False
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_ZEROCOPY, 1)
            _zerocopy_capable = True
        finally:
            s.close()
    except OSError:
        _zerocopy_capable = False
    return _zerocopy_capable


def fallback_errno(exc: OSError) -> bool:
    """Is ``exc`` a refusal to splice here (downgrade the span) rather than
    a failed send (kill the connection)?"""
    return exc.errno in _FALLBACK_ERRNOS


def probe_report() -> dict:
    """The capabilities, for the server's start-up log line."""
    return {"sendfile": sendfile_capable(), "msg_zerocopy": zerocopy_capable()}
