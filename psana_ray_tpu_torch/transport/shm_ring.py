"""Cross-process shared-memory ring: ctypes bindings over the C++ MPMC ring.

The port's copy of ``psana_ray_tpu/transport/shm_ring.py``. Same contract
as :class:`~psana_ray_tpu_torch.transport.ring.RingBuffer` (put -> bool,
get -> item or ``EMPTY``, size, close with ``TransportClosed``), but the
queue lives in POSIX shared memory, so producer and consumer processes on
one host exchange frames with one memcpy each way. Payloads are the
records wire format with a one-byte tag (:mod:`.codec`); the ring's
layout, magic and names are the JAX package's, so a producer of either
package feeds a consumer of the other.

The library is the port's own ``native/shmring.cpp``, built with ``g++``
at first use into ``build/torch_native/<hash>/`` under the checkout (the
hash covers the source and the flags) under an inter-process file lock,
so processes that start together build it once.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import pickle
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, List, Optional

from psana_ray_tpu_torch.records import EndOfStream, FrameRecord, encode_into, encoded_size
from psana_ray_tpu_torch.transport.codec import TAG_PICKLE, TAG_RECORD, TAG_VOID, decode_payload
from psana_ray_tpu_torch.transport.registry import (
    RendezvousTimeout,
    TransportClosed,
    TransportWedged,
)
from psana_ray_tpu_torch.transport.ring import EMPTY

logger = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "shmring.cpp"
BUILD_ROOT = _PKG.parent / "build" / "torch_native"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]
# shm_open/shm_unlink live in librt before glibc 2.34; -lrt is a stub after
LDLIBS = ["-lrt"]

_lib = None
_lib_lock = threading.Lock()


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LDLIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libshmring.so"


def _build(path: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found: cannot build the shm ring")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LDLIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"building the shm ring failed: {' '.join(cmd)}\n{e.stderr}") from e
    os.replace(tmp, path)


def _load_lib() -> ctypes.CDLL:
    """Build (when missing) and load the port's ring library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = _library_path()
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        with open(BUILD_ROOT / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released on close, or when the process dies
            try:
                if not path.exists():  # checked under the lock: a sibling may have built it
                    _build(path)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        lib = ctypes.CDLL(str(path))
        P, U64 = ctypes.c_void_p, ctypes.c_uint64
        lib.shmring_create.restype = P
        lib.shmring_create.argtypes = [ctypes.c_char_p, U64, U64]
        lib.shmring_attach.restype = P
        lib.shmring_attach.argtypes = [ctypes.c_char_p]
        for fn in ("shmring_size", "shmring_capacity", "shmring_slot_bytes"):
            getattr(lib, fn).restype = U64
            getattr(lib, fn).argtypes = [P]
        lib.shmring_reserve.restype = ctypes.c_int
        lib.shmring_reserve.argtypes = [P, ctypes.POINTER(P), ctypes.POINTER(U64)]
        lib.shmring_commit.restype = None
        lib.shmring_commit.argtypes = [P, U64, U64]
        lib.shmring_acquire.restype = ctypes.c_int64
        lib.shmring_acquire.argtypes = [P, ctypes.POINTER(P), ctypes.POINTER(U64)]
        lib.shmring_release.restype = None
        lib.shmring_release.argtypes = [P, U64]
        lib.shmring_is_closed.restype = ctypes.c_int
        lib.shmring_is_closed.argtypes = [P]
        for fn in ("shmring_close", "shmring_begin_drain"):
            getattr(lib, fn).restype = None
            getattr(lib, fn).argtypes = [P]
        lib.shmring_set_stall_timeout.restype = None
        lib.shmring_set_stall_timeout.argtypes = [P, U64]
        lib.shmring_stats.restype = None
        lib.shmring_stats.argtypes = [P, ctypes.POINTER(U64 * 4)]
        lib.shmring_free.restype = None
        lib.shmring_free.argtypes = [P, ctypes.c_int]
        _lib = lib
        return lib


class _SlotLease:
    """A consumed but unreleased ring slot behind a zero-copy record.

    ``get_view``/``get_batch_view`` hand out records whose panels view the
    slot; the lease keeps the slot from producers until the payload was
    copied onward (``FrameBatcher.push_view`` releases right after the
    copy into the batch arena). Idempotent; also fires on GC, so a dropped
    record frees its slot instead of wedging the ring. It holds the ring,
    so the mapping outlives every lease; a release after ``disconnect``
    or ``destroy`` is a no-op."""

    __slots__ = ("_ring", "_ticket")

    def __init__(self, ring: "ShmRingBuffer", ticket: int):
        self._ring = ring
        self._ticket = ticket

    def release(self) -> None:
        ring, self._ring = self._ring, None
        if ring is None:
            return
        with ring._handle_lock:
            ring._slot_leases -= 1
            if ring._h:
                ring._lib.shmring_release(ring._h, self._ticket)

    def __del__(self):
        try:
            self.release()
        except Exception:  # interpreter shutdown: nothing left to release into
            pass


class ShmRingBuffer:
    """MPMC shared-memory queue: :meth:`create` in one process,
    :meth:`attach` in the others."""

    # an epix10k2M f32 frame is 8.65 MB; the default slot holds it and its header
    DEFAULT_SLOT_BYTES = 9 * 1024 * 1024

    def __init__(self, handle, name: str):
        self._lib = _load_lib()
        self._h = handle  # guarded-by: _handle_lock
        self.name = name
        self._slot_bytes = int(self._lib.shmring_slot_bytes(handle))
        self._voids_skipped = 0  # guarded-by: _handle_lock
        self._slot_leases = 0  # guarded-by: _handle_lock
        self._bytes_copied_out = 0  # guarded-by: _handle_lock
        # serializes every use of the C handle against disconnect()/destroy()
        # freeing it; reentrant because a _SlotLease may release from __del__
        # on a thread that already holds it
        self._handle_lock = threading.RLock()

    # -- construction ------------------------------------------------------
    @classmethod
    def create(cls, name: str, maxsize: int = 64,
               slot_bytes: int = DEFAULT_SLOT_BYTES) -> "ShmRingBuffer":
        """Create (or replace) the ring ``name`` with at least ``maxsize``
        slots (rounded up to a power of two) of ``slot_bytes`` each."""
        lib = _load_lib()
        h = lib.shmring_create(cls._shm_name(name), maxsize, slot_bytes)
        if not h:
            raise RuntimeError(f"shmring_create({name!r}) failed (is /dev/shm large enough?)")
        return cls(h, name)

    @classmethod
    def attach(cls, name: str, retries: int = 10, interval_s: float = 1.0) -> "ShmRingBuffer":
        """Attach to an existing ring, retrying until it appears; raises
        :class:`RendezvousTimeout` (a ``TimeoutError``) after ``retries *
        interval_s`` seconds."""
        lib = _load_lib()
        deadline = time.monotonic() + retries * interval_s
        while True:
            h = lib.shmring_attach(cls._shm_name(name))
            if h:
                return cls(h, name)
            if time.monotonic() >= deadline:
                raise RendezvousTimeout(
                    f"shm ring {name!r} not found after {retries} x {interval_s} s")
            time.sleep(interval_s)

    @staticmethod
    def _shm_name(name: str) -> bytes:
        clean = "".join(c if c.isalnum() or c in "-_." else "_" for c in name)
        return f"/psana_ray_tpu_{clean}".encode()  # the JAX package's names

    def set_stall_timeout(self, seconds: float) -> None:
        """Wedge detection for this handle (0 disables): a slot a peer
        claimed and left unfinished for longer raises
        :class:`TransportWedged` instead of stalling for ever."""
        with self._handle_lock:
            self._lib.shmring_set_stall_timeout(self._live_handle(), int(seconds * 1000))

    def _wedged(self, peer: str, verb: str) -> TransportWedged:
        return TransportWedged(
            f"shm ring {self.name!r} is wedged: a {peer} process claimed a slot and never "
            f"{verb} it (likely crashed mid-operation). Destroy and recreate the ring; "
            f"the items in the wedged region are lost.")

    # -- transport contract --------------------------------------------------
    def put(self, item: Any) -> bool:
        """Encode ``item`` straight into a reserved slot (a frame's panels
        with one memcpy); False when the ring is full."""
        wire = isinstance(item, (FrameRecord, EndOfStream))
        if wire:
            n, payload = 1 + encoded_size(item), None
        else:
            payload = TAG_PICKLE + pickle.dumps(item, protocol=pickle.HIGHEST_PROTOCOL)
            n = len(payload)
        if n > self._slot_bytes:
            raise ValueError(f"message of {n} bytes exceeds slot size {self._slot_bytes}")
        ptr, ticket = ctypes.c_void_p(), ctypes.c_uint64()
        # held from reserve to commit: teardown must not unmap the slot mid-copy
        with self._handle_lock:
            h = self._live_handle()
            rc = self._lib.shmring_reserve(h, ctypes.byref(ptr), ctypes.byref(ticket))
            if rc == 0:
                return False
            if rc == -2:
                raise TransportClosed(f"shm ring {self.name!r} is closed")
            if rc == -4:
                raise self._wedged("consumer", "released")
            mv = memoryview((ctypes.c_ubyte * self._slot_bytes).from_address(ptr.value)).cast("B")
            ok = False
            try:
                if wire:
                    mv[0:1] = TAG_RECORD
                    encode_into(item, mv[1:n])
                else:
                    mv[:n] = payload
                ok = True
            finally:
                # a claimed slot is always published: a failed encode
                # becomes a one-byte void that consumers skip
                if not ok:
                    mv[0:1] = TAG_VOID
                self._lib.shmring_commit(h, ticket, n if ok else 1)
        return True

    def get(self) -> Any:
        """Pop the oldest item, which owns its data, or ``EMPTY``."""
        return self._get(view=False)

    def get_view(self) -> Any:
        """Zero-copy get: a frame's panels view the slot, which stays
        claimed behind the record's lease until ``rec.release()``
        (``FrameBatcher.push_view`` does it right after its copy). Every
        lease held keeps one slot from producers. Other payloads come
        back owned, with their slot released."""
        return self._get(view=True)

    def _get(self, view: bool) -> Any:
        # loops past void slots: a void is consumed and skipped, not EMPTY
        while True:
            ptr, ticket = ctypes.c_void_p(), ctypes.c_uint64()
            with self._handle_lock:
                h = self._live_handle()
                n = self._lib.shmring_acquire(h, ctypes.byref(ptr), ctypes.byref(ticket))
                if n == -1:
                    return EMPTY
                if n == -2:
                    raise TransportClosed(f"shm ring {self.name!r} is closed")
                if n == -4:
                    raise self._wedged("producer", "committed")
                mv = memoryview((ctypes.c_ubyte * int(n)).from_address(ptr.value)).cast("B")
                if bytes(mv[:1]) == TAG_VOID:
                    self._voids_skipped += 1
                    self._lib.shmring_release(h, ticket)
                    continue
                if not view:
                    try:
                        item = decode_payload(mv)  # copies the panels out of the slot
                        if isinstance(item, FrameRecord):
                            self._bytes_copied_out += item.nbytes
                        return item
                    finally:
                        self._lib.shmring_release(h, ticket)
                self._slot_leases += 1
                lease = _SlotLease(self, int(ticket.value))
                try:
                    return decode_payload(mv, lease=lease)
                except BaseException:
                    lease.release()
                    raise

    def get_wait(self, timeout: Optional[float] = None, poll_s: float = 0.0002) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            item = self.get()
            if item is not EMPTY:
                return item
            if deadline is not None and time.monotonic() >= deadline:
                return EMPTY
            time.sleep(poll_s)

    def put_wait(self, item: Any, timeout: Optional[float] = None, poll_s: float = 0.0002) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.put(item):
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(poll_s)

    def get_batch(self, max_items: int, timeout: Optional[float] = None) -> List[Any]:
        """Up to ``max_items`` owned items; blocks only for the first."""
        return self._get_batch(max_items, timeout, view=False)

    def get_batch_view(self, max_items: int, timeout: Optional[float] = None) -> List[Any]:
        """Up to ``max_items`` zero-copy items (see :meth:`get_view`);
        blocks only for the first. The path ``batches_from_queue``
        prefers: each frame holds its slot until the batcher has copied
        and released it."""
        return self._get_batch(max_items, timeout, view=True)

    def _get_batch(self, max_items: int, timeout: Optional[float], view: bool) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            first = self._get(view)
            if first is not EMPTY:
                break
            if deadline is not None and time.monotonic() >= deadline:
                return []
            time.sleep(0.0002)
        out = [first]
        while len(out) < max_items:
            item = self._get(view)
            if item is EMPTY:
                break
            out.append(item)
        return out

    def _live_handle(self):
        # guarded-by-caller: _handle_lock
        if not self._h:
            raise TransportClosed(f"shm ring {self.name!r} is detached")
        return self._h

    def size(self) -> int:
        with self._handle_lock:
            return int(self._lib.shmring_size(self._live_handle()))

    @property
    def maxsize(self) -> int:
        with self._handle_lock:
            return int(self._lib.shmring_capacity(self._live_handle()))

    @property
    def closed(self) -> bool:
        with self._handle_lock:
            return bool(self._lib.shmring_is_closed(self._live_handle()))

    def close(self) -> None:
        """Close the ring for every process: puts and gets raise."""
        with self._handle_lock:
            if self._h:
                self._lib.shmring_close(self._h)

    def begin_drain(self) -> None:
        """Half-close: producers are refused (as closed), gets keep serving."""
        with self._handle_lock:
            if self._h:
                self._lib.shmring_begin_drain(self._h)

    def stats(self) -> dict:
        """Depth, capacity, puts, gets, rejected puts, skipped voids, and
        the panel bytes this handle's owned gets copied out of slots (0
        on the zero-copy path)."""
        buf = (ctypes.c_uint64 * 4)()
        with self._handle_lock:
            h = self._live_handle()
            self._lib.shmring_stats(h, ctypes.byref(buf))
            return {
                "depth": int(buf[0]), "maxsize": int(self._lib.shmring_capacity(h)),
                "puts": int(buf[1]), "gets": int(buf[2]), "puts_rejected": int(buf[3]),
                "voids_skipped": self._voids_skipped, "bytes_copied_out": self._bytes_copied_out,
            }

    def disconnect(self) -> None:
        """Detach this handle; the ring lives on for other processes."""
        self._free(destroy=False)

    def destroy(self) -> None:
        """Detach and unlink the shared-memory object."""
        self._free(destroy=True)

    def _free(self, destroy: bool) -> None:
        with self._handle_lock:
            if not self._h:
                return
            if self._slot_leases > 0:  # their views would point into unmapped memory
                logger.warning("%s(%s) with %d zero-copy slot lease(s) outstanding",
                               "destroy" if destroy else "disconnect", self.name,
                               self._slot_leases)
            self._lib.shmring_free(self._h, int(destroy))
            self._h = None

    def __del__(self):
        try:
            self.disconnect()
        except Exception:  # interpreter shutdown
            pass
