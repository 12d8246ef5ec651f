"""The queue server's worker fleet: N forked event-loop processes behind
one port.

The port's copy of ``psana_ray_tpu/transport/workers.py``. One Python
process is one core, and the TCP relay is bound by its one loop.
``queue_server --workers N`` forks N full servers that share the
listening port by ``SO_REUSEPORT``: the kernel spreads incoming
connections across them. A named queue's state (its ring, its durable
log, its stream subscribers) must live in exactly one process, so:

- **pinning**: :func:`queue_owner` maps ``(namespace, name)`` to a worker
  by rendezvous ranking over ``w0 .. w{N-1}``
  (:mod:`psana_ray_tpu_torch.cluster.hashring`), the same map in every
  process, run, respawn and package. The default queue is worker 0's;
- **adoption**: each worker binds an ``AF_UNIX`` datagram socket
  (``worker-<i>.sock``). When a connection's first queue op names a
  queue another worker owns, the serving worker ships the connection's
  fd over ``SCM_RIGHTS`` with a small JSON context (codec, tenant, the
  pending op) and forgets it. The event loop reads exact sizes and never
  past the current op, so bytes the client pipelined are still in the
  kernel's socket buffer and travel with the fd;
- **supervision**: :class:`WorkerSupervisor` forks, reaps and respawns a
  dead worker under the same id, so the map never moves; the new worker
  finds its queues in the durable log, which re-exposes ``(floor,
  tail]`` at the next OPEN. The supervisor waits on the pids it forked,
  never on any child of the process.

Imports no torch.
"""

from __future__ import annotations

import array
import json
import os
import signal
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional

from psana_ray_tpu_torch.cluster.hashring import partition_owner
from psana_ray_tpu_torch.obs.flight import FLIGHT

__all__ = ["DEFAULT_QUEUE_WORKER", "MIGRATE_GRACE_S", "MIGRATE_RETRY_S", "WorkerContext",
           "WorkerSupervisor", "current_worker_id", "queue_owner", "resolve_port"]

#: the worker that owns the default (never OPENed) queue
DEFAULT_QUEUE_WORKER = 0

#: how long a migration retries against a dead or respawning owner before
#: the connection is dropped (the client's reconnect takes over)
MIGRATE_GRACE_S = 2.0
MIGRATE_RETRY_S = 0.25

#: adoption datagram: u32 JSON length + JSON; the fd rides the ancillary data
_ADOPT_HDR = struct.Struct("<I")
_ADOPT_MAX = 16 * 1024

_CURRENT_WORKER_ID: Optional[int] = None


def current_worker_id() -> Optional[int]:
    """This process's worker id (None outside a ``--workers`` fleet)."""
    return _CURRENT_WORKER_ID


#: the supervisor's reaping cadence
_REAP_TICK_S = 0.05


def queue_owner(namespace: str, name: str, n_workers: int) -> int:
    """The worker pinned to ``(namespace, name)``."""
    if n_workers <= 1:
        return 0
    members = [f"w{i}" for i in range(n_workers)]
    return int(partition_owner(members, f"{namespace}/{name}", 0)[1:])


def resolve_port(host: str, port: int) -> int:
    """A port every worker can bind with ``SO_REUSEPORT``: ``port`` if
    nonzero, else one the kernel assigns to a throwaway bind (closed before
    any worker binds; a client in the gap is refused and reconnects)."""
    if port:
        return int(port)
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s.bind((host, 0))
        return s.getsockname()[1]
    finally:
        s.close()


class WorkerContext:
    """One worker's end of the adoption plane, made in the worker after
    the fork: its bound datagram socket, its peers' addresses, and the
    send and receive the event loop calls."""

    def __init__(self, worker_id: int, n_workers: int, sock_dir: str):
        global _CURRENT_WORKER_ID
        self.worker_id = int(worker_id)
        self.n_workers = int(n_workers)
        self.sock_dir = sock_dir
        self.migrated = 0
        self.adopted = 0
        path = self._peer_path(self.worker_id)
        try:  # a respawned worker takes its predecessor's address
            os.unlink(path)
        except FileNotFoundError:
            pass
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        self.sock.bind(path)
        self.sock.setblocking(False)
        self._send_sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        self._send_sock.setblocking(False)
        _CURRENT_WORKER_ID = self.worker_id

    def _peer_path(self, wid: int) -> str:
        return os.path.join(self.sock_dir, f"worker-{wid}.sock")

    def owner_of(self, namespace: str, name: str) -> int:
        return queue_owner(namespace, name, self.n_workers)

    def send_conn(self, target: int, sock: socket.socket, ctx: dict) -> None:
        """Ship ``sock`` and its context to worker ``target``. Raises
        OSError while the target respawns (ENOENT, ECONNREFUSED) or when
        its buffer is full (EAGAIN): the caller's retry timer owns the
        grace period. On return the datagram holds its own reference to
        the fd and the caller closes its copy."""
        blob = json.dumps(ctx).encode()
        if len(blob) > _ADOPT_MAX:
            raise ValueError(f"adoption context too large: {len(blob)}")
        # sendmsg with the address: socket.send_fds drops its address argument
        self._send_sock.sendmsg(
            [_ADOPT_HDR.pack(len(blob)) + blob],
            [(socket.SOL_SOCKET, socket.SCM_RIGHTS, array.array("i", [sock.fileno()]))],
            0, self._peer_path(target))
        self.migrated += 1

    def recv_conns(self) -> List:
        """Every pending adoption, ``[(socket, ctx), ...]``; never blocks. A
        malformed datagram is dropped and its fds closed."""
        out = []
        while True:
            try:
                data, fds, _flags, _addr = socket.recv_fds(self.sock, _ADOPT_HDR.size + _ADOPT_MAX,
                                                           4)
            except OSError:  # BlockingIOError included: none left
                return out
            if not data:
                return out
            try:
                (n,) = _ADOPT_HDR.unpack_from(data)
                ctx = json.loads(data[_ADOPT_HDR.size:_ADOPT_HDR.size + n])
            except (struct.error, ValueError):
                ctx = None
            if not isinstance(ctx, dict) or len(fds) != 1:
                for fd in fds:
                    os.close(fd)
                if not isinstance(ctx, dict):
                    FLIGHT.record("adopt_bad_datagram", worker=self.worker_id)
                else:
                    FLIGHT.record("adopt_bad_fd_count", worker=self.worker_id, fds=len(fds))
                continue
            self.adopted += 1
            out.append((socket.socket(fileno=fds[0]), ctx))

    def close(self) -> None:
        try:
            self.sock.close()
        finally:
            self._send_sock.close()


class WorkerSupervisor:
    """The fleet's parent: fork N workers, reap them, respawn a dead one
    under the same id, stop them all.

    ``worker_fn(worker_id)`` runs in each child and serves until the
    process ends; ``os._exit`` keeps the child out of the caller's code.
    The supervisor reaps only the pids it forked (``waitpid(pid,
    WNOHANG)`` on each, every ``_REAP_TICK_S``): any other child of the
    process keeps its exit status for whoever waits on it."""

    def __init__(self, n_workers: int, worker_fn: Callable[[int], None]):
        if n_workers < 1:
            raise ValueError("need at least one worker")
        self.n_workers = int(n_workers)
        self._worker_fn = worker_fn
        self._lock = threading.Lock()
        self._pids: Dict[int, int] = {}  # pid -> worker id  # guarded-by: _lock
        self._spawned_at: Dict[int, float] = {}  # worker id -> last fork  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.respawns = 0  # guarded-by: _lock
        self.last_respawn_s = None  # death seen -> new worker forked  # guarded-by: _lock

    def start(self) -> "WorkerSupervisor":
        """Fork every worker, then start the reaping thread (forking before
        any thread of this object runs)."""
        for wid in range(self.n_workers):
            self._spawn(wid)
        self._thread = threading.Thread(target=self._supervise, daemon=True,
                                        name="worker-supervisor")
        self._thread.start()
        return self

    def _spawn(self, worker_id: int) -> None:
        now = time.monotonic()
        with self._lock:
            last = self._spawned_at.get(worker_id, 0.0)
            self._spawned_at[worker_id] = now
        crash_loop = now - last < 1.0
        pid = os.fork()
        if pid == 0:
            # the child: default signal dispositions (the parent's handlers
            # must not leak in), then serve; _exit fences the parent's stack
            code = 0
            try:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                signal.signal(signal.SIGINT, signal.SIG_DFL)
                if crash_loop:
                    # died within a second of its start: pause before the
                    # rebuild, so a crash loop burns seconds, not a core
                    time.sleep(0.5)
                self._worker_fn(worker_id)
            except BaseException:
                code = 1
            os._exit(code)
        with self._lock:
            self._pids[pid] = worker_id
        FLIGHT.record("worker_spawned", worker=worker_id, pid=pid)

    def _reap(self, pid: int) -> Optional[int]:
        """The exit status of ``pid`` once it has ended (reaped now), else
        None. A pid reaped elsewhere reads as ended."""
        try:
            got, status = os.waitpid(pid, os.WNOHANG)
        except ChildProcessError:
            return -1
        return status if got == pid else None

    def _supervise(self) -> None:
        while not self._stop.wait(_REAP_TICK_S):
            with self._lock:
                pids = list(self._pids)
            for pid in pids:
                status = self._reap(pid)
                if status is None:
                    continue
                t_dead = time.monotonic()
                with self._lock:
                    wid = self._pids.pop(pid, None)
                if wid is None or self._stop.is_set():
                    continue
                FLIGHT.record("worker_died", worker=wid, pid=pid,
                              status=os.waitstatus_to_exitcode(status) if status >= 0 else status)
                self._spawn(wid)
                with self._lock:
                    self.respawns += 1
                    self.last_respawn_s = time.monotonic() - t_dead

    def stop(self, sig: int = signal.SIGTERM, timeout_s: float = 10.0) -> None:
        """Send ``sig`` to every worker and reap them; a worker still alive
        at the deadline gets SIGKILL."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)  # no respawn races the stop
            self._thread = None
        with self._lock:
            pids = list(self._pids)
        for pid in pids:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + timeout_s
        while pids and time.monotonic() < deadline:
            pids = [pid for pid in pids if self._reap(pid) is None]
            if pids:
                time.sleep(_REAP_TICK_S)
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            try:
                os.waitpid(pid, 0)
            except ChildProcessError:
                pass
        with self._lock:
            self._pids.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {"workers": self.n_workers, "alive": len(self._pids),
                    "respawns_total": self.respawns, "last_respawn_s": self.last_respawn_s}
