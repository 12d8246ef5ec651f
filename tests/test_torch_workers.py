"""The port's queue server worker fleet and ``sendfile`` pass-through.

The pieces one by one, then the fleet as a process:

- ``queue_owner`` gives the JAX package's answer for every name (clients
  of either package reach either package's fleet), deterministic across
  processes;
- ``WorkerContext`` ships a connection's fd over ``SCM_RIGHTS`` with its
  context, the bytes already in the socket's kernel buffer travelling
  with it; a malformed datagram is dropped without leaking its fd;
- ``WorkerSupervisor`` respawns a killed worker under its id, stops and
  reaps the whole fleet, and reaps no child it did not fork: an
  unrelated ``subprocess`` beside it keeps its exit code;
- the splice primitives, and the spliced relay, plain and compressed;
- ``python -m psana_ray_tpu_torch.queue_server --workers 2``: queues of
  either worker and the default queue, whichever worker the kernel hands
  a connection, and ``kill -9`` of each worker in turn mid-stream with no
  event lost; the refused combinations.
"""

import array
import errno
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from psana_ray_tpu.transport import workers as jax_workers  # noqa: E402
from psana_ray_tpu_torch.records import FrameRecord, is_eos  # noqa: E402
from psana_ray_tpu_torch.storage import DurableRingBuffer, SegmentLog  # noqa: E402
from psana_ray_tpu_torch.transport.splice import (  # noqa: E402
    SPLICE,
    FileSpan,
    fallback_errno,
    probe_report,
    sendfile_capable,
)
from psana_ray_tpu_torch.transport.tcp import TcpQueueClient, TcpQueueServer  # noqa: E402
from psana_ray_tpu_torch.transport.workers import (  # noqa: E402
    DEFAULT_QUEUE_WORKER,
    WorkerContext,
    WorkerSupervisor,
    queue_owner,
    resolve_port,
)
from torch_parity import _no_lingering_child  # noqa: E402,F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET = hasattr(socket, "SO_REUSEPORT") and hasattr(os, "fork") and os.path.isdir("/proc")


def _rec(i, shape=(1, 16, 16)):
    return FrameRecord(0, i, np.full(shape, i % 4096, np.uint16), 9.5)


def _client(port, **kw):
    kw.setdefault("reconnect_tries", 6)
    kw.setdefault("reconnect_base_s", 0.1)
    return TcpQueueClient("127.0.0.1", port, timeout_s=10.0, **kw)


def _drain(client, want, timeout=1.0, deadline_s=30.0):
    out = []
    deadline = time.monotonic() + deadline_s
    while len(out) < want and time.monotonic() < deadline:
        batch = client.get_batch(64, timeout=timeout)
        out.extend(r for r in batch if not is_eos(r))
        if any(is_eos(r) for r in batch):
            break
    return out


# -- pinning ------------------------------------------------------------------
@pytest.mark.parametrize("n", range(1, 9))
def test_queue_owner_is_the_jax_packages(n):
    rng = np.random.default_rng(n)
    names = [(f"ns{rng.integers(0, 50)}", f"q{rng.integers(0, 10**6)}") for _ in range(300)]
    names += [("default", "shared_queue"), ("default", "default"), ("", "")]
    ours = [queue_owner(ns, nm, n) for ns, nm in names]
    assert ours == [jax_workers.queue_owner(ns, nm, n) for ns, nm in names]
    assert all(0 <= w < n for w in ours)
    if n > 1:  # every worker owns some of 300 names
        assert set(ours) == set(range(n))


def test_pinning_is_exact_and_survives_the_process_boundary():
    assert DEFAULT_QUEUE_WORKER == 0
    assert {f"q{i}": queue_owner("ns", f"q{i}", 2) for i in range(8)} == {
        "q0": 0, "q1": 0, "q2": 0, "q3": 1, "q4": 0, "q5": 1, "q6": 0, "q7": 0}
    here = {f"q{i}": queue_owner("ns", f"q{i}", 3) for i in range(16)}
    code = ("from psana_ray_tpu_torch.transport.workers import queue_owner;"
            "print({f'q{i}': queue_owner('ns', f'q{i}', 3) for i in range(16)})")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    assert eval(out.stdout.strip()) == here


# -- SCM_RIGHTS migration -------------------------------------------------------
def _contexts(tmp_path, n=2):
    return [WorkerContext(i, n, str(tmp_path)) for i in range(n)]


def test_fd_migration_carries_context_and_buffered_bytes(tmp_path):
    c0, c1 = _contexts(tmp_path)
    try:
        a, b = socket.socketpair()
        try:
            # bytes the client pipelined before the migration wait in a's
            # kernel buffer: they must travel with the fd
            b.sendall(b"pipelined")
            ctx = {"kind": "op", "op": 7, "codec": "shuffle-rle"}
            c0.send_conn(1, a, ctx)
        finally:
            a.close()  # the datagram holds its own reference
        (sock, got_ctx), = c1.recv_conns()
        try:
            assert got_ctx == ctx and (c0.migrated, c1.adopted) == (1, 1)
            sock.settimeout(5.0)
            assert sock.recv(16) == b"pipelined"
            sock.sendall(b"reply")
            b.settimeout(5.0)
            assert b.recv(16) == b"reply"
        finally:
            sock.close()
            b.close()
    finally:
        c0.close()
        c1.close()


def test_bad_datagram_is_dropped_and_its_fd_closed(tmp_path):
    c0, c1 = _contexts(tmp_path)
    a, b = socket.socketpair()
    try:
        n_fds = len(os.listdir("/proc/self/fd"))
        # a length field that claims more than the datagram holds
        c0._send_sock.sendmsg([b"\xff\xff\xff\xff"],
                              [(socket.SOL_SOCKET, socket.SCM_RIGHTS,
                                array.array("i", [a.fileno()]))],
                              0, os.path.join(str(tmp_path), "worker-1.sock"))
        assert c1.recv_conns() == []
        assert len(os.listdir("/proc/self/fd")) == n_fds  # the passed fd was closed
        t0 = time.monotonic()
        assert c1.recv_conns() == []  # an empty socket answers at once
        assert time.monotonic() - t0 < 0.5
        assert [c0.owner_of("ns", f"q{i}") for i in range(8)] == [
            queue_owner("ns", f"q{i}", 2) for i in range(8)]
    finally:
        a.close()
        b.close()
        c0.close()
        c1.close()


def test_send_to_a_worker_that_is_not_there_raises(tmp_path):
    c0 = WorkerContext(0, 2, str(tmp_path))
    a, b = socket.socketpair()
    try:
        with pytest.raises(OSError) as e:
            c0.send_conn(1, a, {"kind": "op", "op": 71})
        assert e.value.errno in (errno.ENOENT, errno.ECONNREFUSED)
    finally:
        a.close()
        b.close()
        c0.close()


# -- the supervisor -------------------------------------------------------------
def _sleeper(worker_id):
    while True:
        time.sleep(3600)


def _live(sup):
    """``{worker id: pid}`` of the supervisor's live fleet."""
    with sup._lock:
        return {wid: pid for pid, wid in sup._pids.items()}


def _wait(cond, timeout=15.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


@pytest.mark.skipif(not hasattr(os, "fork"), reason="needs os.fork")
def test_respawn_keeps_worker_id_and_leaves_other_children_alone():
    # an unrelated child of this process, started before the fleet
    other = subprocess.Popen([sys.executable, "-c", "import time, sys; time.sleep(0.5); "
                                                    "sys.exit(7)"])
    sup = WorkerSupervisor(2, _sleeper).start()
    try:
        pids = _live(sup)
        assert set(pids) == {0, 1}
        os.kill(pids[1], signal.SIGKILL)
        assert _wait(lambda: set(_live(sup)) == {0, 1} and _live(sup)[1] != pids[1])
        assert _live(sup)[0] == pids[0]  # the survivor undisturbed
        snap = sup.snapshot()
        assert snap["respawns_total"] == 1 and 0 <= snap["last_respawn_s"] < 5
        # the supervisor reaped only its own: the exit code is still ours
        assert other.wait(timeout=30) == 7
    finally:
        sup.stop(timeout_s=10.0)
        if other.poll() is None:
            other.kill()
            other.wait()
    assert _live(sup) == {}


@pytest.mark.skipif(not hasattr(os, "fork"), reason="needs os.fork")
def test_stop_reaps_the_fleet():
    sup = WorkerSupervisor(3, _sleeper).start()
    pids = list(_live(sup).values())
    assert len(pids) == 3
    sup.stop(timeout_s=10.0)
    assert _live(sup) == {}
    for pid in pids:
        with pytest.raises(ChildProcessError):  # reaped: no child of that pid
            os.waitpid(pid, os.WNOHANG)
    with pytest.raises(ValueError):
        WorkerSupervisor(0, _sleeper)


# -- the splice primitives --------------------------------------------------------
def test_filespan_advance_and_materialize(tmp_path):
    p = tmp_path / "seg"
    p.write_bytes(b"xxx" + b"payload-bytes" + b"yyy")
    with open(p, "rb") as f:
        span = FileSpan(f, 3, 13)
        assert span.materialize() == b"payload-bytes"
        span.advance(8)
        assert (span.pos, span.nbytes) == (11, 5)
        assert span.materialize() == b"bytes"
        assert f.tell() == 0  # pread: the file's position untouched


def test_fallback_errno_probe_and_port():
    assert fallback_errno(OSError(errno.EINVAL, "x"))
    assert fallback_errno(OSError(errno.ENOTSOCK, "x"))
    assert not fallback_errno(OSError(errno.EPIPE, "x"))
    assert not fallback_errno(OSError(errno.ECONNRESET, "x"))
    rep = probe_report()
    assert set(rep) == {"sendfile", "msg_zerocopy"}
    assert all(isinstance(v, bool) for v in rep.values())
    assert sendfile_capable() == rep["sendfile"]
    if hasattr(socket, "SO_REUSEPORT"):
        port = resolve_port("127.0.0.1", 0)
        assert 0 < port < 65536 and resolve_port("127.0.0.1", port) == port
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            s.bind(("127.0.0.1", port))
        finally:
            s.close()


def _spill_server(root, ram_items=1):
    """A durable server whose queues spill at once and deliver spilled
    records unread: every frame past the first rides ``sendfile`` on a
    plain connection."""

    def factory(ns, name, maxsize):
        log = SegmentLog(os.path.join(str(root), f"{ns}__{name}"), name=name,
                         segment_bytes=1 << 20, fsync="none")
        return DurableRingBuffer(log, maxsize=maxsize, name=name, ram_items=ram_items)

    return TcpQueueServer(factory("default", "default", 500), host="127.0.0.1", maxsize=500,
                          queue_factory=factory).serve_background()


@pytest.mark.parametrize("codec", [None, "shuffle-rle"])
def test_spliced_relay_roundtrips(tmp_path, codec):
    srv = _spill_server(tmp_path)
    try:
        before = SPLICE.snapshot()
        prod = _client(srv.port, namespace="ns", queue_name="sp")
        for i in range(24):
            assert prod.put(_rec(i))
        cons = _client(srv.port, namespace="ns", queue_name="sp", codec=codec)
        got = _drain(cons, 24)
        assert [r.event_idx for r in got] == list(range(24))
        assert all(np.array_equal(r.panels, _rec(r.event_idx).panels) for r in got)
        after = SPLICE.snapshot()
        if codec is None and sendfile_capable():
            # the server counts a frame once os.sendfile has returned, which
            # can be after the consumer already holds its bytes: wait for the
            # loop's count (bounded), then hold it to exactly 23
            deadline = time.monotonic() + 10.0
            while (after["spliced_frames_total"] - before["spliced_frames_total"] < 23
                   and time.monotonic() < deadline):
                time.sleep(0.01)
                after = SPLICE.snapshot()
            assert after["spliced_frames_total"] - before["spliced_frames_total"] == 23
            assert after["spliced_bytes_total"] > before["spliced_bytes_total"]
        else:  # a compressed connection reads the spilled records in
            assert after["spliced_frames_total"] == before["spliced_frames_total"]
        prod.disconnect()
        cons.disconnect()
    finally:
        srv.shutdown()


# -- the fleet as a process ---------------------------------------------------------
def _children(parent_pid):
    """The direct children of ``parent_pid`` (the fleet's workers)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat", "rb") as f:
                stat = f.read().decode("latin-1")
            if int(stat.rsplit(")", 1)[1].split()[1]) == parent_pid:
                out.append(int(d))
        except (OSError, IndexError, ValueError):
            continue
    return sorted(out)


class _Fleet:
    def __init__(self, tmp_path, n=2, *extra):
        port_file = str(tmp_path / "port")
        self.log = open(str(tmp_path / "fleet.log"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "psana_ray_tpu_torch.queue_server", "--workers", str(n),
             "--host", "127.0.0.1", "--port", "0", "--durable_dir", str(tmp_path / "log"),
             "--fsync", "batch", "--fsync_batch_n", "1", "--port_file", port_file,
             "--queue_size", "500", "--segment_bytes", str(1 << 20), "--drain_s", "1", *extra],
            cwd=REPO, stdout=self.log, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": REPO})
        deadline = time.monotonic() + 30
        while not os.path.exists(port_file):
            assert self.proc.poll() is None and time.monotonic() < deadline, self.stop()
            time.sleep(0.05)
        with open(port_file) as f:
            self.port = int(f.read())

    def listening(self, pid):
        """Has worker ``pid`` bound the port? (Its ``listening`` line.)"""
        with open(self.log.name) as f:
            return f"(pid {pid}) listening" in f.read()

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)
        self.log.seek(0)
        out = self.log.read()
        self.log.close()
        return out


@pytest.mark.skipif(not FLEET, reason="needs SO_REUSEPORT, fork and /proc")
def test_fleet_routes_every_queue_and_the_default(tmp_path):
    fleet = _Fleet(tmp_path)
    try:
        workers = _children(fleet.proc.pid)
        assert len(workers) == 2
        # q0 is worker 0's, q3 worker 1's; the kernel hands each connection
        # to either, and several connections see both
        for ns, name in (("ns", "q0"), ("ns", "q3"), (None, None)):
            prods = [_client(fleet.port, namespace=ns, queue_name=name) for _ in range(3)]
            for i in range(12):
                assert prods[i % 3].put(_rec(i))
            cons = _client(fleet.port, namespace=ns, queue_name=name)
            assert [r.event_idx for r in _drain(cons, 12)] == list(range(12)), name
            for c in (*prods, cons):
                c.disconnect()
    finally:
        out = fleet.stop()
    assert fleet.proc.returncode == 0, out[-3000:]
    assert out.count("queue server stopped") == 3  # two workers and the parent
    assert not _children(fleet.proc.pid)


@pytest.mark.skipif(not FLEET, reason="needs SO_REUSEPORT, fork and /proc")
def test_kill9_each_worker_mid_stream_zero_loss(tmp_path):
    # a consumer mid-stream (a prefix consumed, its connection live) when
    # each worker in turn is killed -9, so the queue's owner dies once,
    # whichever it is. The supervisor forks it again under its id, the log
    # re-exposes what was not acked, and the same client resumes through
    # its reconnect: no loss, duplicates allowed
    fleet = _Fleet(tmp_path)
    try:
        prod = _client(fleet.port, namespace="ns", queue_name="q3")
        for i in range(20):
            assert prod.put(_rec(i))
        prod.disconnect()
        cons = _client(fleet.port, namespace="ns", queue_name="q3")
        first = cons.get_batch(6, timeout=5.0)
        assert len(first) == 6
        cons.size()  # the implicit ack moves the committed offset
        for victim in _children(fleet.proc.pid):
            os.kill(victim, signal.SIGKILL)
            assert _wait(lambda: victim not in _children(fleet.proc.pid)
                         and len(_children(fleet.proc.pid)) == 2, timeout=20)
            # forked is not serving: the next kill must find the new worker
            # listening, or no worker holds the port and a dial is refused
            new = set(_children(fleet.proc.pid)) - {victim}
            assert _wait(lambda: all(fleet.listening(pid) for pid in new), timeout=20)
        seen = {r.event_idx for r in first}
        deadline = time.monotonic() + 30
        while seen != set(range(20)) and time.monotonic() < deadline:
            seen.update(r.event_idx for r in cons.get_batch(64, timeout=1.0))
        assert seen == set(range(20)), f"lost={sorted(set(range(20)) - seen)}"
        cons.disconnect()
    finally:
        out = fleet.stop()
    assert fleet.proc.returncode == 0, out[-3000:]
    # the queue's log opened twice: at the first put, and by the respawned owner
    assert out.count("durable queue (ns, q3): recovered") == 2, out[-3000:]


@pytest.mark.parametrize("extra,word", [
    (["--shm", "ring"], "--workers"),
    (["--durable_dir", "d", "--shm", "ring"], "--durable_dir"),
    (["--replicate_peers", "a:1,b:2", "--advertise", "a:1", "--durable_dir", "d"],
     "--workers is incompatible with --replicate_peers"),
])
def test_cli_refuses_incompatible_planes(extra, word):
    out = subprocess.run([sys.executable, "-m", "psana_ray_tpu_torch.queue_server", "--workers",
                          "2", "--port", "0", *extra], capture_output=True, text=True, cwd=REPO,
                         timeout=60, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 2, out.stderr
    assert word in out.stderr
