"""The port's TCP transport talks to the JAX package's, both ways.

The JAX package's ``TcpQueueServer`` with the port's ``TcpQueueClient``,
and the port's server with the JAX client, over every opcode either
client sends: P, G, S, B, D, Q, U, W, M, K, O, T, A, Z (and C and F).
Seeded f32 and uint16 frames cross raw and compressed (``shuffle-rle``
negotiated on both connections, or on the producer's alone, so the server
inflates them for a raw consumer) and arrive bit-identical. The opcodes
the port leaves out (H, Y, V; the consumer-group RPCs of N), and R and J
on a memory queue, get the answers the JAX server gives where that
feature is not configured, and ``codec="auto"``'s link probe (A and the N
ping) works against both. R and J work against a durable server of either
package, and a client of either package reaches both workers' queues of
the other's ``--workers 2`` fleet.
"""

import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from psana_ray_tpu.records import EndOfStream as JaxEos  # noqa: E402
from psana_ray_tpu.records import FrameRecord as JaxRecord  # noqa: E402
from psana_ray_tpu.transport import TransportClosed as JaxClosed  # noqa: E402
from psana_ray_tpu.transport import tcp as jax_tcp  # noqa: E402
from psana_ray_tpu.transport.ring import RingBuffer as JaxRing  # noqa: E402
from psana_ray_tpu_torch.records import EndOfStream, FrameRecord  # noqa: E402
from psana_ray_tpu_torch.transport import EMPTY, TransportClosed  # noqa: E402
from psana_ray_tpu_torch.transport import tcp as port_tcp  # noqa: E402
from psana_ray_tpu_torch.transport.ring import RingBuffer  # noqa: E402
from torch_parity import _no_lingering_child  # noqa: E402,F401 (autouse)

FAST = dict(reconnect_tries=3, reconnect_base_s=0.05)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (server module, its ring, client module, the client's record classes)
PAIRS = {
    "jax_server-port_client": (jax_tcp, JaxRing, port_tcp, FrameRecord, EndOfStream),
    "port_server-jax_client": (port_tcp, RingBuffer, jax_tcp, JaxRecord, JaxEos),
}


@pytest.fixture(params=sorted(PAIRS))
def pair(request):
    srv_mod, ring, cli_mod, rec, eos = PAIRS[request.param]
    q = ring(64)
    srv = srv_mod.TcpQueueServer(q, host="127.0.0.1").serve_background()

    def client(**kw):
        return cli_mod.TcpQueueClient("127.0.0.1", srv.port, timeout_s=10.0, **{**FAST, **kw})

    yield q, srv, client, rec, eos
    srv.close_all()
    srv.shutdown()


def _frames(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.normal(1000.0, 4.0, (2, 32, 48))
    return [(base + rng.normal(0.0, 3.0, base.shape)).astype(dtype) for _ in range(n)]


def test_request_response_opcodes(pair):
    """O, P, G, S, B, D, Q, U, T, A and C between the two packages."""
    q, srv, client, rec, eos = pair
    c = client(namespace="ns", queue_name="q")  # O
    assert srv.named_queues() == [("ns", "q")]
    frames = _frames(3, np.float32)
    assert c.put(rec(0, 0, frames[0], 1.5))  # P
    assert c.size() == 1  # S
    got = c.get()  # G
    assert got.event_idx == 0 and np.array_equal(got.panels, frames[0])
    assert repr(c.get()) == repr(EMPTY)  # each package's own sentinel
    assert c.put_batch([rec(0, i, frames[i], 1.0) for i in (1, 2)]) == 2  # Q
    assert [r.event_idx for r in c.get_batch(5, timeout=0.0)] == [1, 2]  # B
    c2 = client(namespace="ns", queue_name="q")
    threading.Timer(0.2, lambda: c2.put(eos(producer_rank=4))).start()
    assert c.get_wait(timeout=5.0).producer_rank == 4  # D, answered when the put lands
    assert c.put_wait({"any": "object"}, timeout=2.0)  # U; a pickled payload
    assert c.get() == {"any": "object"}
    stats = c.stats()  # T
    assert stats["puts"] == 5 and stats["gets"] == 5 and stats["high_water"] >= 1
    anchor = c.anchor()  # A
    assert anchor["rtt_s"] >= 0 and anchor["peer_mono"] > 0
    c.close_remote()  # C
    with pytest.raises((TransportClosed, JaxClosed)):
        c2.put(1)
    c.disconnect()
    c2.disconnect()


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
@pytest.mark.parametrize("codecs", [(None, None), ("shuffle-rle", "shuffle-rle"),
                                    ("shuffle-rle", None)])
def test_windowed_puts_and_streams_carry_frames_bit_identical(pair, dtype, codecs):
    """W and M/K with Z: frames cross raw, compressed both ways, and
    compressed in then raw out (the server inflates them)."""
    _, srv, client, rec, eos = pair
    producer = client(namespace="ns", queue_name="frames", codec=codecs[0])
    consumer = client(namespace="ns", queue_name="frames", codec=codecs[1])
    assert producer.codec_name == codecs[0] and consumer.codec_name == codecs[1]
    frames = _frames(12, dtype, seed=int(np.dtype(dtype).itemsize))
    consumer.stream_open(4)  # M: four credits
    for i, f in enumerate(frames):  # W
        assert producer.put_pipelined(rec(1, i, f, 2.0 + i), deadline=time.monotonic() + 10)
    assert producer.put_pipelined(eos(total_events=12), deadline=time.monotonic() + 10)
    assert producer.flush_puts(deadline=time.monotonic() + 10)
    got = []
    deadline = time.monotonic() + 10
    while not (got and type(got[-1]).__name__ == "EndOfStream") and time.monotonic() < deadline:
        got.extend(consumer.get_batch_stream(4, timeout=1.0))  # each call sends K
    assert [r.event_idx for r in got[:-1]] == list(range(12))
    for r, f in zip(got, frames):
        assert r.panels.dtype == dtype and r.panels.tobytes() == f.tobytes()
        assert (r.shard_rank, r.photon_energy) == (1, 2.0 + r.event_idx)
    assert got[-1].total_events == 12
    producer.disconnect()
    consumer.disconnect()


def test_tenant_hello_and_auto_codec_probe(pair, monkeypatch):
    """Z with a tenant field, and ``codec="auto"``: the link probe (A, N
    ping) decides raw on loopback, and compression under a threshold no
    link reaches."""
    _, srv, client, rec, _ = pair
    c = client(tenant="alice", tenant_weight=4, codec="shuffle-rle")
    assert c.codec_name == "shuffle-rle"
    assert client(codec="auto").codec_name is None  # loopback is fast
    monkeypatch.setenv("PSANA_AUTO_CODEC_MB_S", "1e12")
    slow = client(codec="auto")
    assert slow.codec_name == "shuffle-rle"
    f = _frames(1, np.uint16)[0]
    assert slow.put(rec(0, 0, f, 1.0))
    assert c.get().panels.tobytes() == f.tobytes()
    for x in (c, slow):
        x.disconnect()


def _exchange(port, request: bytes, n_answer: int) -> tuple:
    """Send raw bytes; ``(the n_answer bytes read back, whether the
    server then closed the connection)``."""
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(request)
        out = b""
        while len(out) < n_answer:
            chunk = s.recv(n_answer - len(out))
            if not chunk:
                return out, True
            out += chunk
        s.settimeout(0.3)
        try:
            return out, s.recv(1) == b""
        except socket.timeout:
            return out, False
        except ConnectionResetError:  # closed with the request's tail unread
            return out, True


def _json_answer(port, req: bytes) -> dict:
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(b"N" + struct.pack("<I", len(req)) + req)
        f = s.makefile("rb")
        assert f.read(1) == b"1"
        (n,) = struct.unpack("<I", f.read(4))
        return json.loads(f.read(n))


def _named(op: bytes, ns: bytes, nm: bytes) -> bytes:
    return op + struct.pack("<H", len(ns)) + ns + struct.pack("<H", len(nm)) + nm


LEFT_OUT = {
    "R_replay_open": (b"R" + struct.pack("<QH", (1 << 64) - 1, 5) + b"group", 1),
    "J_commit": (b"J" + struct.pack("<QH", 3, 5) + b"group", 1),
    "H_replica_subscribe": (_named(b"H", b"ns", b"q"), 1),
    "Y_promote": (_named(b"Y", b"ns", b"q"), 1),
    "V_replica_append": (b"V" + struct.pack("<QQI", 0, 0, 0), 1),
    "unknown_opcode": (b"\x00", 1),
}


@pytest.mark.parametrize("case", sorted(LEFT_OUT))
def test_left_out_opcodes_answer_as_the_jax_server_without_the_feature(case):
    request, n = LEFT_OUT[case]
    answers = []
    for mod, ring in ((jax_tcp, JaxRing), (port_tcp, RingBuffer)):
        srv = mod.TcpQueueServer(ring(4), host="127.0.0.1").serve_background()
        try:
            answers.append(_exchange(srv.port, request, n))
        finally:
            srv.shutdown()
    assert answers[0] == answers[1], (case, answers)
    assert answers[1][0] in (b"0", b"E")


def test_group_rpc_answers():
    """N: the link probe's ping, a request naming no group and a
    consumer-group join (through the JAX client's ``cluster_rpc``) are
    answered exactly as the JAX server answers them."""
    servers = [mod.TcpQueueServer(ring(4), host="127.0.0.1").serve_background()
               for mod, ring in ((jax_tcp, JaxRing), (port_tcp, RingBuffer))]
    try:
        ping = b'{"op": "ping", "pad": "' + b"x" * 1000 + b'"}'
        for req in (ping, b'{"op": "ping"}', b'{"op": "join"}', b"not json"):
            jax_answer, port_answer = (_json_answer(s.port, req) for s in servers)
            if req == b"not json":
                assert jax_answer["ok"] is port_answer["ok"] is False
            else:
                assert jax_answer == port_answer, req
        joined = []
        for s in servers:
            c = jax_tcp.TcpQueueClient("127.0.0.1", s.port, **FAST)
            joined.append(c.cluster_rpc({"op": "join", "group": "g", "member": "m",
                                         "n_partitions": 2}))
            c.disconnect()
        assert joined[0] == joined[1] and joined[1]["ok"] and joined[1]["members"] == ["m"]
    finally:
        for s in servers:
            s.shutdown()


# -- durable queues ('R', 'J') and the worker fleet, both ways -----------------
def _durable_backing(mod_storage, root, ns, name, maxsize):
    log = mod_storage.SegmentLog(os.path.join(str(root), f"{ns}__{name}"), name=name,
                                 segment_bytes=1 << 20, fsync="none")
    # spilled records delivered unread, as each package's queue server
    # builds its queues (the port's always does)
    lazy = {"lazy_spill": True} if mod_storage.__name__ == "psana_ray_tpu.storage" else {}
    return mod_storage.DurableRingBuffer(log, maxsize=maxsize, name=name, ram_items=2, **lazy)


DURABLE_PAIRS = {
    "jax_server-port_client": ("jax", port_tcp, FrameRecord, EndOfStream),
    "port_server-jax_client": ("port", jax_tcp, JaxRecord, JaxEos),
}


@pytest.mark.parametrize("case", sorted(DURABLE_PAIRS))
def test_replay_and_commit_across_the_packages(tmp_path, case):
    """R from begin and from resume, J for the cursor and for a named group,
    and the implicit ack's committed floor, between a durable server of one
    package and the other's client; spilled records (sent by sendfile from
    the port's server) arrive bit-identical."""
    import psana_ray_tpu.storage as jax_storage

    import psana_ray_tpu_torch.storage as port_storage

    server_pkg, cli_mod, rec, eos = DURABLE_PAIRS[case]
    srv_mod, mod_storage = ((jax_tcp, jax_storage) if server_pkg == "jax"
                            else (port_tcp, port_storage))

    def factory(ns, name, maxsize):
        return _durable_backing(mod_storage, tmp_path, ns, name, maxsize)

    srv = srv_mod.TcpQueueServer(factory("default", "default", 64), host="127.0.0.1",
                                 queue_factory=factory).serve_background()

    def client(**kw):
        return cli_mod.TcpQueueClient("127.0.0.1", srv.port, timeout_s=10.0, namespace="ns",
                                      queue_name="d", **{**FAST, **kw})

    try:
        frames = _frames(8, np.uint16, seed=3)
        prod = client()
        for i, f in enumerate(frames):
            assert prod.put(rec(0, i, f, 1.0 + i))
        assert prod.put(eos(total_events=8))
        live = client()
        assert [r.event_idx for r in live.get_batch(3, timeout=1.0)] == [0, 1, 2]
        live.size()  # the implicit ack
        queue = srv.open_named("ns", "d")
        assert queue.stats()["committed_offset"] == 2
        rep = client()
        assert rep.replay_open("begin", group="audit") == {"start": 0, "end": 9}
        got = rep.get_batch(5, timeout=1.0)
        assert [r.event_idx for r in got] == [0, 1, 2, 3, 4]
        assert all(r.panels.tobytes() == frames[r.event_idx].tobytes() for r in got)
        assert rep.commit_offset() is True  # J: what the cursor delivered
        assert queue.log.committed("audit") == 4
        rep.disconnect()
        again = client()
        assert again.replay_open("resume", group="audit")["start"] == 5
        rest = again.get_batch(8, timeout=1.0)
        assert [getattr(r, "event_idx", "EOS") for r in rest] == [5, 6, 7, "EOS"]
        assert prod.commit_offset(6, group="ops") is True  # J for a named group
        assert queue.log.committed("ops") == 6
        # the live queue is undisturbed by the replays
        assert [getattr(r, "event_idx", "EOS") for r in live.get_batch(8, timeout=1.0)] == [
            3, 4, 5, 6, 7, "EOS"]
        for c in (prod, live, again):
            c.disconnect()
    finally:
        srv.close_all()
        srv.shutdown()


def _fleet(pkg, tmp_path):
    """A ``--workers 2 --durable_dir`` fleet of ``pkg``'s queue server
    program; returns the process and its port."""
    port_file = str(tmp_path / f"{pkg}.port")
    extra = ["--stall_poll_s", "0"] if pkg == "psana_ray_tpu" else []
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.queue_server", "--workers", "2", "--host", "127.0.0.1",
         "--port", "0", "--port_file", port_file, "--durable_dir", str(tmp_path / pkg),
         "--segment_bytes", str(1 << 20), "--drain_s", "1", *extra],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        env={**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"})
    deadline = time.monotonic() + 60
    while not os.path.exists(port_file):
        assert proc.poll() is None and time.monotonic() < deadline
        time.sleep(0.05)
    time.sleep(0.3)  # the JAX parent writes its port file before its workers bind
    with open(port_file) as f:
        return proc, int(f.read())


@pytest.mark.skipif(not hasattr(socket, "SO_REUSEPORT"), reason="needs SO_REUSEPORT")
@pytest.mark.parametrize("case", ["jax_fleet-port_client", "port_fleet-jax_client"])
def test_clients_of_either_package_reach_the_other_fleets_queues(tmp_path, case):
    """Several connections (the kernel hands each to either worker) on a
    queue each worker owns and on the default queue: every frame arrives
    once, in order, whichever worker took the connection, and a replay
    ('R') migrates with its connection."""
    from psana_ray_tpu_torch.transport.workers import queue_owner

    fleet_pkg, cli_mod, rec = (("psana_ray_tpu", port_tcp, FrameRecord)
                               if case.startswith("jax") else
                               ("psana_ray_tpu_torch", jax_tcp, JaxRecord))
    assert [queue_owner("ns", q, 2) for q in ("q0", "q3")] == [0, 1]
    proc, port = _fleet(fleet_pkg, tmp_path)
    try:
        for ns, name in (("ns", "q0"), ("ns", "q3"), (None, None)):
            prods = [cli_mod.TcpQueueClient("127.0.0.1", port, timeout_s=10.0, namespace=ns,
                                            queue_name=name, reconnect_tries=6)
                     for _ in range(4)]
            frames = _frames(8, np.float32, seed=5)
            for i, f in enumerate(frames):
                assert prods[i % 4].put(rec(0, i, f, 1.0))
            cons = cli_mod.TcpQueueClient("127.0.0.1", port, timeout_s=10.0, namespace=ns,
                                          queue_name=name, reconnect_tries=6)
            got = cons.get_batch(16, timeout=2.0)
            assert [r.event_idx for r in got] == list(range(8)), name
            assert all(r.panels.tobytes() == frames[r.event_idx].tobytes() for r in got)
            if name is not None:
                rep = cli_mod.TcpQueueClient("127.0.0.1", port, timeout_s=10.0, namespace=ns,
                                             queue_name=name, reconnect_tries=6)
                assert rep.replay_open("begin", group="g")["start"] == 0
                assert [r.event_idx for r in rep.get_batch(16, timeout=2.0)] == list(range(8))
                rep.disconnect()
            for c in (*prods, cons):
                c.disconnect()
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
    assert proc.returncode == 0
