"""Chain replication across packages: the port held against the JAX
package.

- A mixed chain, both ways: a JAX owner ships to a port follower and a
  port owner to a JAX follower; the owner dies with its disk, and the
  survivor promotes, serving the backlog and the replay range.
- A replica log written by either package's ``ReplicaSet`` mounts as the
  other's durable queue, its floor and its records intact.
- ``lease`` and ``sync`` between the two packages' servers: a
  coordinator's group state reaches the other package's registry, a
  second holder is fenced while the lease lives, and a stale-generation
  snapshot is absorbed by neither.
- 'H', 'V' and 'Y' on a replicating server are answered byte for byte as
  the JAX server answers them.
"""

import os
import shutil
import socket
import struct
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from psana_ray_tpu.cluster import replication as jax_repl  # noqa: E402
from psana_ray_tpu.records import FrameRecord as JaxRecord  # noqa: E402
from psana_ray_tpu.storage import DurableRingBuffer as JaxDurable  # noqa: E402
from psana_ray_tpu.storage import SegmentLog as JaxLog  # noqa: E402
from psana_ray_tpu.transport import tcp as jax_tcp  # noqa: E402
from psana_ray_tpu.transport.codec import encode_payload as jax_encode  # noqa: E402
from psana_ray_tpu_torch.cluster import replication as port_repl  # noqa: E402
from psana_ray_tpu_torch.cluster.hashring import partition_owner  # noqa: E402
from psana_ray_tpu_torch.records import FrameRecord  # noqa: E402
from psana_ray_tpu_torch.storage import DurableRingBuffer, SegmentLog  # noqa: E402
from psana_ray_tpu_torch.transport import tcp as port_tcp  # noqa: E402
from torch_parity import _no_lingering_child  # noqa: E402,F401 (autouse)

PKG = {
    "jax": (jax_tcp, jax_repl, JaxLog, JaxDurable, JaxRecord),
    "port": (port_tcp, port_repl, SegmentLog, DurableRingBuffer, FrameRecord),
}
NO_FLOOR = (1 << 64) - 1


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _factory(pkg, root):
    _, _, Log, Durable, _ = PKG[pkg]

    def factory(ns, name, maxsize):
        log = Log(os.path.join(root, f"{ns}__{name}"), segment_bytes=1 << 20, fsync="none")
        return Durable(log, maxsize=maxsize, name=f"{ns}__{name}")

    return factory


def _server(pkg, root, peers, advertise, port, group_store=False, **kw):
    tcp, repl = PKG[pkg][:2]
    os.makedirs(root, exist_ok=True)
    return tcp.TcpQueueServer(
        host="127.0.0.1", port=port, maxsize=256, queue_factory=_factory(pkg, root),
        replication=repl.ReplicationManager(root, peers, advertise, **kw),
        group_store_path=os.path.join(root, "groups.json") if group_store else None,
    ).serve_background()


def _owned_by(peers, owner, prefix="mx"):
    return next(f"{prefix}_{i}" for i in range(512)
                if partition_owner(peers, f"{prefix}_{i}", 0) == owner)


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4096, (2, 8, 8), dtype=np.uint16) for _ in range(n)]


def _shutdown(servers):
    for s in servers:
        try:
            s.shutdown()
        except Exception:
            pass


@pytest.mark.parametrize("owner_pkg,follower_pkg", [("jax", "port"), ("port", "jax")])
def test_a_mixed_chain_survives_the_owners_death_and_disk(tmp_path, owner_pkg, follower_pkg):
    dirs = [str(tmp_path / "owner"), str(tmp_path / "follower")]
    ports = [_free_port(), _free_port()]
    peers = [f"127.0.0.1:{p}" for p in ports]
    servers = [_server(owner_pkg, dirs[0], peers, peers[0], ports[0]),
               _server(follower_pkg, dirs[1], peers, peers[1], ports[1])]
    try:
        qname = _owned_by(peers, peers[0])
        otcp, orec = PKG[owner_pkg][0], PKG[owner_pkg][4]
        frames = _frames(20, seed=3)
        c = otcp.TcpQueueClient("127.0.0.1", ports[0], namespace="ns", queue_name=qname)
        for i, f in enumerate(frames):
            assert c.put_pipelined(orec(0, i, f, 1.0), deadline=time.monotonic() + 30)
        assert c.flush_puts(time.monotonic() + 30)  # the follower logged every frame
        got = c.get_batch(5, timeout=5.0)
        assert [r.event_idx for r in got] == list(range(5))
        c.size()  # the implicit ack: the owner's floor is 4
        time.sleep(0.3)
        c.disconnect()
        servers[0].shutdown()
        shutil.rmtree(dirs[0])
        ftcp, frec = PKG[follower_pkg][0], PKG[follower_pkg][4]
        c2 = ftcp.TcpQueueClient("127.0.0.1", ports[1])
        assert c2.promote("ns", qname) == {"start": 0, "end": 20}
        c2.open("ns", qname, 256)
        rest = []
        while True:
            batch = c2.get_batch(64, timeout=1.0)
            if not batch:
                break
            rest.extend(batch)
        idx = sorted({r.event_idx for r in rest})
        # nothing lost; a port owner's floor reached the follower while idle
        assert set(range(5, 20)) <= set(idx)
        if owner_pkg == "port":
            assert idx == list(range(5, 20))
        for r in rest:
            assert isinstance(r, frec)
            assert r.panels.tobytes() == frames[r.event_idx].tobytes()
        c2.disconnect()
        c3 = ftcp.TcpQueueClient("127.0.0.1", ports[1], namespace="ns", queue_name=qname)
        rng = c3.replay_open(from_offset="begin", group="audit")
        assert (rng["start"], rng["end"]) == (0, 20)
        replayed = []
        while True:
            batch = c3.get_batch(64, timeout=1.0)
            if not batch:
                break
            replayed.extend(batch)
        assert [r.event_idx for r in replayed] == list(range(20))
        c3.disconnect()
    finally:
        _shutdown(servers)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_replica_log_mounts_in_the_other_package(tmp_path, writer, reader):
    wrepl, wrec = PKG[writer][1], PKG[writer][4]
    frames = _frames(40, seed=5)
    rs = wrepl.ReplicaSet(str(tmp_path), segment_bytes=1 << 12, fsync="none")
    entry = rs.subscribe_log("ns", "q")
    for i, f in enumerate(frames):
        floor = i - 3 if i >= 3 else NO_FLOOR
        assert rs.ingest(entry, i, floor, wrec(0, i, f, 1.0))
    assert rs.ingest(entry, 38, 30, wrec(0, 38, frames[38], 1.0))  # an overlap truncates
    assert rs.promote("ns", "q") == (0, 39)
    _, _, Log, Durable, rrec = PKG[reader]
    log = Log(str(tmp_path / "ns__q"), fsync="none")
    assert log.next_offset == 39 and not log.torn_tail_repaired
    assert log.committed("") == 36  # the exact latest floor (the overlap's was lower)
    q = Durable(log, maxsize=64)
    got = q.get_batch(64, timeout=0.0)
    got = [r.materialize() if hasattr(r, "materialize") else r for r in got]
    assert [r.event_idx for r in got] == [37, 38]
    for r in got:
        assert isinstance(r, rrec)
        assert r.panels.tobytes() == frames[r.event_idx].tobytes()
    q.close()
    log.close()


@pytest.mark.parametrize("coord_pkg,peer_pkg", [("jax", "port"), ("port", "jax")])
def test_lease_and_sync_across_packages(tmp_path, coord_pkg, peer_pkg):
    dirs = [str(tmp_path / "coord"), str(tmp_path / "peer")]
    ports = [_free_port(), _free_port()]
    peers = [f"127.0.0.1:{p}" for p in ports]
    servers = [_server(coord_pkg, dirs[0], peers, peers[0], ports[0], group_store=True),
               _server(peer_pkg, dirs[1], peers, peers[1], ports[1], group_store=True)]
    try:
        ctcp, ptcp = PKG[coord_pkg][0], PKG[peer_pkg][0]
        c = ctcp.TcpQueueClient("127.0.0.1", ports[0])
        j = c.cluster_rpc({"op": "join", "group": "g", "member": "m1", "n_partitions": 4})
        j = c.cluster_rpc({"op": "drained", "group": "g", "member": "m1",
                           "generation": j["generation"], "partition": 2, "offset": 17})
        assert j["ok"]
        p = ptcp.TcpQueueClient("127.0.0.1", ports[1])
        deadline = time.monotonic() + 10
        info = {}
        while time.monotonic() < deadline:
            info = p.cluster_rpc({"op": "info", "group": "g"})
            if info.get("ok") and info.get("drained") == [2]:
                break
            time.sleep(0.05)
        assert info["generation"] == j["generation"] and info["offsets"] == {"2": 17}
        assert info["members"] == []  # leases are liveness, never synced
        # a zombie coordinator is fenced while the lease lives
        z = p.cluster_rpc({"op": "sync", "holder": "127.0.0.1:1", "groups": {}})
        assert z["ok"] is False and z["fenced"] and z["holder"] == peers[0]
        # the holder's stale snapshot lowers nothing
        stale = {"g": {"generation": j["generation"] - 1, "n_partitions": 4, "drained": [],
                       "offsets": {}}}
        assert p.cluster_rpc({"op": "sync", "holder": peers[0], "groups": stale})["absorbed"] == 0
        assert p.cluster_rpc({"op": "drained", "group": "g", "member": "m1",
                              "generation": j["generation"] - 1, "partition": 0})["fenced"]
        c.disconnect()
        p.disconnect()
    finally:
        _shutdown(servers)
    for d in dirs:  # both stores hold the group; either package reads either
        with open(os.path.join(d, "groups.json")) as f:
            assert '"g"' in f.read()


@pytest.mark.parametrize("codec", [None, "shuffle-rle"])
def test_a_replica_link_keeps_its_mode_as_the_jax_link_does(tmp_path, codec):
    """Both packages' ``ReplicaLink`` against one port follower: the link
    negotiates ('Z', when it has a codec) before it subscribes ('H') and
    never after, subscribes once however often it is asked, and keeps the
    subscription as its replica-mode state (``_stream``) exactly as the JAX
    link does; a second 'H' or a 'Z' on the subscribed connection would be
    refused there, and the appends after it would fail."""
    root = str(tmp_path / "f")
    port = _free_port()
    peers = [f"127.0.0.1:{port}", "127.0.0.1:1"]
    srv = _server("port", root, peers, peers[0], port)
    payload = FrameRecord(0, 0, _frames(1)[0], 1.0)
    try:
        tails = {}
        for pkg, name in (("jax", "q_jax"), ("port", "q_port")):
            repl = PKG[pkg][1]
            link = repl.ReplicaLink("127.0.0.1", port, "ns", name, codec=codec)
            assert link._stream is None
            assert link.subscribe() == link.subscribe() == 0
            assert type(link._stream).__name__ == "_ReplicaSub"
            for off in range(3):
                link.ship(off, NO_FLOOR, payload if pkg == "port" else JaxRecord(
                    0, 0, payload.panels, 1.0))
                assert link.read_ack(5.0) == off
            assert link.subscribe() == 0
            tails[pkg] = link._stream.tail
            link.hang_up()
        assert tails["port"] == tails["jax"] == 0
    finally:
        srv.shutdown()


def _replica_exchange(port: int, payload: bytes) -> list:
    """'H', two 'V' (the second a repeat of offset 0: an overlap), BYE; then
    'Y' twice and 'H' again on a second connection: the raw answers."""
    def named(op):
        return op + struct.pack("<H", 2) + b"ns" + struct.pack("<H", 1) + b"q"

    def read(s, n):
        out = b""
        while len(out) < n:
            chunk = s.recv(n - len(out))
            if not chunk:
                return out
            out += chunk
        return out

    answers = []
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(named(b"H"))
        answers.append(read(s, 9))
        for off, floor in ((0, NO_FLOOR), (1, 0), (0, 0)):
            s.sendall(b"V" + struct.pack("<QQI", off, floor, len(payload)) + payload)
            answers.append(read(s, 9))
        s.sendall(b"F")
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(named(b"Y"))
        answers.append(read(s, 17))
        s.sendall(named(b"Y"))
        answers.append(read(s, 1))
        s.sendall(named(b"H"))
        answers.append(read(s, 1))
    return answers


def test_replica_opcodes_answer_as_the_jax_server(tmp_path):
    payload = jax_encode(JaxRecord(0, 7, _frames(1)[0], 1.0))
    answers = {}
    for pkg in ("jax", "port"):
        root = str(tmp_path / pkg)
        port = _free_port()
        peers = [f"127.0.0.1:{port}", "127.0.0.1:1"]
        srv = _server(pkg, root, peers, peers[0], port)
        try:
            answers[pkg] = _replica_exchange(port, payload)
        finally:
            srv.shutdown()
    assert answers["port"] == answers["jax"], answers
    h, v0, v1, v0again, y, y2, h2 = answers["port"]
    assert h == b"1" + struct.pack("<Q", 0)
    assert (v0, v1, v0again) == tuple(b"1" + struct.pack("<Q", o) for o in (0, 1, 0))
    assert y == b"1" + struct.pack("<QQ", 0, 1)  # the overlap left one record
    assert y2 == b"0" and h2 == b"0"  # promoted: fenced
