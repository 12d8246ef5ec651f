"""The sharded queue cluster across the two packages, over the wire.

Placement is the same function in both (``tests/test_torch_queue_cluster.py``
holds that), so one cluster may mix queue servers of both packages and
clients of both may share it:

- the port's client over JAX servers, and the JAX client over port
  servers;
- a mixed cluster of one JAX and one port server, with the coordinator
  (the first address) on each in turn;
- a consumer group of one JAX and one port member on the same
  assignment (both joined before the frames come), each ending on one
  EOS, fed by either package's producer;
- keyed puts (``partition_key``) filling the same partitions from either
  package's producer;
- a group coordinated by a ``--workers 2`` server of each package. The
  JAX fleet answers the group RPC on whichever worker accepted the
  connection, so its registry splits across workers (``ROADMAP.md``
  Queue 3); the port's fleet sends it to the default queue's worker, so
  one registry sees every member.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from psana_ray_tpu.cluster.client import ClusterClient as JaxCluster  # noqa: E402
from psana_ray_tpu.records import EndOfStream as JaxEos  # noqa: E402
from psana_ray_tpu.records import FrameRecord as JaxRecord  # noqa: E402
from psana_ray_tpu.transport import tcp as jax_tcp  # noqa: E402
from psana_ray_tpu.transport.ring import RingBuffer as JaxRing  # noqa: E402
from psana_ray_tpu_torch.cluster import ClusterClient, PartitionMap  # noqa: E402
from psana_ray_tpu_torch.cluster.hashring import partition_queue_name  # noqa: E402
from psana_ray_tpu_torch.records import EndOfStream, FrameRecord  # noqa: E402
from psana_ray_tpu_torch.transport import tcp as port_tcp  # noqa: E402
from psana_ray_tpu_torch.transport.ring import RingBuffer  # noqa: E402
from test_torch_queue_cluster import _join  # noqa: E402
from torch_parity import _no_lingering_child  # noqa: E402,F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {
    "jax": (jax_tcp.TcpQueueServer, JaxRing, JaxCluster, JaxRecord, JaxEos),
    "port": (port_tcp.TcpQueueServer, RingBuffer, ClusterClient, FrameRecord, EndOfStream),
}


def _server(pkg, maxsize=64):
    server_cls, ring = PKG[pkg][:2]
    return server_cls(ring(maxsize), host="127.0.0.1", maxsize=maxsize).serve_background()


def _frames(n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 6, 8)).astype(np.float32) for _ in range(n)]


def _produce(pkg, addrs, frames, P=4, queue_name="shared_queue"):
    client_cls, rec, eos = PKG[pkg][2:]
    prod = client_cls(addrs, queue_name=queue_name, n_partitions=P, maxsize=64)
    for i, f in enumerate(frames):
        assert prod.put_pipelined(rec(0, i, f, 1.0), deadline=time.monotonic() + 10)
    assert prod.put_wait(eos(0, len(frames), 1, 1), timeout=10)
    prod.disconnect()


def _drain(members, budget_s=30.0):
    """Each member until its EOS: (records, EOS count) a member."""
    got = [[] for _ in members]
    eos = [0] * len(members)
    deadline = time.monotonic() + budget_s
    while not all(eos) and time.monotonic() < deadline:
        for k, m in enumerate(members):
            for it in m.get_batch_stream(8, timeout=0.2):
                if type(it).__name__ == "EndOfStream":
                    eos[k] += 1
                else:
                    got[k].append(it)
    return got, eos


@pytest.mark.parametrize("servers,producer,members", [
    (("jax", "jax"), "port", ("port", "port")),  # the port's client over JAX servers
    (("port", "port"), "jax", ("jax", "jax")),  # the JAX client over port servers
    (("jax", "port"), "port", ("jax", "port")),  # mixed, the JAX server coordinates
    (("port", "jax"), "jax", ("port", "jax")),  # mixed, the port's server coordinates
], ids=["port_client-jax_servers", "jax_client-port_servers", "mixed-jax_coordinator",
        "mixed-port_coordinator"])
def test_one_group_across_packages(servers, producer, members):
    """Every frame arrives once and intact over the members, who hold
    disjoint partitions of one assignment and end on one EOS each; the
    coordinator is the first server, whichever package it is."""
    srvs = [_server(pkg) for pkg in servers]
    addrs = [f"127.0.0.1:{s.port}" for s in srvs]
    clients = []
    try:
        frames = _frames(40)
        clients = [PKG[pkg][2](addrs, n_partitions=4, maxsize=64, group="mixed",
                               member_id=f"m{k}-{pkg}", heartbeat_s=0.2)
                   for k, pkg in enumerate(members)]
        _join(clients)
        _produce(producer, addrs, frames)
        got, eos = _drain(clients)
        assert eos == [1, 1]
        idx = [[r.event_idx for r in g] for g in got]
        assert sorted(idx[0] + idx[1]) == list(range(40)) and idx[0] and idx[1]
        assert all(r.panels.tobytes() == frames[r.event_idx].tobytes() for g in got for r in g)
        parts = [set(c._session.assigned()) for c in clients]
        assert not parts[0] & parts[1] and parts[0] | parts[1] == {0, 1, 2, 3}
        info = srvs[0].groups.handle({"op": "info", "group": "mixed"})
        assert info["drained"] == [0, 1, 2, 3] and len(info["members"]) == 2
        assert srvs[1].groups.handle({"op": "info", "group": "mixed"}).get("unknown_group")
    finally:
        for c in clients:
            c.disconnect()
        for s in srvs:
            s.shutdown()


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_keyed_puts_land_where_the_jax_clients_do(server_pkg):
    """``partition_key``: each package's producer puts the same frames by
    the same key into a queue of its own; every partition then holds the
    same events in both, those whose key is the partition modulo 4."""
    srvs = [_server(server_pkg) for _ in range(2)]
    addrs = [f"127.0.0.1:{s.port}" for s in srvs]

    def key(item):
        return item.event_idx * 7 + 3

    try:
        for pkg in ("port", "jax"):
            client_cls, rec = PKG[pkg][2:4]
            prod = client_cls(addrs, queue_name=f"keyed_{pkg}", n_partitions=4, maxsize=64,
                              partition_key=key)
            for i in range(24):
                assert prod.put(rec(0, i, np.full((1, 2, 2), i, np.float32), 1.0))
            prod.disconnect()
        for p in range(4):
            held = {}
            for pkg in ("port", "jax"):
                m = PartitionMap.compute(addrs, f"keyed_{pkg}", 4)
                host, _, port = m.assignments[p].rpartition(":")
                c = port_tcp.TcpQueueClient(host, int(port),
                                            queue_name=partition_queue_name(f"keyed_{pkg}", p))
                held[pkg] = sorted(r.event_idx for r in c.get_batch(64, timeout=0.5))
                c.disconnect()
            assert held["port"] == held["jax"] == [i for i in range(24) if (7 * i + 3) % 4 == p]
    finally:
        for s in srvs:
            s.shutdown()


@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "jax"), ("jax", "port")])
def test_failover_across_packages(client_pkg, server_pkg):
    """A server of the other package killed mid-stream: its partitions move
    to the survivors and the retained frames are resent there; every frame
    arrives (these servers do not replicate, so both packages' answer the
    'Y' promote with '0')."""
    srvs = [_server(server_pkg) for _ in range(3)]
    addrs = [f"127.0.0.1:{s.port}" for s in srvs]
    client_cls, rec, eos_cls = PKG[client_pkg][2:]
    prod = cons = None
    try:
        prod = client_cls(addrs, n_partitions=4, maxsize=64, retain=256, reconnect_tries=1,
                          reconnect_base_s=0.05)
        cons = client_cls(addrs, n_partitions=4, maxsize=64, reconnect_tries=1,
                          reconnect_base_s=0.05)
        pmap = prod.partition_map
        victim = max(addrs, key=lambda a: len(pmap.partitions_on(a)))
        frames = _frames(30, seed=4)
        seen = set()
        for i, f in enumerate(frames):
            assert prod.put_pipelined(rec(0, i, f, 1.0), deadline=time.monotonic() + 10)
            if i == 10:
                seen.update(r.event_idx for r in cons.get_batch_stream(8, timeout=0.5)
                            if type(r).__name__ != "EndOfStream")
                srvs[addrs.index(victim)].shutdown()
        assert prod.flush_puts(time.monotonic() + 30)
        assert prod.put_wait(eos_cls(0, 30, 1, 1), timeout=20)
        got, eos = _drain([cons])
        assert eos == [1] and seen | {r.event_idx for r in got[0]} == set(range(30))
        assert prod.partition_map.version >= 2
    finally:
        for c in (prod, cons):
            if c:
                c.disconnect()
        for s in srvs:
            s.shutdown()


def _fleet(pkg, tmp_path):
    """A ``--workers 2 --durable_dir`` fleet of ``pkg``'s queue server:
    the process and its port."""
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


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)
    return proc.returncode


JOINS = 24  # connections to the fleet, each its own member: a split shows with odds 1 - 2**-23


@pytest.mark.skipif(not hasattr(socket, "SO_REUSEPORT"), reason="needs SO_REUSEPORT")
@pytest.mark.parametrize("pkg", ["psana_ray_tpu", "psana_ray_tpu_torch"])
def test_group_on_a_two_worker_coordinator(tmp_path, pkg):
    """Each of ``JOINS`` connections joins one member. The JAX fleet
    answers on the worker the kernel gave the connection, so some answer
    misses members another worker enrolled (its registry splits, a fault
    of the reference); the port's every answer lists every member before
    it, and only worker 0's store holds the group."""
    proc, port = _fleet(pkg, tmp_path)
    mod = jax_tcp if pkg == "psana_ray_tpu" else port_tcp
    try:
        seen = []
        for i in range(JOINS):
            c = mod.TcpQueueClient("127.0.0.1", port, timeout_s=10.0, reconnect_tries=6)
            seen.append(c.cluster_rpc({"op": "join", "group": "fleet", "member": f"m{i:02d}",
                                       "n_partitions": 4})["members"])
            c.disconnect()
        one_registry = all(members == [f"m{j:02d}" for j in range(i + 1)]
                           for i, members in enumerate(seen))
        if pkg == "psana_ray_tpu":
            assert not one_registry, "the JAX fleet kept one registry"
        else:
            assert one_registry, seen
    finally:
        assert _stop(proc) == 0
    if pkg == "psana_ray_tpu_torch":
        with open(tmp_path / pkg / "groups-w0.json") as f:
            assert "fleet" in json.load(f)["groups"]
        w1 = tmp_path / pkg / "groups-w1.json"
        assert not w1.exists() or "fleet" not in json.loads(w1.read_text())["groups"]


@pytest.mark.skipif(not hasattr(socket, "SO_REUSEPORT"), reason="needs SO_REUSEPORT")
def test_port_group_members_share_a_fleet_coordinator(tmp_path):
    """Two members of the port, and their producer, over a cluster whose
    coordinator is a port ``--workers 2`` fleet: one assignment, one EOS
    each, every frame once."""
    proc, port = _fleet("psana_ray_tpu_torch", tmp_path)
    other = _server("port")
    addrs = [f"127.0.0.1:{port}", f"127.0.0.1:{other.port}"]
    clients = []
    try:
        frames = _frames(24, seed=6)
        _produce("port", addrs, frames, queue_name="fleetq")
        clients = [ClusterClient(addrs, queue_name="fleetq", n_partitions=4, maxsize=64,
                                 group="fg", member_id=f"m{k}", heartbeat_s=0.2)
                   for k in range(2)]
        got, eos = _drain(clients)
        assert eos == [1, 1]
        idx = sorted(r.event_idx for g in got for r in g)
        assert idx == list(range(24))
        assert sorted(clients[0].assigned() + clients[1].assigned()) == [0, 1, 2, 3]
    finally:
        for c in clients:
            c.disconnect()
        other.shutdown()
        assert _stop(proc) == 0
