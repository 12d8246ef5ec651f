"""The port's sharded queue cluster: the cases of ``tests/test_cluster.py``
(and the coordinator and migration cases of ``tests/test_durable_server.py``)
on ``psana_ray_tpu_torch.cluster``, with the placement, the group
assignment and the coordinator held to the JAX package's answers.

- Placement and assignment equal the JAX package's for a few hundred
  seeded inputs, in this process and in a child process of the port.
- ``GroupRegistry``: the same request sequences give the JAX package's
  answers (generation, members, fenced, drained, offsets), lease expiry
  and the drain epoch included; a store written by either package is
  recovered by the other, and both write the same bytes; ``lease`` and
  ``sync`` answer as the JAX registry's (a second holder fenced, a stale
  snapshot absorbed never).
- ``ClusterClient`` over two or three port servers: the round trip
  spreads, EOS waits for every partition and producer, ``DataReader`` and
  ``batches_from_queue`` read a cluster, consumer groups (disjoint
  partitions, one EOS a member, a join, a death, fenced commits retried,
  a stale member fenced), a server killed mid-stream (no loss, the exact
  unacked tail resent, EOS through retention), every server dead,
  ``add_server`` draining log-backed partitions, the registry recovered
  from its store across a restart, ``DataReader`` replaying a durable
  cluster, and a ``spawn`` producer process feeding one.

Session timeouts and reconnect envelopes are test-sized (0.05-0.8 s).
"""

import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from psana_ray_tpu_torch.cluster import CLUSTER, ClusterClient, GroupRegistry  # noqa: E402
from psana_ray_tpu_torch.cluster import GroupSession, parse_cluster_address  # noqa: E402
from psana_ray_tpu_torch.cluster.hashring import (  # noqa: E402
    PartitionMap,
    assign_group_partitions,
    partition_queue_name,
)
from psana_ray_tpu_torch.config import TransportConfig  # noqa: E402
from psana_ray_tpu_torch.records import EndOfStream, FrameRecord, is_eos  # noqa: E402
from psana_ray_tpu_torch.storage import DurableRingBuffer, SegmentLog  # noqa: E402
from psana_ray_tpu_torch.transport import TransportClosed  # noqa: E402
from psana_ray_tpu_torch.transport.ring import RingBuffer  # noqa: E402
from psana_ray_tpu_torch.transport.tcp import TcpQueueClient, TcpQueueServer  # noqa: E402
from torch_parity import _no_lingering_child  # noqa: E402,F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frame(i, rank=0):
    return FrameRecord(rank, i, np.full((1, 4, 4), float(i), np.float32), 1.0)


def _servers(n, maxsize=64):
    servers = [TcpQueueServer(RingBuffer(maxsize), host="127.0.0.1", maxsize=maxsize)
               .serve_background() for _ in range(n)]
    return servers, [f"127.0.0.1:{s.port}" for s in servers]


def _shutdown(servers):
    for s in servers:
        try:
            s.shutdown()
        except Exception:
            pass


def _drain_until_eos(cons, budget_s=30.0, batch=16):
    """Drain until the one synthesized EOS: (event indices, EOS count)."""
    got, eos = [], 0
    deadline = time.monotonic() + budget_s
    while not eos and time.monotonic() < deadline:
        for item in cons.get_batch_stream(batch, timeout=0.5):
            if is_eos(item):
                eos += 1
            else:
                got.append(item.event_idx)
    return got, eos


def _drain_members(members, seen, budget_s=30.0):
    """Drain every member until each has its EOS: the EOS counts."""
    eos = [0] * len(members)
    deadline = time.monotonic() + budget_s
    while not all(eos) and time.monotonic() < deadline:
        for k, m in enumerate(members):
            for it in m.get_batch_stream(8, timeout=0.2):
                if is_eos(it):
                    eos[k] += 1
                else:
                    seen[k].append(it.event_idx)
    return eos


def _join(members, budget_s=10.0):
    """Join every member (a read joins) and read on until each has applied
    the generation that holds them all, so the frames produced after go
    out on that assignment (a member keeps what its streams were pushed
    before a rebalance revoked them)."""
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        for m in members:
            assert not m.get_batch_stream(8, timeout=0.05)
        sessions = [m._session for m in members]
        if (len({s.generation for s in sessions}) == 1
                and all(len(s.members) == len(members) for s in sessions)
                and all(m._applied_gen == s.generation for m, s in zip(members, sessions))):
            return
    raise AssertionError("the members never settled on one generation")


def _balanced_queue_name(addrs, P=8, per_server_cap=3):
    for i in range(512):
        name = f"scaling_q{i}"
        m = PartitionMap.compute(addrs, name, P)
        if max(len(m.partitions_on(a)) for a in addrs) <= per_server_cap:
            return name
    raise AssertionError("no balanced map found")


def _placement_inputs(n=300, seed=0):
    """Seeded (servers, queue, partitions, members) tuples: hosts spelled
    as deployments spell them (names, dotted quads, localhost)."""
    rng = random.Random(seed)
    hosts = ["127.0.0.1", "localhost", "10.0.0.7", "ingest-a", "psana-node-12.slac"]
    out = []
    for _ in range(n):
        servers = list(dict.fromkeys(f"{rng.choice(hosts)}:{rng.randrange(1024, 65536)}"
                                     for _ in range(rng.randint(1, 6))))
        queue = rng.choice(["shared_queue", "epix10k2M", f"q{rng.randrange(10**6)}", "ns/q#x"])
        members = [f"member-{rng.randrange(10**9):09d}" for _ in range(rng.randint(1, 5))]
        out.append((servers, queue, rng.randint(1, 32), members))
    return out


def _maps(mod, inputs):
    return [[mod.PartitionMap.compute(s, q, p).assignments, [
        list(mod.assign_group_partitions(m, x, p)) for x in m]] for s, q, p, m in inputs]


# -- placement and assignment against the JAX package --------------------------
def test_placement_and_assignment_equal_the_jax_answers():
    from psana_ray_tpu.cluster import hashring as jax_ring
    from psana_ray_tpu_torch.cluster import hashring as port_ring

    inputs = _placement_inputs()
    assert _maps(port_ring, inputs) == _maps(jax_ring, inputs)
    for servers, queue, p, _ in inputs[:50]:
        a, b = port_ring.PartitionMap.compute(servers, queue, p), jax_ring.PartitionMap.compute(
            servers, queue, p)
        assert (a.servers, a.version) == (b.servers, b.version)
        drop = servers[:-1] or servers
        assert a.recompute(drop).moved_from(a) == b.recompute(drop).moved_from(b)
        assert all(a.partitions_on(s) == b.partitions_on(s) for s in servers)
    assert port_ring.partition_queue_name("q", 3) == jax_ring.partition_queue_name("q", 3) \
        == "q#p3"


def test_placement_agrees_across_a_process_boundary():
    """A child process of the port (a fresh interpreter, its own hash
    seed) computes the JAX package's map here."""
    from psana_ray_tpu.cluster import hashring as jax_ring

    inputs = _placement_inputs(n=200, seed=1)
    code = ("import json, sys; from psana_ray_tpu_torch.cluster import hashring as r; "
            "inp = json.load(sys.stdin); "
            "print(json.dumps([[{str(k): v for k, v in r.PartitionMap.compute(s, q, p)"
            ".assignments.items()}, [list(r.assign_group_partitions(m, x, p)) for x in m]] "
            "for s, q, p, m in inp]))")
    out = subprocess.run([sys.executable, "-c", code], input=json.dumps(inputs),
                         capture_output=True, text=True, cwd=REPO, timeout=60,
                         env={**os.environ, "PYTHONPATH": REPO, "PYTHONHASHSEED": "7"})
    assert out.returncode == 0, out.stderr
    theirs = [[{str(k): v for k, v in a.items()}, g] for a, g in _maps(jax_ring, inputs)]
    assert json.loads(out.stdout) == theirs


class TestPartitionMap:
    ADDRS = [f"10.0.0.{i}:7000" for i in range(1, 9)]

    def test_deterministic_and_exhaustive(self):
        a = PartitionMap.compute(self.ADDRS[:4], "q", 32)
        assert a.assignments == PartitionMap.compute(self.ADDRS[:4], "q", 32).assignments
        assert sorted(a.assignments) == list(range(32))
        assert set(a.assignments.values()) <= set(self.ADDRS[:4])
        with pytest.raises(ValueError):
            PartitionMap.compute(self.ADDRS, "q", 0)

    def test_join_moves_at_most_its_expected_share(self):
        before = PartitionMap.compute(self.ADDRS[:4], "q", 64)
        after = before.recompute(self.ADDRS[:5])
        moved = after.moved_from(before)
        assert all(after.assignments[p] == self.ADDRS[4] for p in moved)
        assert len(moved) <= int(2.5 * 64 / 5), len(moved)
        assert after.version == before.version + 1

    def test_death_moves_only_the_dead_servers_partitions(self):
        before = PartitionMap.compute(self.ADDRS[:4], "q", 64)
        dead = self.ADDRS[1]
        after = before.recompute([a for a in self.ADDRS[:4] if a != dead])
        moved = set(after.moved_from(before))
        assert moved == set(before.partitions_on(dead))
        assert all(after.assignments[p] == before.assignments[p]
                   for p in range(64) if p not in moved)

    def test_group_assignment_disjoint_and_exhaustive(self):
        members = ["m-c", "m-a", "m-b"]
        parts = [p for m in members for p in assign_group_partitions(members, m, 8)]
        assert sorted(parts) == list(range(8))
        assert assign_group_partitions(list(reversed(members)), "m-b", 8) == \
            assign_group_partitions(members, "m-b", 8)
        assert assign_group_partitions(members, "not-a-member", 8) == ()


@pytest.mark.parametrize("address", ["cluster://a:1,b:2", "a:1, b:2 ,", "cluster://",
                                     "cluster://nohostport", "cluster://h:x", "cluster://:1"])
def test_parse_cluster_address(address):
    from psana_ray_tpu.cluster.client import parse_cluster_address as jax_parse

    try:
        want = jax_parse(address)
    except ValueError:
        with pytest.raises(ValueError):
            parse_cluster_address(address)
        return
    assert parse_cluster_address(address) == want


# -- the coordinator against the JAX package ------------------------------------
def _registries(**kw):
    from psana_ray_tpu.cluster.coordinator import GroupRegistry as JaxRegistry

    return JaxRegistry(**kw), GroupRegistry(**kw)


def _both(regs, req):
    answers = [r.handle(dict(req)) for r in regs]
    assert answers[0] == answers[1], (req, answers)
    return answers[1]


def test_registry_sequences_answer_as_the_jax_registry():
    regs = _registries(session_timeout_s=30.0)
    j1 = _both(regs, {"op": "join", "group": "g", "member": "m1", "n_partitions": 4})
    assert j1["ok"] and j1["members"] == ["m1"]
    j2 = _both(regs, {"op": "join", "group": "g", "member": "m2", "n_partitions": 4})
    assert j2["generation"] > j1["generation"]
    stale = {"group": "g", "member": "m1", "generation": j1["generation"]}
    assert _both(regs, {"op": "heartbeat", **stale})["fenced"]
    assert _both(regs, {"op": "drained", "partition": 0, **stale})["fenced"]
    cur = {"group": "g", "member": "m1", "generation": j2["generation"]}
    assert _both(regs, {"op": "heartbeat", **cur})["ok"]
    assert _both(regs, {"op": "drained", "partition": 0, "offset": 41, **cur})["drained"] == [0]
    assert _both(regs, {"op": "drained", "partition": 0, "offset": 7, **cur})["offsets"] == \
        {"0": 41}
    assert not _both(regs, {"op": "drained", "partition": 9, **cur}).get("fenced")
    assert not _both(regs, {"op": "join", "group": "g", "member": "m3", "n_partitions": 5})["ok"]
    _both(regs, {"op": "leave", "group": "g", "member": "m2"})
    _both(regs, {"op": "leave", "group": "g", "member": "nobody"})
    assert _both(regs, {"op": "info", "group": "g"})["members"] == ["m1"]
    assert _both(regs, {"op": "heartbeat", "group": "nope", "member": "m",
                        "generation": 0})["unknown_group"]
    for bad in ({"op": "join", "group": ""}, {"op": "join"}, {"op": "metrics"},
                {"op": "wat", "group": "g"}):
        assert not _both(regs, bad)["ok"]
    assert regs[0].stats() == regs[1].stats()
    assert regs[0].snapshot_groups() == regs[1].snapshot_groups()


def test_lease_expiry_bumps_the_generation_in_both_registries():
    regs = _registries(session_timeout_s=0.2)
    _both(regs, {"op": "join", "group": "g", "member": "m1", "n_partitions": 2})
    g0 = _both(regs, {"op": "join", "group": "g", "member": "m2",
                      "n_partitions": 2})["generation"]
    time.sleep(0.3)
    for r in regs:  # m1 alone stays alive
        r.handle({"op": "heartbeat", "group": "g", "member": "m1", "generation": g0})
    answers = [r.handle({"op": "info", "group": "g"}) for r in regs]
    assert answers[0] == answers[1]
    # m1's beat came after the lapse: the sweep before it expired both
    assert answers[1]["members"] == [] and answers[1]["generation"] > g0
    again = _both(regs, {"op": "join", "group": "g", "member": "m1", "n_partitions": 2})
    assert again["members"] == ["m1"]


def test_group_name_reuse_starts_a_new_drain_epoch_in_both():
    regs = _registries()
    gen = _both(regs, {"op": "join", "group": "g", "member": "a", "n_partitions": 2})["generation"]
    for p in (0, 1):
        gen = _both(regs, {"op": "drained", "group": "g", "member": "a", "generation": gen,
                           "partition": p})["generation"]
    _both(regs, {"op": "leave", "group": "g", "member": "a"})
    fresh = _both(regs, {"op": "join", "group": "g", "member": "b", "n_partitions": 2})
    assert fresh["drained"] == [] and fresh["generation"] > gen


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stores_are_recovered_across_packages(tmp_path, writer):
    """The same requests give both packages' stores the same bytes; a
    store of either package recovers in the other, mid-stream drain
    progress kept, a finished run a new epoch."""
    from psana_ray_tpu.cluster.coordinator import GroupRegistry as JaxRegistry

    kinds = {"jax": JaxRegistry, "port": GroupRegistry}
    paths = {k: str(tmp_path / f"{k}.json") for k in kinds}
    regs = [kinds[k](store_path=paths[k]) for k in ("jax", "port")]
    gen = _both(regs, {"op": "join", "group": "g", "member": "m1",
                       "n_partitions": 4})["generation"]
    _both(regs, {"op": "drained", "group": "g", "member": "m1", "generation": gen,
                 "partition": 2, "offset": 41})
    g2 = _both(regs, {"op": "join", "group": "done", "member": "m", "n_partitions": 1})
    _both(regs, {"op": "drained", "group": "done", "member": "m",
                 "generation": g2["generation"], "partition": 0})
    _both(regs, {"op": "leave", "group": "done", "member": "m"})
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    reader = kinds["port" if writer == "jax" else "jax"](store_path=paths[writer])
    info = reader.handle({"op": "info", "group": "g"})
    assert (info["n_partitions"], info["drained"], info["offsets"]) == (4, [2], {"2": 41})
    assert info["generation"] >= gen
    assert reader.handle({"op": "drained", "group": "g", "member": "m1", "generation": gen - 1,
                          "partition": 3})["fenced"]
    rejoin = reader.handle({"op": "join", "group": "g", "member": "m1", "n_partitions": 4})
    assert rejoin["drained"] == [2] and rejoin["offsets"] == {"2": 41}
    assert reader.handle({"op": "join", "group": "done", "member": "x",
                          "n_partitions": 1})["drained"] == []


def test_memory_only_registry_forgets_and_replication_ops_are_refused():
    """A registry without a store forgets; ``lease`` and ``sync`` without a
    holder, or from a second holder while the first's lease is live, are
    refused as the JAX registry refuses them, and an accepted ``sync``
    never lowers a group's generation nor fires ``on_mutate``."""
    reg = GroupRegistry()
    reg.handle({"op": "join", "group": "g", "member": "m", "n_partitions": 2})
    assert GroupRegistry().handle({"op": "info", "group": "g"}).get("unknown_group")
    regs = _registries()
    fired = []
    for r in regs:
        r.on_mutate = lambda: fired.append(1)
    for op in ("lease", "sync"):
        assert _both(regs, {"op": op, "groups": {}}) == {"ok": False, "error": "missing holder"}
    assert _both(regs, {"op": "lease", "holder": "a:1", "ttl": 30}) == {"ok": True,
                                                                      "holder": "a:1"}
    for op in ("lease", "sync"):
        answers = [r.handle({"op": op, "holder": "b:2", "groups": {}}) for r in regs]
        for a in answers:
            assert a["ok"] is False and a["fenced"] and a["holder"] == "a:1"
            assert 0 < a["expires_in_s"] <= 30
    snap = {"g": {"generation": 7, "n_partitions": 4, "drained": [1], "offsets": {"1": 9}}}
    assert _both(regs, {"op": "sync", "holder": "a:1", "groups": snap}) == {"ok": True,
                                                                          "absorbed": 1}
    stale = {"g": {"generation": 5, "n_partitions": 4, "drained": [], "offsets": {}}}
    assert _both(regs, {"op": "sync", "holder": "a:1", "groups": stale})["absorbed"] == 0
    info = _both(regs, {"op": "info", "group": "g"})
    assert (info["generation"], info["drained"], info["offsets"]) == (7, [1], {"1": 9})
    assert _both(regs, {"op": "drained", "group": "g", "member": "z", "generation": 6,
                        "partition": 0})["fenced"]
    assert not fired  # absorbed syncs are not relayed
    _both(regs, {"op": "join", "group": "g", "member": "m", "n_partitions": 4})
    assert len(fired) == 2  # a client's mutation is


def test_group_rpc_over_the_wire():
    servers, addrs = _servers(1)
    try:
        c = TcpQueueClient("127.0.0.1", servers[0].port)
        r = c.cluster_rpc({"op": "join", "group": "wire", "member": "m1", "n_partitions": 2})
        assert r["ok"] and r["members"] == ["m1"]
        assert c.cluster_rpc({"op": "heartbeat", "group": "wire", "member": "m1",
                              "generation": r["generation"]})["ok"]
        assert c.promote("default", "q#p0") is None  # no replica here: a plain failover
        c.stream_open(4)  # a streamed client's RPCs take the side channel
        assert c.cluster_rpc({"op": "info", "group": "wire"})["members"] == ["m1"]
        c.disconnect()
    finally:
        _shutdown(servers)


def test_session_rejoins_when_fenced():
    reg = GroupRegistry()
    s = GroupSession(reg.handle, "g", "m1", n_partitions=4, heartbeat_s=0.0)
    assert s.join_group() and s.assigned() == (0, 1, 2, 3)
    reg.handle({"op": "join", "group": "g", "member": "m2", "n_partitions": 4})
    assert not s.commit_drained(0)  # fenced, then rejoined
    assert s.assigned() == (0, 2) and s.commit_drained(0)
    assert not s.all_drained() and s.drained == frozenset({0})
    s.leave()
    assert reg.handle({"op": "info", "group": "g"})["members"] == ["m2"]


# -- the routing client -----------------------------------------------------------
class TestClusterClient:
    def test_put_get_round_trip_spreads_over_servers(self):
        servers, addrs = _servers(2)
        prod = cons = None
        try:
            qname = _balanced_queue_name(addrs, P=4, per_server_cap=3)
            prod = ClusterClient(addrs, queue_name=qname, n_partitions=4, maxsize=64)
            cons = ClusterClient(addrs, queue_name=qname, n_partitions=4, maxsize=64)
            for i in range(24):
                assert prod.put(_frame(i))
            depths = [s.depth() for s in servers]
            assert sum(depths) == 24 and all(d > 0 for d in depths), depths
            assert prod.put_wait(EndOfStream(0, -1, 1, 1), timeout=10)
            got, eos = _drain_until_eos(cons)
            assert sorted(got) == list(range(24)) and eos == 1
            assert cons.get_batch_stream(4, timeout=0.2) == []
            st = prod.stats()
            assert st["cluster"] and st["depth"] == 0 and st["n_partitions"] == 4
        finally:
            for c in (prod, cons):
                if c:
                    c.disconnect()
            _shutdown(servers)

    def test_eos_waits_for_every_partition_and_every_producer(self):
        servers, addrs = _servers(2)
        p0 = p1 = cons = None
        try:
            p0 = ClusterClient(addrs, n_partitions=4, maxsize=64)
            p1 = ClusterClient(addrs, n_partitions=4, maxsize=64)
            cons = ClusterClient(addrs, n_partitions=4, maxsize=64)
            for i in range(8):
                assert p0.put(_frame(i, rank=0))
            assert p0.put_wait(EndOfStream(producer_rank=0, shards_done=1, total_shards=2),
                               timeout=10)
            got, eos = [], 0
            deadline = time.monotonic() + 3.0
            while time.monotonic() < deadline and len(got) < 8:
                for item in cons.get_batch_stream(8, timeout=0.2):
                    if is_eos(item):
                        eos += 1
                    else:
                        got.append(item.event_idx)
            assert eos == 0 and sorted(got) == list(range(8))
            for i in range(8, 12):
                assert p1.put(_frame(i, rank=1))
            assert p1.put_wait(EndOfStream(producer_rank=1, shards_done=1, total_shards=2),
                               timeout=10)
            got2, eos = _drain_until_eos(cons)
            assert sorted(got2) == list(range(8, 12)) and eos == 1
        finally:
            for c in (p0, p1, cons):
                if c:
                    c.disconnect()
            _shutdown(servers)

    def test_data_reader_terminates_exactly_once(self):
        from psana_ray_tpu_torch.consumer import DataReader

        servers, addrs = _servers(2)
        prod = None
        try:
            cfg = TransportConfig(address="cluster://" + ",".join(addrs), cluster_partitions=4)
            prod = ClusterClient(addrs, n_partitions=4, maxsize=64)
            for i in range(10):
                assert prod.put(_frame(i))
            assert prod.put_wait(EndOfStream(0, -1, 1, 1), timeout=10)
            with DataReader(address=cfg.address, config=cfg, streaming=True) as reader:
                assert isinstance(reader.queue, ClusterClient)
                seen = [rec.event_idx for rec in reader.iter_records()]
            assert sorted(seen) == list(range(10))
        finally:
            if prod:
                prod.disconnect()
            _shutdown(servers)

    def test_batches_from_queue_over_cluster(self):
        """The batcher's pop order reaches ``get_batch_stream`` first: a
        cluster drains as merged push streams, padded tail, nothing lost."""
        from psana_ray_tpu_torch.infeed.batcher import batches_from_queue

        servers, addrs = _servers(2)
        prod = cons = None
        try:
            prod = ClusterClient(addrs, n_partitions=4, maxsize=64)
            cons = ClusterClient(addrs, n_partitions=4, maxsize=64)
            for i in range(22):
                assert prod.put(_frame(i))
            assert prod.put_wait(EndOfStream(0, -1, 1, 1), timeout=10)
            seen = []
            for batch in batches_from_queue(cons, batch_size=8, max_wait_s=30.0):
                seen.extend(int(batch.event_idx[j]) for j in range(batch.num_valid))
            assert sorted(seen) == list(range(22))
            assert cons._streaming and all(c._stream is not None
                                           for c in cons._clients.values())
        finally:
            for c in (prod, cons):
                if c:
                    c.disconnect()
            _shutdown(servers)

    def test_open_queue_builds_a_cluster_client(self):
        from psana_ray_tpu_torch.transport.addressing import open_queue

        cfg = TransportConfig(address="cluster://127.0.0.1:1,127.0.0.1:2", cluster_partitions=3,
                              group="g", member_id="m7", queue_size=9)
        cons = open_queue(cfg, role="consumer")
        prod = open_queue(cfg, role="producer")  # a producer never joins a group
        assert isinstance(cons, ClusterClient) and isinstance(prod, ClusterClient)
        assert cons.n_partitions == 3 and cons._maxsize == 9 and cons._session.member_id == "m7"
        assert prod._session is None
        assert cons.put_window == cons.stream_window == 32


# -- consumer groups ------------------------------------------------------------
class TestConsumerGroups:
    def test_two_members_disjoint_partitions_one_eos_each(self):
        servers, addrs = _servers(2)
        clients = []
        try:
            prod = ClusterClient(addrs, n_partitions=4, maxsize=64)
            m1 = ClusterClient(addrs, n_partitions=4, maxsize=64, group="g1", member_id="m1",
                               heartbeat_s=0.2)
            m2 = ClusterClient(addrs, n_partitions=4, maxsize=64, group="g1", member_id="m2",
                               heartbeat_s=0.2)
            clients = [prod, m1, m2]
            _join([m1, m2])
            for i in range(32):
                assert prod.put(_frame(i))
            assert prod.put_wait(EndOfStream(0, -1, 1, 1), timeout=10)
            seen = [[], []]
            assert _drain_members([m1, m2], seen) == [1, 1]
            assert sorted(seen[0] + seen[1]) == list(range(32))
            assert seen[0] and seen[1] and not set(seen[0]) & set(seen[1])
            assert sorted(m1.assigned() + m2.assigned()) == [0, 1, 2, 3]
        finally:
            for c in clients:
                c.disconnect()
            _shutdown(servers)

    def test_member_join_rebalances_and_loses_nothing(self):
        servers, addrs = _servers(2)
        clients = []
        try:
            prod = ClusterClient(addrs, n_partitions=4, maxsize=128)
            m1 = ClusterClient(addrs, n_partitions=4, maxsize=128, group="g2", member_id="m1",
                               heartbeat_s=0.1)
            clients = [prod, m1]
            for i in range(64):
                assert prod.put(_frame(i))
            assert prod.put_wait(EndOfStream(0, -1, 1, 1), timeout=10)
            seen = [[], []]
            deadline = time.monotonic() + 10.0
            while len(seen[0]) < 8 and time.monotonic() < deadline:
                seen[0].extend(it.event_idx for it in m1.get_batch_stream(4, timeout=0.3)
                               if not is_eos(it))
            gen = m1._session.generation
            m2 = ClusterClient(addrs, n_partitions=4, maxsize=128, group="g2", member_id="m2",
                               heartbeat_s=0.1)
            clients.append(m2)
            assert _drain_members([m1, m2], seen) == [1, 1]
            assert set(seen[0] + seen[1]) >= set(range(64))
            assert m1._session.generation > gen
            assert CLUSTER.stats()["rebalances_total"] >= 1
        finally:
            for c in clients:
                c.disconnect()
            _shutdown(servers)

    N_STALLED = 128

    def test_a_stalled_owners_pushed_frames_outlive_the_new_owners_drain(self):
        """m1 reads a frame of every partition, so each stream holds pushed
        frames, and stops reading. m2 joins and reads its share through the
        EOS. When m1 reads again, its revoked partitions' pushed frames are
        delivered by m1: put back at their queue's head, behind the EOS m2
        already read, nobody would read them. Every frame arrives once."""
        servers, addrs = _servers(2)
        clients = []
        try:
            prod = ClusterClient(addrs, n_partitions=4, maxsize=128)
            m1 = ClusterClient(addrs, n_partitions=4, maxsize=128, group="g6", member_id="m1",
                               heartbeat_s=0.1).stream_open(2)
            clients = [prod, m1]
            # event i on partition i % 4; deep enough that m1 cannot read a
            # partition to its EOS while another's stream is still opening
            for i in range(self.N_STALLED):
                assert prod.put(_frame(i))
            assert prod.put_wait(EndOfStream(0, -1, 1, 1), timeout=10)
            seen = [[], []]
            deadline = time.monotonic() + 10.0
            while {i % 4 for i in seen[0]} != {0, 1, 2, 3} and time.monotonic() < deadline:
                seen[0].extend(it.event_idx for it in m1.get_batch_stream(1, timeout=0.2)
                               if not is_eos(it))
                m1._scan += 1  # the next read starts at the next partition
            m2 = ClusterClient(addrs, n_partitions=4, maxsize=128, group="g6", member_id="m2",
                               heartbeat_s=0.1).stream_open(2)
            clients.append(m2)
            eos2 = 0
            deadline = time.monotonic() + 20.0
            while (not (m2.assigned() and m2._drained >= set(m2.assigned()))
                   and time.monotonic() < deadline):
                for it in m2.get_batch_stream(8, timeout=0.2):
                    if is_eos(it):
                        eos2 += 1
                    else:
                        seen[1].append(it.event_idx)
            assert m2._drained == set(m2.assigned()) and len(m2._drained) == 2
            eos = _drain_members([m1, m2], seen)
            assert [eos[0], eos[1] + eos2] == [1, 1]
            assert sorted(seen[0] + seen[1]) == list(range(self.N_STALLED))
        finally:
            for c in clients:
                c.disconnect()
            _shutdown(servers)

    def test_member_death_reassigns_with_zero_loss(self):
        servers, addrs = _servers(2)
        clients = []
        try:
            for s in servers:
                s.groups.session_timeout_s = 0.6
            prod = ClusterClient(addrs, n_partitions=4, maxsize=128)
            m1 = ClusterClient(addrs, n_partitions=4, maxsize=128, group="g3", member_id="m1",
                               heartbeat_s=0.15)
            m2 = ClusterClient(addrs, n_partitions=4, maxsize=128, group="g3", member_id="m2",
                               heartbeat_s=0.15)
            clients = [prod, m1]
            for i in range(48):
                assert prod.put(_frame(i))
            assert prod.put_wait(EndOfStream(0, -1, 1, 1), timeout=10)
            seen = set()
            for _ in range(3):
                for m in (m1, m2):
                    seen.update(it.event_idx for it in m.get_batch_stream(4, timeout=0.3)
                                if not is_eos(it))
            # m2 crashes: its keepalive stops with it, its sockets die, no leave
            m2._hb_stop.set()
            m2._hb_thread.join(timeout=2.0)
            for c in list(m2._clients.values()):
                c._sock.close()
            if m2._coord is not None:
                m2._coord._sock.close()
            got, eos = _drain_until_eos(m1, batch=8)
            assert set(got) | seen >= set(range(48)) and eos == 1
        finally:
            for c in clients:
                c.disconnect()
            _shutdown(servers)

    def test_fenced_drain_commit_is_retried_not_dropped(self):
        servers, addrs = _servers(1)
        prod = m1 = None
        try:
            servers[0].groups.session_timeout_s = 0.8  # the phantom expires fast
            prod = ClusterClient(addrs, n_partitions=2, maxsize=32)
            m1 = ClusterClient(addrs, n_partitions=2, maxsize=32, group="g5", member_id="m1",
                               heartbeat_s=0.1)
            for i in range(8):
                assert prod.put(_frame(i))
            assert prod.put_wait(EndOfStream(0, -1, 1, 1), timeout=10)
            with m1._lock:
                m1._ensure_joined()
            servers[0].groups.handle({"op": "join", "group": "g5", "member": "zz-phantom",
                                      "n_partitions": 2})
            got, eos = _drain_until_eos(m1)
            assert sorted(set(got)) == list(range(8)) and eos == 1
            info = servers[0].groups.handle({"op": "info", "group": "g5"})
            assert sorted(info["drained"]) == [0, 1]
        finally:
            for c in (prod, m1):
                if c:
                    c.disconnect()
            _shutdown(servers)

    def test_group_name_reuse_starts_a_fresh_drain_epoch(self):
        servers, addrs = _servers(1)
        try:
            for run in range(2):
                prod = ClusterClient(addrs, n_partitions=2, maxsize=32)
                m = ClusterClient(addrs, n_partitions=2, maxsize=32, group="reuse",
                                  member_id=f"m{run}", heartbeat_s=0.2)
                for i in range(run * 4, run * 4 + 4):
                    assert prod.put(_frame(i))
                assert prod.put_wait(EndOfStream(0, -1, 1, 1), timeout=10)
                got, eos = _drain_until_eos(m, budget_s=20.0)
                assert sorted(got) == list(range(run * 4, run * 4 + 4)) and eos == 1
                m.disconnect()
                prod.disconnect()
        finally:
            _shutdown(servers)

    def test_stale_member_commit_is_fenced_end_to_end(self):
        servers, addrs = _servers(1)
        try:
            m1 = ClusterClient(addrs, n_partitions=2, maxsize=16, group="g4", member_id="m1",
                               heartbeat_s=999)
            with m1._lock:
                m1._ensure_joined()
            stale = m1._session.generation
            m2 = ClusterClient(addrs, n_partitions=2, maxsize=16, group="g4", member_id="m2",
                               heartbeat_s=999)
            with m2._lock:
                m2._ensure_joined()
            fenced = CLUSTER.stats()["fenced_total"]
            assert m1._session.commit_drained(0) is False
            assert CLUSTER.stats()["fenced_total"] > fenced
            assert servers[0].groups.handle({"op": "info", "group": "g4"})["drained"] == []
            assert m1._session.generation > stale and m1._session.commit_drained(0) is True
            assert servers[0].groups.handle({"op": "info", "group": "g4"})["drained"] == [0]
            m1.disconnect()
            m2.disconnect()
        finally:
            _shutdown(servers)


# -- server death ----------------------------------------------------------------
class TestServerDeath:
    def test_kill_one_server_mid_stream_loses_zero_frames(self):
        servers, addrs = _servers(3)
        prod = cons = None
        try:
            prod = ClusterClient(addrs, n_partitions=4, maxsize=64, retain=256,
                                 reconnect_tries=1, reconnect_base_s=0.05)
            cons = ClusterClient(addrs, n_partitions=4, maxsize=64, reconnect_tries=1,
                                 reconnect_base_s=0.05)
            pmap = prod.partition_map
            victim_addr = max(addrs, key=lambda a: len(pmap.partitions_on(a)))
            victim = servers[addrs.index(victim_addr)]
            seen = set()
            for i in range(60):
                assert prod.put_pipelined(_frame(i), deadline=time.monotonic() + 10)
                if i == 20:
                    seen.update(it.event_idx for it in cons.get_batch_stream(8, timeout=0.5)
                                if not is_eos(it))
                    victim.shutdown()
            assert prod.flush_puts(time.monotonic() + 30)
            assert prod.put_wait(EndOfStream(0, -1, 1, 1), timeout=20)
            got, eos = _drain_until_eos(cons)
            assert not set(range(60)) - seen - set(got) and eos == 1
            assert prod.partition_map.version >= 2 and cons.partition_map.version >= 2
            assert victim_addr in prod.stats()["dead_servers"]
            assert CLUSTER.stats()["reassignments_total"] >= 1
        finally:
            for c in (prod, cons):
                if c:
                    c.disconnect()
            _shutdown(servers)

    def test_exact_unacked_tail_resends_to_the_new_owner(self):
        servers, addrs = _servers(2, maxsize=8)
        prod = None
        try:
            prod = ClusterClient(addrs, n_partitions=1, maxsize=8, retain=0, reconnect_tries=1,
                                 reconnect_base_s=0.05)
            owner = prod.partition_map.assignments[0]
            owner_srv = servers[addrs.index(owner)]
            survivor = servers[1 - addrs.index(owner)]
            for i in range(3):
                assert prod.put_pipelined(_frame(i), deadline=time.monotonic() + 5)
            assert prod.flush_puts(time.monotonic() + 10)
            for i in range(3, 11):
                assert prod.put_pipelined(_frame(i), deadline=time.monotonic() + 5)
            with prod._lock:
                assert [r.event_idx for r in prod._clients[0].unacked_puts()] == \
                    list(range(3, 11))
            deadline = time.monotonic() + 5.0
            while owner_srv.depth() < 8 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert owner_srv.depth() == 8
            tail_before = CLUSTER.stats()["tail_resent_total"]
            owner_srv.shutdown()
            assert prod.flush_puts(time.monotonic() + 30)
            host, _, port = addrs[1 - addrs.index(owner)].rpartition(":")
            drain = TcpQueueClient(host, int(port), namespace="default",
                                   queue_name=partition_queue_name("shared_queue", 0))
            assert sorted(r.event_idx for r in drain.get_batch(64, timeout=1.0)) == [8, 9, 10]
            assert survivor.depth() == 0
            assert CLUSTER.stats()["tail_resent_total"] - tail_before == 3
            drain.disconnect()
        finally:
            if prod:
                prod.disconnect()
            _shutdown(servers)

    def test_eos_broadcast_survives_server_death_via_retention(self):
        servers, addrs = _servers(2)
        prod = cons = None
        try:
            qname = _balanced_queue_name(addrs, 2, per_server_cap=1)
            prod = ClusterClient(addrs, queue_name=qname, n_partitions=2, maxsize=16, retain=16,
                                 reconnect_tries=1, reconnect_base_s=0.05)
            for i in range(6):
                assert prod.put(_frame(i))
            assert prod.put_wait(EndOfStream(0, -1, 1, 1), timeout=10)
            pmap = prod.partition_map
            victim_addr = max(addrs, key=lambda a: len(pmap.partitions_on(a)))
            servers[addrs.index(victim_addr)].shutdown()
            prod.size()  # any partition op fails over and resends, the marker too
            cons = ClusterClient(addrs, queue_name=qname, n_partitions=2, maxsize=16,
                                 reconnect_tries=1, reconnect_base_s=0.05)
            got, eos = _drain_until_eos(cons, budget_s=20.0)
            assert set(got) >= set(range(6)) and eos == 1
        finally:
            for c in (prod, cons):
                if c:
                    c.disconnect()
            _shutdown(servers)

    def test_graceful_close_is_not_a_failover(self):
        """A queue closed on a live server is an answer: the map stays."""
        servers, addrs = _servers(2)
        prod = None
        try:
            prod = ClusterClient(addrs, n_partitions=2, maxsize=16, reconnect_tries=1,
                                 reconnect_base_s=0.05)
            assert prod.put(_frame(0))
            prod.close_remote()
            with pytest.raises(TransportClosed):
                for i in range(1, 4):
                    prod.put(_frame(i))
            assert prod.partition_map.version == 1 and prod.stats()["dead_servers"] == []
        finally:
            if prod:
                prod.disconnect()
            _shutdown(servers)

    def test_all_servers_dead_raises(self):
        servers, addrs = _servers(2)
        prod = None
        try:
            prod = ClusterClient(addrs, n_partitions=2, maxsize=16, reconnect_tries=1,
                                 reconnect_base_s=0.05)
            assert prod.put(_frame(0))
            _shutdown(servers)
            with pytest.raises(TransportClosed):
                for i in range(1, 8):
                    prod.put(_frame(i))
        finally:
            if prod:
                prod.disconnect()


# -- durable clusters: migration on growth, the coordinator's store ---------------
def _durable_server(root, maxsize=200, port=0, store=None):
    def factory(ns, name, maxsize_):
        log = SegmentLog(os.path.join(str(root), f"{ns}__{name}"), name=name,
                         segment_bytes=1 << 20, fsync="none")
        return DurableRingBuffer(log, maxsize=maxsize_, name=name)

    return TcpQueueServer(factory("default", "default", maxsize), host="127.0.0.1", port=port,
                          maxsize=maxsize, queue_factory=factory,
                          group_store_path=store).serve_background()


def test_add_server_drains_log_backed_partitions(tmp_path):
    servers = [_durable_server(tmp_path / f"s{i}") for i in range(5)]
    prod = cons = None
    try:
        addrs = [f"127.0.0.1:{s.port}" for s in servers[:2]]
        prod = ClusterClient(addrs, queue_name="q", n_partitions=8, maxsize=200)
        for i in range(30):
            assert prod.put_pipelined(_frame(i))
        assert prod.put(EndOfStream(total_events=30))
        cons = ClusterClient(addrs, queue_name="q", n_partitions=8, maxsize=200)
        moved = 0
        for s in servers[2:]:
            moved = cons.add_server(f"127.0.0.1:{s.port}")
            if moved:
                break
        assert moved > 0
        assert cons.add_server(f"127.0.0.1:{servers[2].port}") == 0  # already a member
        seen = []
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            batch = cons.get_batch(32, timeout=1.0)
            seen.extend(r.event_idx for r in batch if not is_eos(r))
            if any(is_eos(r) for r in batch):
                break
        assert sorted(set(seen)) == list(range(30))
    finally:
        for c in (prod, cons):
            if c:
                c.disconnect()
        _shutdown(servers)


def test_registry_recovers_from_its_store_across_a_restart(tmp_path):
    """A durable coordinator restarted on its store: the group's drain
    progress and its partitions' committed offsets survive, generations
    go on, and a member's drained commit carries its partition's offset."""
    store = str(tmp_path / "groups.json")
    srv = _durable_server(tmp_path / "s0", store=store)
    addrs = [f"127.0.0.1:{srv.port}"]
    prod = ClusterClient(addrs, queue_name="q", n_partitions=2, maxsize=32)
    for i in range(4):
        assert prod.put(_frame(i))
    assert prod.put_wait(EndOfStream(0, -1, 1, 1), timeout=10)
    prod.disconnect()
    m = ClusterClient(addrs, queue_name="q", n_partitions=2, maxsize=32, group="dur",
                      member_id="m1", heartbeat_s=0.2)
    got, eos = _drain_until_eos(m)
    assert sorted(got) == list(range(4)) and eos == 1
    before = srv.groups.handle({"op": "info", "group": "dur"})
    assert before["drained"] == [0, 1] and set(before["offsets"]) == {"0", "1"}
    m._hb_stop.set()  # the member dies without leaving
    srv.shutdown()
    port = srv.port
    srv = _durable_server(tmp_path / "s0", port=port, store=store)
    try:
        after = srv.groups.handle({"op": "info", "group": "dur"})
        assert (after["drained"], after["offsets"]) == (before["drained"], before["offsets"])
        assert after["generation"] >= before["generation"] and after["members"] == []
        with open(store) as f:
            assert json.load(f)["groups"]["dur"]["drained"] == [0, 1]
    finally:
        srv.shutdown()


def test_a_spawn_producer_feeds_a_cluster():
    """``produce_synthetic`` with a ``cluster://`` target: a ``spawn``
    producer process puts the pool cycled into the partitions with its own
    retention, and reports its peak RSS and its ``CLUSTER`` counters."""
    import multiprocessing as mp

    from psana_ray_tpu_torch.producer import produce_synthetic

    servers, addrs = _servers(2)
    cons = None
    try:
        ctx = mp.get_context("spawn")
        produced, stats = ctx.Value("q", 0), ctx.Queue()
        proc = ctx.Process(target=produce_synthetic,
                           args=("cluster://" + ",".join(addrs), "smoke_a", 20, 4),
                           kwargs=dict(produced=produced, queue_name="spawned", partitions=2,
                                       retain=8, stats=stats))
        proc.start()
        cons = ClusterClient(addrs, queue_name="spawned", n_partitions=2, maxsize=64)
        got, eos = _drain_until_eos(cons)
        proc.join(timeout=60)
        report = stats.get(timeout=10)
        assert proc.exitcode == 0 and produced.value == 20
        assert sorted(got) == list(range(20)) and eos == 1
        assert report["peak_rss_bytes"] > 0
        assert report["cluster"]["map_version"] == 1 and report["cluster"]["partitions"] == 2
    finally:
        if cons:
            cons.disconnect()
        _shutdown(servers)


def test_data_reader_replays_a_durable_cluster(tmp_path):
    """``DataReader(replay_from="begin")`` over ``cluster://`` reads every
    partition's retained log again after a live drain, for its own group."""
    from psana_ray_tpu_torch.consumer import DataReader

    servers = [_durable_server(tmp_path / f"s{i}") for i in range(2)]
    addrs = [f"127.0.0.1:{s.port}" for s in servers]
    try:
        cfg = TransportConfig(address="cluster://" + ",".join(addrs), cluster_partitions=2,
                              queue_name="rq")
        prod = ClusterClient(addrs, queue_name="rq", n_partitions=2, maxsize=64)
        for i in range(10):
            assert prod.put(_frame(i))
        assert prod.put_wait(EndOfStream(0, -1, 1, 1), timeout=10)
        prod.disconnect()
        with DataReader(address=cfg.address, config=cfg) as live:
            assert sorted(r.event_idx for r in live.iter_records()) == list(range(10))
        with DataReader(address=cfg.address, config=cfg, replay_from="begin",
                        replay_group="audit") as replay:
            assert sorted(r.event_idx for r in replay.iter_records()) == list(range(10))
    finally:
        _shutdown(servers)
