"""The port's queue addressing against the JAX package's.

``open_queue`` over ``auto`` (the in-process ``Registry``: a producer
get-or-creates the named ring, a consumer resolves it with the config's
retry loop) and over ``shm://`` between two processes; the producer's
create-or-attach race; ``tcp://`` opening a client of the queue server;
the config's fields against the JAX package's; and the shm ring names,
which both packages must derive alike for their processes to
rendezvous. ``cluster://`` is held in ``tests/test_torch_queue_cluster.py``.
"""

import multiprocessing as mp
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from psana_ray_tpu_torch.config import TransportConfig  # noqa: E402
from psana_ray_tpu_torch.records import EndOfStream, FrameRecord  # noqa: E402
from psana_ray_tpu_torch.transport import (  # noqa: E402
    Registry,
    RendezvousTimeout,
    RingBuffer,
    ShmRingBuffer,
)
from psana_ray_tpu_torch.transport import addressing  # noqa: E402
from psana_ray_tpu_torch.transport.addressing import open_queue, shm_ring_name  # noqa: E402
from torch_parity import _no_lingering_child  # noqa: E402,F401 (autouse)

SPAWN = mp.get_context("spawn")


def _unique(tag: str) -> str:
    return f"addr_{tag}_{os.getpid()}_{time.monotonic_ns() % 10**9}"


def test_auto_round_trip_through_the_registry():
    reg = Registry()
    cfg = TransportConfig(queue_name="q", queue_size=4, rendezvous_retries=20,
                          rendezvous_interval_s=0.05)
    got = []
    consumer = threading.Thread(
        target=lambda: got.append(open_queue(cfg, role="consumer", registry=reg)), daemon=True)
    consumer.start()  # resolves with retries before the producer creates the queue
    time.sleep(0.05)
    prod = open_queue(cfg, role="producer", registry=reg)
    consumer.join(timeout=5.0)
    assert not consumer.is_alive() and got == [prod]
    assert isinstance(prod, RingBuffer) and prod.maxsize == 4
    assert open_queue(cfg, role="producer", registry=reg) is prod  # get-or-create
    assert prod.put(FrameRecord(0, 7, np.ones((1, 2, 2), np.float32), 9.5))
    assert got[0].get().event_idx == 7
    other = TransportConfig(namespace="ns2", queue_name="q")
    assert open_queue(other, role="producer", registry=reg) is not prod
    with pytest.raises(RendezvousTimeout):
        open_queue(TransportConfig(queue_name="none", rendezvous_retries=2,
                                   rendezvous_interval_s=0.01), registry=reg)


def test_auto_uses_the_default_registry():
    Registry.reset_default()
    try:
        cfg = TransportConfig(address="local", queue_name="default_q")
        prod = open_queue(cfg, role="producer")
        assert open_queue(cfg, role="consumer") is prod
        assert Registry.default().resolve("default", "default_q", retries=0) is prod
    finally:
        Registry.reset_default()


def _shm_producer(name: str, n: int) -> None:
    cfg = TransportConfig(address=f"shm://{name}", queue_size=8, rendezvous_retries=50,
                          rendezvous_interval_s=0.1)
    ring = open_queue(cfg, role="producer")
    try:
        for i in range(n):
            assert ring.put_wait(FrameRecord(0, i, np.full((2, 4, 4), i, np.float32), 9.5),
                                 timeout=30.0)
        assert ring.put_wait(EndOfStream(total_events=n), timeout=30.0)
    finally:
        ring.disconnect()


def test_shm_round_trip_between_two_processes():
    """A consumer opens first and waits; a producer process get-or-creates
    the ring from its config alone and streams into it."""
    name, n = _unique("xproc"), 12
    owner = ShmRingBuffer.create(name, maxsize=8, slot_bytes=4096)  # the operator's ring
    proc = SPAWN.Process(target=_shm_producer, args=(name, n))
    proc.start()
    try:
        cons = open_queue(TransportConfig(address=f"shm://{name}", rendezvous_retries=50,
                                          rendezvous_interval_s=0.1))
        got = []
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            item = cons.get_wait(timeout=1.0)
            if isinstance(item, EndOfStream):
                break
            if isinstance(item, FrameRecord):
                got.append((item.event_idx, float(item.panels.mean())))
        proc.join(timeout=30)
        assert proc.exitcode == 0
        assert got == [(i, float(i)) for i in range(n)]
        cons.disconnect()
    finally:
        if proc.is_alive():
            proc.terminate()
        owner.destroy()


def test_shm_producer_creates_then_attaches():
    """The first producer creates the ring named by (namespace,
    queue_name); a second attaches to the same ring."""
    cfg = TransportConfig(address="shm://", namespace=_unique("ns"), queue_name="q",
                          queue_size=4)
    a = open_queue(cfg, role="producer")
    try:
        b = open_queue(cfg, role="producer")
        assert a.name == b.name == shm_ring_name(cfg)
        assert a.put(FrameRecord(0, 3, np.zeros((1, 2, 2), np.float32), 1.0))
        assert b.size() == 1 and b.get().event_idx == 3
        b.disconnect()
    finally:
        a.destroy()


def test_shm_producer_that_loses_the_create_race_attaches(monkeypatch):
    """Between a producer's failed attach and its create, another producer
    creates the ring: the create fails and the loser attaches to it."""
    name = _unique("race")
    cfg = TransportConfig(address=f"shm://{name}", queue_size=4, rendezvous_retries=5,
                          rendezvous_interval_s=0.01)
    winner = {}
    real_create, real_attach = ShmRingBuffer.create, ShmRingBuffer.attach

    def attach(n, retries=10, interval_s=1.0):
        if "ring" not in winner:  # the loser looks before the winner has created
            winner["ring"] = real_create(n, maxsize=4, slot_bytes=4096)
            raise RendezvousTimeout(n)
        return real_attach(n, retries=retries, interval_s=interval_s)

    def create(n, maxsize=64, slot_bytes=None):
        raise RuntimeError(f"shmring_create({n!r}) failed")

    monkeypatch.setattr(ShmRingBuffer, "attach", staticmethod(attach))
    monkeypatch.setattr(ShmRingBuffer, "create", staticmethod(create))
    loser = open_queue(cfg, role="producer")
    try:
        assert loser.put(FrameRecord(0, 5, np.zeros((1, 2, 2), np.float32), 1.0))
        assert winner["ring"].get().event_idx == 5
        loser.disconnect()
    finally:
        winner["ring"].destroy()


def test_consumer_times_out_on_a_missing_ring():
    cfg = TransportConfig(address=f"shm://{_unique('missing')}", rendezvous_retries=2,
                          rendezvous_interval_s=0.01)
    with pytest.raises(RendezvousTimeout):
        open_queue(cfg)


@pytest.mark.parametrize("address", ["tcp://localhost:5555"])
def test_tcp_and_cluster_are_refused_naming_item_8(address):
    """``tcp://`` opens a client bound to the config's named queue on a
    live server (the port of the address is the server's); an unknown
    scheme and role are refused."""
    from psana_ray_tpu_torch.transport.tcp import TcpQueueClient, TcpQueueServer

    srv = TcpQueueServer(host="127.0.0.1", port=0).serve_background()
    try:
        cfg = TransportConfig(address=address.replace("5555", str(srv.port)),
                              namespace="ns", queue_name="q")
        q = open_queue(cfg, role="producer")
        assert isinstance(q, TcpQueueClient)
        assert q.put(EndOfStream()) and srv.named_queues() == [("ns", "q")]
        q.disconnect()
    finally:
        srv.shutdown()
    with pytest.raises(ValueError, match="unknown address"):
        open_queue(TransportConfig(address="udp://x"))
    with pytest.raises(ValueError, match="role"):
        open_queue(TransportConfig(), role="observer")


def test_config_keeps_the_jax_fields_and_refuses_the_rest():
    import dataclasses

    from psana_ray_tpu.config import TransportConfig as JaxConfig

    ours = {f.name: f.default for f in dataclasses.fields(TransportConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert ours == theirs  # every field, with its default
    with pytest.raises(TypeError, match="colour"):
        TransportConfig(colour="blue")
    assert dataclasses.replace(TransportConfig(), address="shm://x").address == "shm://x"


@pytest.mark.parametrize("address,namespace,queue", [
    ("shm://", "default", "shared_queue"),
    ("shm://explicit_ring", "ns", "q"),
    ("auto", "runs", "epix"),
    ("shm://", "a b", "c/d"),
])
def test_shm_ring_names_match_the_jax_package(address, namespace, queue):
    from psana_ray_tpu.config import TransportConfig as JaxConfig
    from psana_ray_tpu.transport import addressing as jax_addressing
    from psana_ray_tpu.transport.shm_ring import ShmRingBuffer as JaxShmRing

    ours = shm_ring_name(TransportConfig(namespace=namespace, queue_name=queue), address)
    theirs = jax_addressing.shm_ring_name(JaxConfig(namespace=namespace, queue_name=queue), address)
    assert ours == theirs
    assert ShmRingBuffer._shm_name(ours) == JaxShmRing._shm_name(theirs)


def test_a_jax_producer_rendezvouses_with_a_port_consumer():
    """Rings named from the same config are one ring across the packages."""
    from psana_ray_tpu.config import TransportConfig as JaxConfig
    from psana_ray_tpu.records import FrameRecord as JaxRecord
    from psana_ray_tpu.transport.addressing import open_queue as jax_open_queue

    ns = _unique("both")
    prod = jax_open_queue(JaxConfig(address="shm://", namespace=ns, queue_size=4),
                          role="producer")
    try:
        cons = addressing.open_queue(TransportConfig(address="shm://", namespace=ns,
                                                     rendezvous_retries=1,
                                                     rendezvous_interval_s=0.01))
        assert prod.put(JaxRecord(0, 9, np.ones((1, 2, 3), np.float32), 8.0))
        rec = cons.get_wait(timeout=5.0)
        assert rec.event_idx == 9 and rec.panels.shape == (1, 2, 3)
        cons.disconnect()
    finally:
        prod.destroy()
