"""The port's TCP transport against the contract of the JAX package's
``tests/test_tcp.py`` and ``tests/test_tcp_stream.py``: the event-loop
server and the client of ``psana_ray_tpu_torch.transport.tcp``.

FIFO order and backpressure; the batched opcodes; named queues and
namespaces on one server; drain; reconnect with the binding replayed;
delivery held in flight until the next request and put back at the
queue's head (ahead of EOS markers) when a connection dies; windowed puts
with the unacked tail resent on reconnect; server-push streams with
credit, the exact unacked tail redelivered, and the side channel;
server-side bounded waits; ``--max_conns`` refusal; the weighted fair
share of two tenants; and the batcher and ``DataReader`` draining a
stream.
"""

import socket
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from psana_ray_tpu_torch.config import TransportConfig  # noqa: E402
from psana_ray_tpu_torch.consumer import DataReader  # noqa: E402
from psana_ray_tpu_torch.infeed.batcher import batches_from_queue  # noqa: E402
from psana_ray_tpu_torch.records import EndOfStream, FrameRecord  # noqa: E402
from psana_ray_tpu_torch.transport import EMPTY, RingBuffer, TransportClosed  # noqa: E402
from psana_ray_tpu_torch.transport.addressing import open_queue  # noqa: E402
from psana_ray_tpu_torch.transport.tcp import (  # noqa: E402
    STREAM,
    TcpQueueClient,
    TcpQueueServer,
)

FAST = dict(reconnect_tries=3, reconnect_base_s=0.05)


def _rec(idx, shape=(1, 8, 8), rank=0, dtype=np.float32):
    return FrameRecord(rank, idx, np.full(shape, idx, dtype), 1.0 + idx)


def _mk(maxsize=64, **kw):
    q = RingBuffer(maxsize)
    return q, TcpQueueServer(q, host="127.0.0.1", **kw).serve_background()


def _client(srv, **kw):
    return TcpQueueClient("127.0.0.1", srv.port, timeout_s=10.0, **{**FAST, **kw})


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def _drain(port, n, timeout=5.0):
    c = TcpQueueClient("127.0.0.1", port, **FAST)
    out = []
    deadline = time.monotonic() + timeout
    while len(out) < n and time.monotonic() < deadline:
        out.extend(c.get_batch(n - len(out), timeout=0.3))
    c.disconnect()
    return out


@pytest.fixture
def server():
    q, srv = _mk(maxsize=4)
    yield q, srv
    srv.close_all()
    srv.shutdown()


# -- request/response ----------------------------------------------------


def test_fifo_roundtrip_and_full_backpressure(server):
    _, srv = server
    c = _client(srv)
    for i in range(4):
        assert c.put(i)
    assert not c.put(99)  # full: refused, never dropped
    assert c.size() == 4
    assert [c.get() for _ in range(4)] == [0, 1, 2, 3]
    assert c.get() is EMPTY
    assert c.get_wait(timeout=0.05) is EMPTY
    c.disconnect()


@pytest.mark.parametrize("dtype", [np.float32, np.uint16, np.float64])
def test_frame_payload_roundtrip(server, dtype):
    _, srv = server
    c = _client(srv)
    rng = np.random.default_rng(3)
    panels = (rng.random((2, 16, 24)) * 1000).astype(dtype)
    assert c.put(FrameRecord(3, 7, panels, 9.5, 1.25))
    got = c.get()
    assert (got.shard_rank, got.event_idx, got.photon_energy, got.timestamp) == (3, 7, 9.5, 1.25)
    assert got.panels.dtype == dtype and np.array_equal(got.panels, panels)
    assert got.lease is not None  # a view of a pooled receive buffer
    got.release()
    c.disconnect()


def test_put_batch_get_batch_and_truncation(server):
    q, srv = server
    c = _client(srv)
    assert c.put_batch([_rec(i) for i in range(6)]) == 4  # full after 4: the prefix
    assert [r.event_idx for r in c.get_batch(3, timeout=1.0)] == [0, 1, 2]
    assert [r.event_idx for r in c.get_batch(10, timeout=1.0)] == [3]
    t0 = time.monotonic()
    assert c.get_batch(4, timeout=0.2) == []
    assert time.monotonic() - t0 < 2.0
    c.disconnect()


def test_remote_close_propagates(server):
    _, srv = server
    c, other = _client(srv), _client(srv)
    c.close_remote()
    with pytest.raises(TransportClosed):
        other.put(1)
    with pytest.raises(TransportClosed):
        other.get_wait(timeout=0.5)
    c.disconnect()
    other.disconnect()


def test_named_queues_namespaces_and_default(server):
    q, srv = server
    a = TcpQueueClient("127.0.0.1", srv.port, namespace="det", queue_name="epix", **FAST)
    b = TcpQueueClient("127.0.0.1", srv.port, namespace="det", queue_name="jungfrau", **FAST)
    other_ns = TcpQueueClient("127.0.0.1", srv.port, namespace="ns2", queue_name="epix", **FAST)
    plain = _client(srv)
    a.put("a")
    b.put("b")
    plain.put("default")
    assert other_ns.get() is EMPTY  # same name, another namespace
    assert (a.get(), b.get()) == ("a", "b")
    assert q.get() == "default"  # connections without OPEN use the default queue
    assert srv.named_queues() == [("det", "epix"), ("det", "jungfrau"), ("ns2", "epix")]
    a.close_remote()
    with pytest.raises(TransportClosed):
        a.put(1)
    assert b.put("still open")
    for c in (a, b, other_ns, plain):
        c.disconnect()


def test_open_queue_and_stats(server):
    _, srv = server
    cfg = TransportConfig(address=f"tcp://127.0.0.1:{srv.port}", namespace="n", queue_name="q",
                          queue_size=7)
    prod, cons = open_queue(cfg, role="producer"), open_queue(cfg, role="consumer")
    assert prod.put(EndOfStream(producer_rank=2))
    assert cons.get() == EndOfStream(producer_rank=2)
    stats = cons.stats()
    assert stats["maxsize"] == 7 and stats["puts"] == 1 and stats["gets"] == 1
    anchor = cons.anchor()
    assert anchor["send_mono"] <= anchor["recv_mono"] and anchor["rtt_s"] >= 0
    prod.disconnect()
    cons.disconnect()


def test_drain_refuses_puts_and_serves_gets(server):
    q, srv = server
    c = _client(srv)
    named = TcpQueueClient("127.0.0.1", srv.port, namespace="x", queue_name="y", **FAST)
    c.put(1)
    named.put(2)
    srv.begin_drain()
    assert srv.draining and srv.depth() == 2
    for client in (c, named):
        with pytest.raises(TransportClosed):
            client.put(3)
    with pytest.raises(TransportClosed):
        q.put(4)  # producers that bypass TCP are refused too
    assert c.get() == 1 and named.get() == 2
    c.disconnect()
    named.disconnect()


# -- reconnect -----------------------------------------------------------


def test_reconnect_replays_the_named_binding():
    q, srv = _mk()
    try:
        c = TcpQueueClient("127.0.0.1", srv.port, namespace="n", queue_name="q", **FAST)
        c.put(1)
        c._sock.close()  # a network drop
        assert c.put(2)
        assert [c.get(), c.get()] == [1, 2]
        assert q.size() == 0  # both went to the named queue, not the default
        c.disconnect()
    finally:
        srv.shutdown()


def test_dead_server_raises_transport_closed_and_restart_is_ridden_out():
    q, srv = _mk()
    port = srv.port
    c = TcpQueueClient("127.0.0.1", port, reconnect_tries=8, reconnect_base_s=0.05)
    c.put(1)
    srv.shutdown()
    holder = {}

    def restart():
        time.sleep(0.3)
        holder["q"] = RingBuffer(8)
        holder["srv"] = TcpQueueServer(holder["q"], host="127.0.0.1", port=port).serve_background()

    t = threading.Thread(target=restart, daemon=True)
    t.start()
    assert c.put(2)  # rides the restart out
    t.join(30)
    assert not t.is_alive()
    assert holder["q"].get() == 2
    c.disconnect()
    holder["srv"].shutdown()
    with pytest.raises(TransportClosed):
        TcpQueueClient("127.0.0.1", port, reconnect_tries=2, reconnect_base_s=0.01)


# -- delivery ------------------------------------------------------------


@pytest.mark.parametrize("ending", ["crash", "bye", "next_request"])
def test_delivery_is_held_until_acked(ending):
    q, srv = _mk()
    try:
        for i in range(3):
            q.put(i)
        c = _client(srv)
        assert [c.get(), c.get()] == [0, 1]  # the second get acks the first
        if ending == "crash":
            c._sock.close()  # delivery 1 in flight: back at the head
            assert _wait(lambda: q.size() == 2)
            assert [q.get(), q.get()] == [1, 2]
        elif ending == "bye":
            c.disconnect()
            time.sleep(0.2)
            assert q.size() == 1 and q.get() == 2
        else:
            assert c.size() == 1  # any next opcode acks delivery 1
            c._sock.close()
            time.sleep(0.2)
            assert q.size() == 1 and q.get() == 2
    finally:
        srv.shutdown()


def test_requeue_lands_ahead_of_eos():
    q, srv = _mk()
    try:
        for i in range(2):
            q.put(_rec(i))
        c = _client(srv)
        got = c.get_batch(2, timeout=1.0)
        assert [r.event_idx for r in got] == [0, 1]
        q.put(EndOfStream())  # the producer finished meanwhile
        c._sock.close()  # died before acking the batch
        assert _wait(lambda: q.size() == 3)
        out = [q.get() for _ in range(3)]
        assert [getattr(r, "event_idx", None) for r in out[:2]] == [0, 1]
        assert isinstance(out[2], EndOfStream)
    finally:
        srv.shutdown()


# -- windowed puts -------------------------------------------------------


def test_windowed_puts_fifo_flush_and_resend_on_reconnect():
    q, srv = _mk()
    try:
        c = _client(srv)
        for i in range(10):
            assert c.put_pipelined(_rec(i), deadline=time.monotonic() + 5)
        assert c.flush_puts(deadline=time.monotonic() + 5) and c.unacked_puts() == []
        assert [q.get().event_idx for _ in range(10)] == list(range(10))
        resent = STREAM.stats()["put_resent_total"]
        for i in range(10, 13):
            assert c.put_pipelined(_rec(i), deadline=time.monotonic() + 5)
        c._sock.close()  # acks unread: the tail is unconfirmed
        for i in range(13, 16):
            assert c.put_pipelined(_rec(i), deadline=time.monotonic() + 5)
        assert c.flush_puts(deadline=time.monotonic() + 5)
        out = []
        while q.size():
            out.append(q.get().event_idx)
        assert sorted(set(out)) == list(range(10, 16)) and len(out) >= 6  # no holes
        assert STREAM.stats()["put_resent_total"] >= resent + 3
        c.disconnect()
    finally:
        srv.shutdown()


def test_windowed_puts_under_backpressure():
    q, srv = _mk(maxsize=3)
    try:
        c = _client(srv, put_window=4)
        drained = []

        def consume():
            while len(drained) < 12:
                item = q.get_wait(timeout=0.2)
                if item is not EMPTY:
                    drained.append(item.event_idx)
                    time.sleep(0.01)  # slow: the acks wait for room

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        for i in range(12):
            while not c.put_pipelined(_rec(i), deadline=time.monotonic() + 0.2):
                pass
        assert c.flush_puts(deadline=time.monotonic() + 10)
        t.join(timeout=10)
        assert drained == list(range(12))
        assert q.stats()["puts_rejected"] > 0  # the server's enqueue did wait
        c.disconnect()
    finally:
        srv.shutdown()


@pytest.mark.parametrize("drained", [True, False])
def test_produce_sends_windowed_over_tcp_and_times_out_on_a_full_queue(drained):
    """``produce`` on a TCP client goes through the producer's windowed
    sender: every record and the EOS acked before it returns, or
    ``TimeoutError`` once a full queue holds the window past ``timeout``."""
    from psana_ray_tpu_torch.producer import produce

    q, srv = _mk(maxsize=3)
    try:
        c = _client(srv, put_window=2)
        events = ((i, np.full((1, 8, 8), i, np.float32), 1.0) for i in range(8))
        if drained:
            got = []

            def consume():
                while len(got) < 9:
                    item = q.get_wait(timeout=0.2)
                    if item is not EMPTY:
                        got.append(item)

            t = threading.Thread(target=consume, daemon=True)
            t.start()
            assert produce(events, c, timeout=10.0) == 8
            t.join(timeout=10)
            assert [r.event_idx for r in got[:8]] == list(range(8))
            assert isinstance(got[8], EndOfStream) and got[8].total_events == 8
        else:
            with pytest.raises(TimeoutError):
                produce(events, c, timeout=0.5)
        c.disconnect()
    finally:
        srv.close_all()
        srv.shutdown()


def test_produce_synthetic_feeds_open_queues_named_queue_over_tcp():
    """``produce_synthetic`` with a ``tcp://`` target puts into
    ``open_queue``'s default named queue on the server: the pool cycled,
    then one EOS."""
    from psana_ray_tpu_torch.producer import produce_synthetic
    from psana_ray_tpu_torch.sources import SyntheticSource

    q, srv = _mk()
    try:
        address = f"tcp://127.0.0.1:{srv.port}"
        assert produce_synthetic(address, "smoke_a", 5, 2, seed=3) == 5
        c = open_queue(TransportConfig(address=address), role="consumer")
        got = c.get_batch(6, timeout=5.0)
        c.disconnect()
    finally:
        srv.close_all()
        srv.shutdown()
    pool = [SyntheticSource(num_events=2, detector_name="smoke_a", seed=3).event(i, "raw")[0]
            for i in range(2)]
    assert [r.event_idx for r in got[:5]] == list(range(5))
    assert all(np.array_equal(r.panels, pool[r.event_idx % 2]) for r in got[:5])
    assert isinstance(got[5], EndOfStream) and got[5].total_events == 5
    assert q.size() == 0  # the server's default queue is another one


# -- streams -------------------------------------------------------------


def _pushed(q, srv, n, window=32):
    for i in range(n):
        q.put(_rec(i))
    c = _client(srv)
    c.stream_open(window=window)
    return c


def test_stream_fifo_late_frames_and_side_channel():
    q, srv = _mk()
    try:
        c = _pushed(q, srv, 5)
        got = []
        while len(got) < 5:
            got.extend(c.get_batch_stream(5, timeout=2.0))
        assert [r.event_idx for r in got] == list(range(5))
        threading.Timer(0.1, lambda: q.put(_rec(5))).start()
        later = c.get_batch_stream(4, timeout=3.0)  # pushed as it arrives
        assert [r.event_idx for r in later] == [5]
        # requests on a streamed client go over a side channel
        assert c.put(_rec(6))
        assert c.get_wait(timeout=2.0).event_idx == 6
        assert c.stats()["puts"] >= 7
        c.disconnect()
    finally:
        srv.shutdown()


def test_side_channel_takes_the_put_window_under_the_lock():
    """A streamed client's side channel is dialled with the put window
    read under the client's lock, the lock ``set_put_window`` (the autotune
    dial) writes it under, as the JAX client's ``_side_channel`` reads it."""
    q, srv = _mk()
    try:
        c = _pushed(q, srv, 0)
        c.set_put_window(5)
        held = []

        class Watched(TcpQueueClient):
            @property
            def _put_window(self):
                held.append(self._lock.locked())
                return self.__dict__["_put_window"]

            @_put_window.setter
            def _put_window(self, n):
                self.__dict__["_put_window"] = n

        c.__class__ = Watched
        try:
            assert c.put(_rec(0))  # a streamed client's put dials the side channel
        finally:
            c.__class__ = TcpQueueClient
        assert held and all(held), held
        assert c._side.put_window == 5
        assert [r.event_idx for r in c.get_batch_stream(1, timeout=2.0)] == [0]
        c.disconnect()
    finally:
        srv.shutdown()


def test_stream_credit_window_bounds_pushes():
    q, srv = _mk()
    try:
        c = _pushed(q, srv, 10, window=3)
        assert _wait(lambda: q.size() == 7)  # three pushed, then no credit
        time.sleep(0.2)
        assert q.size() == 7
        got = c.get_batch_stream(10, timeout=2.0)
        assert [r.event_idx for r in got] == [0, 1, 2]
        c.get_batch_stream(1, timeout=2.0)  # acks 0..2: three more credits
        assert _wait(lambda: q.size() <= 4)
        c.disconnect()
    finally:
        srv.shutdown()


@pytest.mark.parametrize("acked", [0, 6])
def test_stream_death_redelivers_exactly_the_unacked_tail(acked):
    q, srv = _mk()
    try:
        c = _pushed(q, srv, 10)
        first = c.get_batch_stream(6, timeout=2.0)
        assert len(first) == 6
        if acked:
            assert [r.event_idx for r in c.get_batch_stream(1, timeout=2.0)] == [6]
            # let the ack land first: a close with pushes unread resets the
            # connection, and a reset may drop the server's unread bytes
            time.sleep(0.2)
        c._sock.close()  # crash: no BYE
        want = list(range(10)) if not acked else [6, 7, 8, 9]
        assert _wait(lambda: q.size() == len(want))
        assert sorted(r.event_idx for r in _drain(srv.port, len(want))) == want
    finally:
        srv.shutdown()


def test_stream_clean_disconnect_and_reconnect_mid_stream():
    q, srv = _mk()
    try:
        c = _pushed(q, srv, 5)
        got = []
        while len(got) < 5:
            got.extend(c.get_batch_stream(5 - len(got), timeout=2.0))
        c.disconnect()
        time.sleep(0.2)
        assert q.size() == 0  # the final ack: nothing redelivered
        c = _pushed(q, srv, 12)
        seen = {r.event_idx for r in c.get_batch_stream(4, timeout=2.0)}
        c._sock.close()  # a drop under the reader: it resubscribes
        deadline = time.monotonic() + 10
        while len(seen) < 12 and time.monotonic() < deadline:
            seen.update(r.event_idx for r in c.get_batch_stream(12, timeout=0.3))
        assert seen == set(range(12))
        c.disconnect()
    finally:
        srv.shutdown()


def test_queue_close_ends_the_stream():
    q, srv = _mk()
    try:
        c = _pushed(q, srv, 1)
        assert len(c.get_batch_stream(1, timeout=2.0)) == 1
        q.close()
        with pytest.raises(TransportClosed):
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                c.get_batch_stream(1, timeout=0.2)
        c.disconnect()
    finally:
        srv.shutdown()


# -- bounded waits, admission, tenants ----------------------------------


def test_server_side_waits_wake_promptly():
    q, srv = _mk(maxsize=1)
    try:
        c = _client(srv)
        threading.Timer(0.2, lambda: q.put("late")).start()
        t0 = time.monotonic()
        assert c.get_wait(timeout=5.0) == "late"
        assert time.monotonic() - t0 < 2.0
        q.put("full")
        threading.Timer(0.2, q.get).start()
        t0 = time.monotonic()
        assert c.put_wait("room", timeout=5.0)
        assert time.monotonic() - t0 < 2.0 and q.get() == "room"
        c.disconnect()
    finally:
        srv.shutdown()


def test_max_conns_refuses_past_the_limit():
    q, srv = _mk(max_conns=1)
    try:
        first = _client(srv)
        assert first.put(1)
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        assert s.recv(1) == b"E"  # accepted, refused, closed
        s.close()
        first.disconnect()
        time.sleep(0.1)
        second = _client(srv)
        assert second.get() == 1  # room again once the first left
        second.disconnect()
    finally:
        srv.shutdown()


def test_tenant_weights_share_the_stream_pump():
    """Two subscribers of tenants 3:1 on one backlog: the pushes converge
    to the weight shares."""
    n = 320
    q, srv = _mk(maxsize=n + 8)
    try:
        clients = [_client(srv, tenant="heavy", tenant_weight=3),
                   _client(srv, tenant="light", tenant_weight=1)]
        for c in clients:
            c.stream_open(window=n)
        time.sleep(0.1)  # both parked in the pump
        for i in range(n):
            assert q.put(_rec(i))
        counts = [0, 0]

        def drain(i):
            deadline = time.monotonic() + 10
            while sum(counts) < n and time.monotonic() < deadline:
                counts[i] += len(clients[i].get_batch_stream(n, timeout=0.1))

        threads = [threading.Thread(target=drain, args=(i,), daemon=True) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=15)
        assert sum(counts) == n, counts
        assert 0.75 * 0.85 <= counts[0] / n <= 0.75 * 1.15, counts
        for c in clients:
            c.disconnect()
    finally:
        srv.close_all()
        srv.shutdown()


# -- the consumer side over a stream -------------------------------------


def test_batches_from_queue_prefers_the_stream_and_releases_leases():
    q, srv = _mk()
    try:
        for i in range(10):
            q.put(_rec(i))
        q.put(EndOfStream())
        c = _client(srv)
        out = list(batches_from_queue(c, 4, poll_interval_s=0.05))
        assert c._stream is not None  # the pop was get_batch_stream
        assert [b.num_valid for b in out] == [4, 4, 2]
        frames = np.concatenate([b.frames[:b.num_valid] for b in out])
        assert [int(f.flat[0]) for f in frames] == list(range(10))
        c.disconnect()
        assert _wait(lambda: q.size() == 0)
    finally:
        srv.shutdown()


def test_datareader_streaming_iterates_with_a_sibling_eos():
    _, srv = _mk()
    try:
        q = srv.open_named("ns", "q")
        for i in range(6):
            q.put(_rec(i, rank=i % 2))
        q.put(EndOfStream(producer_rank=0, shards_done=1, total_shards=2))
        q.put(EndOfStream(producer_rank=0, shards_done=1, total_shards=2))  # a sibling's
        q.put(EndOfStream(producer_rank=1, shards_done=1, total_shards=2))
        with DataReader(f"tcp://127.0.0.1:{srv.port}", queue_name="q", namespace="ns",
                        streaming=True, stream_window=4) as r:
            assert r.queue._stream is not None and r.queue._stream.window == 4
            got = [rec.event_idx for rec in r.iter_records()]
        assert got == list(range(6))
        assert _wait(lambda: q.size() == 1)  # the sibling's marker went back
    finally:
        srv.shutdown()


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_a_streamed_clean_disconnect_mid_window_redelivers_nothing_it_consumed(server_pkg):
    """A streamed client that stops while pushes of 2 MB frames are still in
    flight: its disconnect acks what it consumed, says BYE and reads off the
    rest until the server closes. Closing at once would reset the
    connection, and a server meeting the reset on a push before it read the
    ack requeued frames the client had consumed (duplicates at the next
    consumer, nearly every time at these sizes, with either package's
    server)."""
    if server_pkg == "jax":
        from psana_ray_tpu.transport.ring import RingBuffer as Ring
        from psana_ray_tpu.transport.tcp import TcpQueueServer as Server
    else:
        Ring, Server = RingBuffer, TcpQueueServer
    frame = np.ones((8, 256, 256), np.float32)
    for _ in range(3):
        srv = Server(Ring(64), host="127.0.0.1").serve_background()
        try:
            p = TcpQueueClient("127.0.0.1", srv.port)
            for i in range(40):
                assert p.put(FrameRecord(0, i, frame, 1.0))
            a = TcpQueueClient("127.0.0.1", srv.port)
            a.stream_open(16)
            got_a = []
            while len(got_a) < 10:
                got_a += [r.event_idx for r in a.get_batch_stream(1, timeout=2.0)]
            a.disconnect()
            b = TcpQueueClient("127.0.0.1", srv.port)
            got_b = [r.event_idx for r in b.get_batch(64, timeout=2.0)]
            assert not set(got_a) & set(got_b), sorted(set(got_a) & set(got_b))
            assert sorted(got_a + got_b) == list(range(40))
            for c in (p, b):
                c.disconnect()
        finally:
            srv.shutdown()
