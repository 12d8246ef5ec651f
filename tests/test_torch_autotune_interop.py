"""The port's live transport and durability dials against the JAX package's.

Both ways over TCP: the port's ``TcpQueueClient`` against the JAX
package's ``TcpQueueServer``, and the JAX client against the port's
server. ``set_put_window`` resizes the windowed-put pipeline with puts in
flight (every frame arrives once, in order); ``set_stream_window`` sends a
live 'M' that the server applies (its ``stream_resize`` breadcrumb, and
more frames in flight than the subscribe-time window), and a replay
connection refuses it; ``renegotiate_codec`` turns ``shuffle-rle`` on and
off with a fresh 'Z' exchange while windowed puts are unacked (their acks
drain first), frames crossing bit-identical each way, and is refused on a
streamed connection and a no-op once a peer's refusal was latched. Then
the host-plane dials of both packages on the same operations:
``SegmentLog.set_fsync_batch_n`` (fsyncs counted), ``DurableRingBuffer.
set_ram_items`` (what spills), ``BufferPool.set_min_per_class`` (what
the pool keeps), the infeed's prefetch depth (clipped to the arena bound)
and ``DrainControl`` (the pop sizes and the batches).
"""

import time

import numpy as np
import pytest

pytest.importorskip("torch")

from psana_ray_tpu.obs.flight import FLIGHT as JAX_FLIGHT  # noqa: E402
from psana_ray_tpu.records import FrameRecord as JaxRecord  # noqa: E402
from psana_ray_tpu.transport import tcp as jax_tcp  # noqa: E402
from psana_ray_tpu.transport.ring import RingBuffer as JaxRing  # noqa: E402
from psana_ray_tpu_torch.obs.flight import FLIGHT  # noqa: E402
from psana_ray_tpu_torch.records import FrameRecord  # noqa: E402
from psana_ray_tpu_torch.transport import tcp as port_tcp  # noqa: E402
from psana_ray_tpu_torch.transport.ring import RingBuffer  # noqa: E402
from torch_parity import _no_lingering_child  # noqa: E402,F401 (autouse)

FAST = dict(reconnect_tries=3, reconnect_base_s=0.05)
# (server module, its ring, its flight recorder, client module, the client's records)
PAIRS = {
    "jax_server-port_client": (jax_tcp, JaxRing, JAX_FLIGHT, port_tcp, FrameRecord),
    "port_server-jax_client": (port_tcp, RingBuffer, FLIGHT, jax_tcp, JaxRecord),
}


@pytest.fixture(params=sorted(PAIRS))
def pair(request):
    srv_mod, ring, flight, cli_mod, rec = PAIRS[request.param]
    q = ring(64)
    srv = srv_mod.TcpQueueServer(q, host="127.0.0.1").serve_background()
    clients = []

    def client(**kw):
        c = cli_mod.TcpQueueClient("127.0.0.1", srv.port, timeout_s=10.0, **{**FAST, **kw})
        clients.append(c)
        return c

    yield q, srv, flight, client, rec
    for c in clients:
        try:
            c.disconnect()
        except Exception:  # noqa: BLE001 (already closed by the test)
            pass
    srv.close_all()
    srv.shutdown()


def _frames(rec, n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    base = rng.normal(1000.0, 4.0, (2, 24, 32))
    return [rec(0, i, (base + rng.normal(0.0, 3.0, base.shape)).astype(dtype), 9.5 + i)
            for i in range(n)]


def _release(items):
    for r in items:
        release = getattr(r, "release", None)
        if release is not None:
            release()


def _breadcrumbs(flight, kind, mark):
    new = flight.count_of(kind) - mark
    evs = [e for e in flight.events() if e["kind"] == kind]
    return evs[-new:] if new > 0 else []


def test_put_window_resizes_with_puts_in_flight(pair):
    q, srv, flight, client, rec = pair
    c = client(put_window=2)
    assert c.put_window == 2
    frames = _frames(rec, 30)
    for i, r in enumerate(frames):
        if i == 10:
            c.set_put_window(7)  # grow with puts unacked
            assert c.put_window == 7
        if i == 20:
            c.set_put_window(0)  # floored at 1: the next put waits for every ack
            assert c.put_window == 1
        assert c.put_pipelined(r)
    assert c.flush_puts(time.monotonic() + 10)
    got = q.get_batch(64)
    assert [r.event_idx for r in got] == list(range(30))
    assert all(np.array_equal(a.panels, b.panels) for a, b in zip(got, frames))
    _release(got)


def test_stream_window_resizes_live_with_an_m(pair):
    q, srv, flight, client, rec = pair
    c = client()
    with pytest.raises(RuntimeError, match="stream subscription"):
        c.set_stream_window(16)
    c.stream_open(window=4)
    assert c.stream_window == 4
    mark = flight.count_of("stream_resize")
    assert c.set_stream_window(48) and c.stream_window == 48
    assert c.set_stream_window(48)  # unchanged: nothing sent
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not _breadcrumbs(flight, "stream_resize", mark):
        time.sleep(0.01)
    evs = _breadcrumbs(flight, "stream_resize", mark)
    assert len(evs) == 1 and (evs[0]["old"], evs[0]["window"]) == (4, 48)
    for r in _frames(rec, 12):
        assert q.put(r)
    got = []
    deadline = time.monotonic() + 10
    while len(got) < 12 and time.monotonic() < deadline:
        got.extend(c.get_batch_stream(12 - len(got), timeout=0.5))
    # twelve in flight without an ack: more than the subscribe-time window
    assert [r.event_idx for r in got] == list(range(12))
    _release(got)


def _durable_pair(tmp_path, server_pkg):
    import importlib

    storage = importlib.import_module(f"{server_pkg}.storage")
    tcp = importlib.import_module(f"{server_pkg}.transport.tcp")
    log = storage.SegmentLog(str(tmp_path / server_pkg), segment_bytes=1 << 20)
    q = storage.DurableRingBuffer(log, maxsize=16)
    return log, tcp.TcpQueueServer(q, host="127.0.0.1").serve_background()


@pytest.mark.parametrize("server_pkg,client_mod,rec",
                         [("psana_ray_tpu", port_tcp, FrameRecord),
                          ("psana_ray_tpu_torch", jax_tcp, JaxRecord)])
def test_a_replay_connection_refuses_the_stream_window(tmp_path, server_pkg, client_mod, rec):
    log, srv = _durable_pair(tmp_path, server_pkg)
    c = client_mod.TcpQueueClient("127.0.0.1", srv.port, timeout_s=10.0, **FAST)
    try:
        assert c.put(_frames(rec, 1)[0])
        c.replay_open("begin", group="audit")
        with pytest.raises(RuntimeError, match="replay"):
            c.set_stream_window(8)
        got = c.get_batch(4, timeout=2.0)  # the connection still reads
        assert [r.event_idx for r in got] == [0]
        _release(got)
    finally:
        c.disconnect()
        srv.close_all()
        srv.shutdown()
        log.close()


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_renegotiate_codec_on_and_off_with_puts_unacked(pair, dtype):
    q, srv, flight, client, rec = pair
    c = client(put_window=8)
    assert c.codec_name is None
    frames = _frames(rec, 12, seed=3, dtype=dtype)
    for r in frames[:4]:  # unacked when the 'Z' goes out: their acks drain first
        assert c.put_pipelined(r)
    assert c.renegotiate_codec(["shuffle-rle"]) is True
    assert c.codec_name == "shuffle-rle"
    assert q.size() == 4
    for r in frames[4:8]:
        assert c.put_pipelined(r)
    assert c.renegotiate_codec(None) is False  # back to raw
    assert c.codec_name is None
    for r in frames[8:]:
        assert c.put(r)
    got = q.get_batch(64)
    assert [r.event_idx for r in got] == list(range(12))
    assert all(np.array_equal(a.panels, b.panels) and a.panels.dtype == b.panels.dtype
               for a, b in zip(got, frames))
    _release(got)
    with pytest.raises(ValueError):
        c.renegotiate_codec(["no-such-codec"])
    c._codec_refused = True  # the latch an old peer's refusal sets
    assert c.renegotiate_codec(["shuffle-rle"]) is False and c.codec_name is None


def test_renegotiate_codec_is_refused_on_a_streamed_connection(pair):
    q, srv, flight, client, rec = pair
    c = client()
    c.stream_open(window=4)
    with pytest.raises(RuntimeError, match="streamed"):
        c.renegotiate_codec(["shuffle-rle"])


def test_the_knob_factories_turn_a_live_client(pair):
    from psana_ray_tpu_torch.autotune.knobs import put_window_knob, wire_codec_knob

    q, srv, flight, client, rec = pair
    c = client()
    k = put_window_knob(c)
    k.set(k.clamp(40))
    assert c.put_window == 40
    ck = wire_codec_knob(c)
    assert ck.get() == 0.0
    ck.set(1.0)
    assert ck.get() == 1.0 and c.codec_name is not None
    assert c.put(_frames(rec, 1)[0])
    ck.set(0.0)
    assert ck.get() == 0.0
    got = q.get_batch(4)
    assert len(got) == 1
    _release(got)


# -- the host-plane dials of both packages on the same operations -------------

def _pkg(name):
    import importlib

    return {m: importlib.import_module(f"{name}.{m}") for m in
            ("storage", "records", "utils.bufpool", "transport.ring", "infeed.batcher")}


PKGS = ("psana_ray_tpu", "psana_ray_tpu_torch")


def test_fsync_batch_dial_alike(tmp_path):
    out = {}
    for name in PKGS:
        p = _pkg(name)
        storage, records = p["storage"], p["records"]
        log = storage.SegmentLog(str(tmp_path / name), segment_bytes=1 << 20, fsync="batch",
                                 fsync_batch_n=8)
        before = storage.DURABLE.stats()["fsyncs_total"]
        counts = []
        for i in range(40):
            if i == 10:
                log.set_fsync_batch_n(3)
            if i == 25:
                log.set_fsync_batch_n(0)  # floored at 1: every append
            log.append(records.FrameRecord(0, i, np.zeros((1, 2, 2), np.float32), 1.0))
            counts.append(storage.DURABLE.stats()["fsyncs_total"] - before)
        out[name] = (counts, log.fsync_batch_n)
        log.close()
    assert out["psana_ray_tpu_torch"] == out["psana_ray_tpu"]
    assert out["psana_ray_tpu"][1] == 1


def test_ram_items_dial_alike(tmp_path):
    out = {}
    for name in PKGS:
        p = _pkg(name)
        storage, records = p["storage"], p["records"]
        log = storage.SegmentLog(str(tmp_path / name), segment_bytes=1 << 20)
        q = storage.DurableRingBuffer(log, maxsize=32, ram_items=8)
        spills = []
        for i in range(20):
            if i == 4:
                q.set_ram_items(2)  # later puts spill; the resident stay
            if i == 12:
                q.set_ram_items(16)
            q.put(records.FrameRecord(0, i, np.full((1, 2, 2), i, np.float32), 1.0))
            spills.append(q._spilled)
        got = [getattr(r, "materialize", lambda r=r: r)().event_idx for r in q.get_batch(32)]
        out[name] = (spills, q.ram_items, got)
        log.close()
    assert out["psana_ray_tpu_torch"] == out["psana_ray_tpu"]
    assert out["psana_ray_tpu"][2] == list(range(20))


def test_bufpool_retention_dial_alike():
    out = {}
    for name in PKGS:
        pool = _pkg(name)["utils.bufpool"].BufferPool(min_per_class=1)
        kept = []
        for floor in (6, 2, 0, 9):
            pool.set_min_per_class(floor)
            leases = [pool.lease(4096) for _ in range(5)]
            for lease in leases:
                lease.release()
            kept.append(pool.stats()["bytes_pooled"])
        out[name] = (kept, pool.min_per_class)
    assert out["psana_ray_tpu_torch"] == out["psana_ray_tpu"]


def test_prefetch_depth_dial_clips_to_the_arena_bound_alike():
    from psana_ray_tpu.infeed.pipeline import InfeedPipeline as JaxPipeline
    from psana_ray_tpu_torch.infeed.pipeline import InfeedPipeline

    jq, pq = JaxRing(4), RingBuffer(4)
    jax_pipe = JaxPipeline(jq, batch_size=2, prefetch_depth=2, place_on_device=False,
                           batcher_buffers=8)
    port_pipe = InfeedPipeline(pq, batch_size=2, device="cpu", prefetch_depth=2,
                               batcher_buffers=8)
    try:
        for n in (99, 1, 3, 0):
            assert port_pipe.set_prefetch_depth(n) == jax_pipe.set_prefetch_depth(n)
            assert port_pipe.prefetch_depth == jax_pipe.prefetch_depth
    finally:
        jax_pipe.close()
        port_pipe.close()
        jq.close()
        pq.close()


@pytest.mark.parametrize("chunk,poll_s", [(1, 0.001), (3, None), (None, 0.002)])
def test_drain_control_dials_alike(chunk, poll_s):
    out = {}
    for name in PKGS:
        p = _pkg(name)
        q = p["transport.ring"].RingBuffer(32)
        for i in range(11):
            q.put(p["records"].FrameRecord(0, i, np.full((1, 2, 2), i, np.float32), 1.0))
        q.put(p["records"].EndOfStream(total_events=11))
        pops = []
        real = q.get_batch

        def spy(max_items, timeout=None, _real=real):
            pops.append(max_items)
            return _real(max_items, timeout=timeout)

        q.get_batch = spy
        control = p["infeed.batcher"].DrainControl(chunk=chunk, poll_s=poll_s)
        batches = [(b.num_valid, np.asarray(b.event_idx).tolist())
                   for b in p["infeed.batcher"].batches_from_queue(q, 4, control=control)]
        out[name] = (pops, batches)
    assert out["psana_ray_tpu_torch"] == out["psana_ray_tpu"]
    assert set(out["psana_ray_tpu"][0]) == {chunk or 4}


def test_set_stream_window_across_a_reconnect_resubscribes_at_the_new_window(pair):
    """The window is set before the 'M' goes out: a connection that died
    under it reconnects and subscribes again at the new window, and the
    stream goes on with every frame once."""
    q, srv, flight, client, rec = pair
    c = client()
    mark = flight.count_of("stream_open")
    c.stream_open(window=4)

    def opened(window):
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if any(e["window"] == window for e in _breadcrumbs(flight, "stream_open", mark)):
                return True
            time.sleep(0.01)
        return False

    assert opened(4)  # the server took the first subscription
    c._sock.shutdown(2)  # the link dies under the client: the 'M' fails
    assert c.set_stream_window(24) and c.stream_window == 24
    assert opened(24)  # resubscribed at the new window
    for r in _frames(rec, 10):
        assert q.put(r)
    got = []
    deadline = time.monotonic() + 10
    while len(got) < 10 and time.monotonic() < deadline:
        got.extend(c.get_batch_stream(10 - len(got), timeout=0.5))
    assert [r.event_idx for r in got] == list(range(10))
    _release(got)
