"""The port's multi-detector fan-in against the JAX package's.

The eight tests of ``tests/test_fanin.py`` on ``psana_ray_tpu_torch``'s
``FanInPipeline`` with ``device="cpu"`` legs (CPU tensors viewing the
batcher's arrays), at the same scaled-down detector shapes; the
``batcher_buffers`` floor; and parity: the same seeded RAW frames of two
detectors go through the JAX ``FanInPipeline``, whose steps run
``fused_calibrate`` (the Pallas kernel in interpret mode), and through the
port's, whose steps run the port's ``fused_calibrate`` on CPU tensors (its
plain version). Outputs are keyed by (detector, event_idx) and agree
within rtol 1e-5, atol 1e-4, K1's tolerance.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from psana_ray_tpu_torch.infeed import DetectorStream, FanInPipeline  # noqa: E402
from psana_ray_tpu_torch.records import EndOfStream, FrameRecord  # noqa: E402
from psana_ray_tpu_torch.transport import RingBuffer, TransportClosed  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EPIX_SHAPE = (2, 16, 24)  # scaled-down epix10k2M (16, 352, 384)
JF_SHAPE = (1, 32, 8)  # scaled-down jungfrau4M (8, 512, 1024)
RTOL, ATOL = 1e-5, 1e-4


def _produce(queue, shape, n, delay_s=0.0, base=0.0):
    # a closed transport is a clean producer exit, as in the JAX package's test
    try:
        for i in range(n):
            frame = np.full(shape, base + i, dtype=np.float32)
            rec = FrameRecord(0, i, frame, 9.5)
            while not queue.put(rec):
                time.sleep(0.0005)
            if delay_s:
                time.sleep(delay_s)
        assert queue.put_wait(EndOfStream(total_events=n), timeout=30.0)
    except TransportClosed:
        return


def _start_producers(specs):
    """specs: [(queue, shape, n, delay_s), ...] -> started threads."""
    threads = [threading.Thread(target=_produce, args=spec, daemon=True) for spec in specs]
    for t in threads:
        t.start()
    return threads


def _cpu_stream(name, queue, batch_size, **kw):
    return DetectorStream(name, queue, batch_size=batch_size, device="cpu",
                          poll_interval_s=0.001, **kw)


class TestFanInPipeline:
    def test_two_detectors_all_frames_one_shape_each(self):
        """The port's counterpart of the JAX test's one compile a detector:
        each step sees one batch shape, padded tails included."""
        n_epix, n_jf = 10, 25
        q_epix, q_jf = RingBuffer(maxsize=16), RingBuffer(maxsize=16)
        producers = _start_producers([(q_epix, EPIX_SHAPE, n_epix, 0.0), (q_jf, JF_SHAPE, n_jf, 0.0)])
        fan = FanInPipeline([_cpu_stream("epix10k2M", q_epix, 4),
                             _cpu_stream("jungfrau4M", q_jf, 8)])
        shapes = {"epix10k2M": set(), "jungfrau4M": set()}
        sums = {"epix10k2M": 0.0, "jungfrau4M": 0.0}

        def make_step(name):
            def step(batch):
                shapes[name].add(tuple(batch.frames.shape))
                keep = batch.valid.to(batch.frames.dtype).reshape(-1, 1, 1, 1)
                return torch.sum(batch.frames * keep)

            return step

        def on_result(name, out, batch):
            sums[name] += float(out)

        counts = fan.run({name: make_step(name) for name in shapes}, on_result=on_result,
                         block_until_ready=True)
        for t in producers:
            t.join(timeout=10.0)

        assert counts == {"epix10k2M": n_epix, "jungfrau4M": n_jf}
        assert shapes == {"epix10k2M": {(4, *EPIX_SHAPE)}, "jungfrau4M": {(8, *JF_SHAPE)}}
        # every frame's payload arrived intact (frame i is all-i)
        assert sums["epix10k2M"] == pytest.approx(sum(range(n_epix)) * np.prod(EPIX_SHAPE))
        assert sums["jungfrau4M"] == pytest.approx(sum(range(n_jf)) * np.prod(JF_SHAPE))
        assert fan.metrics["jungfrau4M"].frames == n_jf

    def test_fast_stream_not_blocked_by_slow(self):
        """Ready-ordered merge: the fast detector's whole stream completes
        while the slow producer is still trickling."""
        q_fast, q_slow = RingBuffer(maxsize=64), RingBuffer(maxsize=64)
        n_fast, n_slow = 32, 4
        producers = _start_producers([(q_fast, JF_SHAPE, n_fast, 0.0),
                                      (q_slow, EPIX_SHAPE, n_slow, 0.05)])
        fan = FanInPipeline([_cpu_stream("fast", q_fast, 8), _cpu_stream("slow", q_slow, 4)])
        order = [name for name, _ in fan]
        fan.close()
        for t in producers:
            t.join(timeout=10.0)
        last_fast = len(order) - 1 - order[::-1].index("fast")
        last_slow = len(order) - 1 - order[::-1].index("slow")
        assert last_fast < last_slow
        assert order.count("fast") == n_fast // 8

    def test_missing_step_raises(self):
        q = RingBuffer(maxsize=4)
        fan = FanInPipeline([DetectorStream("epix10k2M", q, batch_size=2, device="cpu")])
        with pytest.raises(KeyError, match="epix10k2M"):
            fan.run({"jungfrau4M": lambda b: None})
        fan.close()
        q.close()

    def test_duplicate_names_rejected(self):
        q1, q2 = RingBuffer(maxsize=4), RingBuffer(maxsize=4)
        with pytest.raises(ValueError, match="duplicate"):
            FanInPipeline([DetectorStream("d", q1, batch_size=2, device="cpu"),
                           DetectorStream("d", q2, batch_size=2, device="cpu")])
        q1.close(), q2.close()

    def test_stream_error_propagates(self):
        """A mis-shaped frame inside one stream surfaces to the consumer
        instead of hanging the loop."""
        q_ok, q_bad = RingBuffer(maxsize=16), RingBuffer(maxsize=16)
        producers = _start_producers([(q_ok, JF_SHAPE, 8, 0.0)])
        q_bad.put(FrameRecord(0, 0, np.zeros(EPIX_SHAPE, np.float32), 9.5))
        q_bad.put(FrameRecord(0, 1, np.zeros(JF_SHAPE, np.float32), 9.5))  # mismatch
        q_bad.put(EndOfStream())
        fan = FanInPipeline([_cpu_stream("ok", q_ok, 4), _cpu_stream("bad", q_bad, 4)])
        with pytest.raises(ValueError, match="locked shape"):
            fan.run({"ok": lambda b: None, "bad": lambda b: None})
        for t in producers:
            t.join(timeout=10.0)

    def test_dead_stream_surfaces_while_other_still_live(self):
        """A failed leg raises promptly although the healthy detector keeps
        streaming with no EOS in sight."""
        q_live, q_bad = RingBuffer(maxsize=64), RingBuffer(maxsize=64)
        stop = threading.Event()

        def trickle():
            i = 0
            while not stop.is_set():
                try:
                    q_live.put(FrameRecord(0, i, np.zeros(JF_SHAPE, np.float32), 9.5))
                except TransportClosed:
                    return
                i += 1
                time.sleep(0.002)

        live_thread = threading.Thread(target=trickle, daemon=True)
        live_thread.start()
        q_bad.put(FrameRecord(0, 0, np.zeros(EPIX_SHAPE, np.float32), 9.5))
        q_bad.put(FrameRecord(0, 1, np.zeros(JF_SHAPE, np.float32), 9.5))  # mismatch
        fan = FanInPipeline([_cpu_stream("live", q_live, 4), _cpu_stream("bad", q_bad, 4)])
        t0 = time.monotonic()
        with pytest.raises(ValueError, match="locked shape"):
            fan.run({"live": lambda b: None, "bad": lambda b: None})
        assert time.monotonic() - t0 < 10.0
        stop.set()
        live_thread.join(timeout=5.0)
        assert not live_thread.is_alive()
        q_live.close()

    def test_cross_thread_close_unblocks_starved_consumer(self):
        """close() from a watchdog thread wakes a consumer blocked on the
        merge queue and stops a leg parked in a starved transport poll."""
        q = RingBuffer(maxsize=8)
        fan = FanInPipeline([_cpu_stream("d", q, 2)])
        seen = []
        consumer = threading.Thread(target=lambda: seen.extend(iter(fan)), daemon=True)
        consumer.start()
        time.sleep(0.1)
        t0 = time.monotonic()
        fan.close()
        consumer.join(timeout=5.0)
        assert not consumer.is_alive()
        assert time.monotonic() - t0 < 2.0
        for th in fan._threads:
            assert not th.is_alive()
        assert seen == []
        q.close()

    def test_early_close_joins_threads(self):
        q = RingBuffer(maxsize=8)
        producers = _start_producers([(q, JF_SHAPE, 64, 0.0)])
        fan = FanInPipeline([_cpu_stream("d", q, 4)])
        it = iter(fan)
        next(it)
        fan.close()
        for t in fan._threads:
            assert not t.is_alive()
        q.close()
        for t in producers:
            t.join(timeout=10.0)
            assert not t.is_alive()


def test_batcher_buffers_floor_matches_the_jax_package():
    """Pooled arenas must outnumber the batches a leg can have alive: its
    prefetch queue, every merge slot, the consumer's, the one filling, the
    batch source's deferred one and a margin. Both packages refuse the
    same counts with the same floor."""
    from psana_ray_tpu.infeed import DetectorStream as JaxStream
    from psana_ray_tpu.infeed import FanInPipeline as JaxFanIn
    from psana_ray_tpu.transport import RingBuffer as JaxRing

    for merge_depth, n_legs, prefetch in ((2, 2, 2), (1, 3, 1), (3, 1, 2)):
        floor = prefetch + merge_depth * n_legs + 4
        port_qs = [RingBuffer(maxsize=4) for _ in range(n_legs)]
        jax_qs = [JaxRing(maxsize=4) for _ in range(n_legs)]
        for buffers in (floor - 1, 1):
            with pytest.raises(ValueError, match=f"merge capacity \\+ 4 = {floor}"):
                FanInPipeline([DetectorStream(f"d{i}", q, 2, device="cpu", prefetch_depth=prefetch,
                                              batcher_buffers=buffers)
                               for i, q in enumerate(port_qs)], merge_depth=merge_depth)
            with pytest.raises(ValueError, match=f"merge capacity \\+ 4 = {floor}"):
                JaxFanIn([JaxStream(f"d{i}", q, 2, prefetch_depth=prefetch,
                                    batcher_buffers=buffers, place_on_device=False)
                          for i, q in enumerate(jax_qs)], merge_depth=merge_depth)
        fan = FanInPipeline([DetectorStream(f"d{i}", q, 2, device="cpu", prefetch_depth=prefetch,
                                            batcher_buffers=floor)
                             for i, q in enumerate(port_qs)], merge_depth=merge_depth)
        fan.close()
        for q in port_qs + jax_qs:
            q.close()


def _calib_constants(rng, shape):
    p, h, w = shape
    ped = (100.0 + 3.0 * rng.standard_normal(shape)).astype(np.float32)
    gain = (1.0 + 0.02 * rng.standard_normal(shape)).astype(np.float32)
    mask = (rng.random(shape) > 0.05).astype(np.uint8)
    return ped, gain, mask


def _raw_events(rng, shape, ped, gain, n):
    """RAW ADUs with photons above the common-mode threshold and a
    per-panel common mode."""
    photons = rng.poisson(0.1, (n, *shape)).astype(np.float32)
    cm = rng.uniform(-8.0, 8.0, (n, shape[0], 1, 1)).astype(np.float32)
    raw = ped + 35.0 * photons * gain + cm + 2.5 * rng.standard_normal((n, *shape))
    return raw.astype(np.float32)


def test_calibrated_outputs_match_the_jax_fan_in():
    from psana_ray_tpu.infeed import DetectorStream as JaxStream
    from psana_ray_tpu.infeed import FanInPipeline as JaxFanIn
    from psana_ray_tpu.ops.pallas_calib import fused_calibrate as jax_fused
    from psana_ray_tpu.records import EndOfStream as JaxEos
    from psana_ray_tpu.records import FrameRecord as JaxRecord
    from psana_ray_tpu.transport import RingBuffer as JaxRing
    from psana_ray_tpu_torch.ops import fused_calibrate

    rng = np.random.default_rng(11)
    legs = {"epix10k2M": (EPIX_SHAPE, 4, 10), "jungfrau4M": (JF_SHAPE, 8, 20)}
    consts, events = {}, {}
    for name, (shape, _, n) in legs.items():
        consts[name] = _calib_constants(rng, shape)
        events[name] = _raw_events(rng, shape, *consts[name][:2], n)

    def fill(ring_cls, rec_cls, eos_cls, name):
        ring = ring_cls(maxsize=len(events[name]) + 1)
        for i, frame in enumerate(events[name]):
            assert ring.put(rec_cls(0, i, frame, 9.5))
        assert ring.put(eos_cls(total_events=len(events[name])))
        return ring

    def collect(out_of, steps_of):
        got = {}

        def on_result(name, out, batch):
            out = out_of(out)
            for row, idx in enumerate(np.asarray(batch.event_idx)[:batch.num_valid]):
                got[(name, int(idx))] = out[row]

        return got, on_result

    # the JAX package: fused_calibrate (Pallas, interpret mode) a detector
    jsteps = {name: (lambda batch, c=tuple(map(jnp.asarray, consts[name])):
                     jax_fused(batch.frames, *c, threshold=10.0)) for name in legs}
    jfan = JaxFanIn([JaxStream(name, fill(JaxRing, JaxRecord, JaxEos, name), b,
                               poll_interval_s=0.001) for name, (_, b, _) in legs.items()])
    jgot, on_j = collect(np.asarray, jsteps)
    assert jfan.run(jsteps, on_result=on_j, block_until_ready=True) == {
        name: n for name, (_, _, n) in legs.items()}

    # the port: fused_calibrate on CPU tensors (its plain version) a detector
    tsteps = {name: (lambda batch, c=tuple(torch.from_numpy(a) for a in consts[name]):
                     fused_calibrate(batch.frames, *c, threshold=10.0)) for name in legs}
    tfan = FanInPipeline([_cpu_stream(name, fill(RingBuffer, FrameRecord, EndOfStream, name), b)
                          for name, (_, b, _) in legs.items()])
    tgot, on_t = collect(lambda t: t.numpy(), tsteps)
    assert tfan.run(tsteps, on_result=on_t) == {name: n for name, (_, _, n) in legs.items()}

    assert sorted(tgot) == sorted(jgot) == sorted(
        (name, i) for name, (_, _, n) in legs.items() for i in range(n))
    worst = 0.0
    for key, ref in jgot.items():
        got = tgot[key]
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
        worst = max(worst, float(np.abs(got - ref).max()))
    print(f"max_abs_err {worst}")  # observed values: pytest -rP
    # the calibration did something: photons came out far from the raw ADUs
    assert max(float(np.abs(v).max()) for v in tgot.values()) > 20.0
