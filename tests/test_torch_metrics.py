"""The port's one ``PipelineMetrics`` against the JAX package's: the same
observations on the same clock give the same ``status_line`` and
``snapshot``; the infeed's warm-up, copy counts and ``summary()`` ride on
the same class; the meters read as integers; and ``RingBuffer.stats()``
gives the JAX ring's counters."""

import time

import pytest

pytest.importorskip("torch")

from psana_ray_tpu.transport import RingBuffer as JaxRing  # noqa: E402
from psana_ray_tpu.utils import metrics as jax_metrics  # noqa: E402
from psana_ray_tpu_torch import infeed  # noqa: E402
from psana_ray_tpu_torch.utils import metrics  # noqa: E402
from psana_ray_tpu_torch.transport import RingBuffer  # noqa: E402


class _Clock:
    """A monotonic clock that moves only when a test steps it."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _observe(cls, ring, clock):
    """A PipelineMetrics made and fed at the same clock readings every
    time; returns its status line and snapshot, read at the end."""
    clock.t = 1000.0
    m = cls()
    m.attach_queue(ring)
    for i in range(40):
        clock.t += 0.001
        m.observe_frame(1000 + i)
    for i in range(9):
        clock.t += 0.01
        m.observe_batch(4, 0.002 * (i + 1), nbytes=4096)
    m.observe_batch(0, 0.5)
    for s, sec in (("enqueue", 0.003), ("queue_dwell", 0.02), ("enqueue", 0.004)):
        m.stages.observe(s, sec)
    m.stages.observe("dispatch", 0.3, exemplar=0xABC)
    clock.t += 0.5
    return m, m.status_line(), m.snapshot()


@pytest.mark.parametrize("with_queue", [False, True])
def test_status_line_and_snapshot_equal_the_jax_class(monkeypatch, with_queue):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    ring = RingBuffer(8)
    for i in range(3):
        ring.put(i)
    q = ring if with_queue else None
    ours, line, snap = _observe(metrics.PipelineMetrics, q, clock)
    theirs, jax_line, jax_snap = _observe(jax_metrics.PipelineMetrics, q, clock)
    assert ours.has_queue == theirs.has_queue == with_queue
    assert line == jax_line
    assert snap == jax_snap
    assert ("depth=3" in line) == with_queue
    assert ours.frames.count == 76 and ours.batches.count == 10


def test_meters_read_as_integers():
    m = metrics.PipelineMetrics()
    m.observe_batch(3, 0.01, nbytes=12)
    assert m.frames == 3 and m.bytes == 12 and m.batches == 1
    assert int(m.frames) + 1 == 4
    assert m.frames != 4 and m.frames != "3"


def test_warmup_copies_and_summary():
    m = metrics.PipelineMetrics(warmup=2)
    for i in range(5):
        m.observe_host(0.01, 0.002)
        m.observe_copies(4, 400, from_arena=i % 2 == 0)
        m.observe_batch(4, 0.01 * (i + 1), nbytes=400)
    s = m.summary()
    assert (s["frames"], s["batches"], s["bytes"]) == (12, 3, 1200)  # warm-up left out
    assert m.staged == 3 and m.staged_frames == 20 and s["arena_copies"] == 3
    assert s["host_frame_bytes_per_frame"] == 100.0
    assert s["host_batch_ms"] == pytest.approx(10.0) and s["host_stage_ms"] == pytest.approx(2.0)
    assert s["p50_ms"] == pytest.approx(40.0) and s["fps"] > 0
    assert list(m.latencies_s) == pytest.approx([0.03, 0.04, 0.05])
    assert infeed.PipelineMetrics is metrics.PipelineMetrics
    import psana_ray_tpu_torch as pt

    assert pt.PipelineMetrics is metrics.PipelineMetrics


def test_ring_stats_equal_the_jax_ring(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    ours, theirs = RingBuffer(3), JaxRing(3)
    stats = []
    for q in (ours, theirs):
        clock.t = 1000.0
        for i in range(4):
            clock.t += 0.001
            q.put(i)  # the fourth is rejected
        clock.t += 0.002
        q.get()
        q.get_batch(5)
        clock.t += 0.004
        q.put_wait(7, timeout=0.1)
        clock.t += 0.008
        q.get_wait(timeout=0.1)
        clock.t += 0.016
        stats.append(q.stats())
    a, b = stats
    assert set(a) == set(b) - {"draining"}  # the port's ring has no drain mode
    assert a == {k: b[k] for k in a}
    assert a["puts"] == 4 and a["gets"] == 4 and a["puts_rejected"] == 1 and a["high_water"] == 3
    fresh = RingBuffer(2).stats()
    assert fresh["last_put_age_s"] == fresh["last_get_age_s"] == -1.0
    assert metrics.probe_queue_stats(ours) == a
