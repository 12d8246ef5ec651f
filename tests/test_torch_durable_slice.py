"""The ResNet slice fed from a durable worker fleet across a worker's death.

The seeded RAW frames of ``tests/test_torch_tcp_slice.py`` go through the
port's ``InfeedPipeline`` from ``python -m psana_ray_tpu_torch.queue_server
--workers 2 --durable_dir``: a windowed producer client into a named queue
that worker 1 owns, a streamed consumer client out, and ``kill -9`` of
worker 1 once the consumer has run a batch, with the producer still
sending. Both clients reconnect on their own, the supervisor forks the
worker again, and its log re-exposes what was not acked. Every event
arrives (duplicates allowed), each event's logits equal those of the
same frame fed in-process (bit for bit where a batch holds the same
frames; duplicates shift batches, so within f32 rounding otherwise), and
they stay within the fused nets' bound of the JAX package's pipeline on
the same weights.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu_torch.producer import produce  # noqa: E402
from psana_ray_tpu_torch.transport import RingBuffer  # noqa: E402
from psana_ray_tpu_torch.transport.tcp import TcpQueueClient  # noqa: E402
from psana_ray_tpu_torch.transport.workers import queue_owner  # noqa: E402
from test_torch_tcp_slice import REL_TOL, STAGES, B, N, _inputs, _jax_logits  # noqa: E402
from torch_parity import _no_lingering_child  # noqa: E402,F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS, QUEUE = "ns", "q3"  # worker 1's queue
EVENTS = 24  # event i carries frame i % N: six batches, the kill after the first


def _step(ped, gain, mask, params):
    packed = pt.pack_fused(pt.resnet_from_flax(params, STAGES, device="cpu"))
    consts = tuple(torch.from_numpy(a) for a in (ped, gain, mask))

    def step(batch):
        cal = pt.fused_calibrate(batch.frames, *consts, threshold=10.0, out_dtype=torch.bfloat16)
        return pt.resnet_fused_infer(packed, pt.panels_to_nhwc(cal), STAGES)

    return step


def _run(queue, step, on_batch=None):
    """``[(event indices, logits), ...]`` of every batch, in order."""
    batches = []

    def keep(out, batch):
        n = batch.num_valid
        batches.append((tuple(batch.event_idx[:n].tolist()), out[:n].numpy().copy()))
        if on_batch is not None:
            on_batch(len(batches))

    pt.InfeedPipeline(queue, batch_size=B, device="cpu", batcher_buffers=6,
                      max_wait_s=60.0).run(step, on_result=keep)
    return batches


def _worker_pid(log_path, wid):
    """The pid worker ``wid`` last logged (a respawn logs again)."""
    with open(log_path) as f:
        pids = [int(line.split("(pid ")[1].split(")")[0]) for line in f
                if f"worker {wid} of " in line and "(pid " in line]
    return pids[-1] if pids else None


@pytest.mark.skipif(not (hasattr(os, "fork") and os.path.isdir("/proc")),
                    reason="needs fork and /proc")
def test_durable_fleet_fed_slice_survives_a_worker_kill(tmp_path):
    assert queue_owner(NS, QUEUE, 2) == 1
    ped, gain, mask, raw, params = _inputs()
    step = _step(ped, gain, mask, params)
    ring = RingBuffer(EVENTS + 1)
    produce(((i, raw[i % N], 9.0) for i in range(EVENTS)), ring)
    reference = _run(ring, step)
    in_process = {idx: row for idxs, out in reference for idx, row in zip(idxs, out)}

    port_file = str(tmp_path / "port")
    log_path = str(tmp_path / "fleet.log")
    log = open(log_path, "w+")
    fleet = subprocess.Popen(
        [sys.executable, "-m", "psana_ray_tpu_torch.queue_server", "--workers", "2", "--host",
         "127.0.0.1", "--port", "0", "--port_file", port_file, "--durable_dir",
         str(tmp_path / "log"), "--segment_bytes", str(1 << 20), "--drain_s", "1"],
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT, env={**os.environ, "PYTHONPATH": REPO})
    killed = []
    try:
        deadline = time.monotonic() + 30
        while not os.path.exists(port_file):
            assert fleet.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        with open(port_file) as f:
            port = int(f.read())
        kw = dict(namespace=NS, queue_name=QUEUE, maxsize=2, reconnect_tries=8,
                  reconnect_base_s=0.1, put_window=2)
        producer = TcpQueueClient("127.0.0.1", port, **kw)
        consumer = TcpQueueClient("127.0.0.1", port, **kw)
        consumer.stream_open(2)

        def slow_events():
            for i in range(EVENTS):
                time.sleep(0.05)  # still sending when the worker dies
                yield i, raw[i % N], 9.0

        def kill_owner(n_batches):
            if n_batches == 1:
                killed.append(_worker_pid(log_path, 1))
                os.kill(killed[0], signal.SIGKILL)

        feed = threading.Thread(target=produce, args=(slow_events(), producer),
                                kwargs={"timeout": 60.0})
        feed.start()
        batches = _run(consumer, step, on_batch=kill_owner)
        feed.join(timeout=60)
        deadline = time.monotonic() + 20
        while _worker_pid(log_path, 1) == killed[0] and time.monotonic() < deadline:
            time.sleep(0.05)
        respawned = _worker_pid(log_path, 1)
        producer.disconnect()
        consumer.disconnect()
    finally:
        if fleet.poll() is None:
            fleet.send_signal(signal.SIGTERM)
            fleet.wait(timeout=30)
        log.seek(0)
        out = log.read()
        log.close()
    assert fleet.returncode == 0 and killed and respawned not in (None, killed[0]), out[-3000:]
    # the queue's log opened twice: at the first put, and by the new worker
    # 1 when the clients came back (its recovery line, whatever it re-exposed)
    assert out.count(f"durable queue ({NS}, {QUEUE}): recovered") == 2, out[-3000:]
    seen = {idx for idxs, _ in batches for idx in idxs}
    assert seen == set(range(EVENTS)), f"missing {sorted(set(range(EVENTS)) - seen)}"
    ref_by_batch = dict(reference)
    for idxs, logits in batches:
        if idxs in ref_by_batch:  # the same frames in the same batch: bit for bit
            assert np.array_equal(logits, ref_by_batch[idxs]), idxs
        for idx, row in zip(idxs, logits):
            np.testing.assert_allclose(row, in_process[idx], rtol=1e-5, atol=1e-6)
    ours = np.stack([in_process[i] for i in range(N)])
    ref = _jax_logits(ped, gain, mask, raw, params)
    err = float(np.max(np.abs(ref - ours)) / max(np.max(np.abs(ref)), 1e-3))
    print(f"logits rel_err {err}, deliveries {sum(len(i) for i, _ in batches)} of {EVENTS}")
    assert err < REL_TOL
