#!/usr/bin/env python3
"""The queue server's relay rate with one worker and with a fleet, for one
queue and for several.

Run from the root of a checkout (no card needed; the numbers in PERF.md
come from the H100 machine):

    python3 tools/fleet_relay.py [--frames 128] [--rounds 2]

For each arrangement the port's queue server program runs on 127.0.0.1
with memory queues and ``--workers`` 1 or 2; each queue gets a producer
process (windowed puts of seeded epix10k2M-sized f32 frames) and a
consumer process draining a push stream and releasing each frame. The
queues are ``ns/q0`` and ``ns/q3``, which a two-worker fleet pins to
workers 0 and 1. Arrangements run in turns (1 worker, 2, 2, 1 a round)
and each prints one JSON line: the aggregate frames/s (the frames each
consumer took after the first 40, a queue's depth, over the span from the
first such arrival to the last) and GB/s.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPE = (16, 352, 384)
QUEUES = ("q0", "q3")
SKIP = 40  # frames a queue holds: a producer may fill it before its consumer comes


def _produce(port, name, n):
    import numpy as np

    from psana_ray_tpu_torch.producer import produce
    from psana_ray_tpu_torch.transport.tcp import TcpQueueClient

    rng = np.random.default_rng(0)
    frames = [rng.normal(100.0, 3.0, SHAPE).astype(np.float32) for _ in range(4)]
    c = TcpQueueClient("127.0.0.1", port, namespace="ns", queue_name=name, maxsize=40)
    produce(((i, frames[i % 4], 1.0) for i in range(n)), c, timeout=120.0)
    c.disconnect()


def _consume(port, name, n, out):
    from psana_ray_tpu_torch.records import EndOfStream
    from psana_ray_tpu_torch.transport.tcp import TcpQueueClient

    c = TcpQueueClient("127.0.0.1", port, namespace="ns", queue_name=name, maxsize=40)
    c.stream_open(32)
    got, t0, t1 = 0, None, None
    while True:
        batch = c.get_batch_stream(32, timeout=60.0)
        if not batch:
            raise RuntimeError(f"{name}: nothing for 60 s after {got} frames")
        now = time.perf_counter()
        for item in batch:
            if isinstance(item, EndOfStream):
                c.disconnect()
                out.put((name, got - SKIP, t1 - t0, t0, t1))
                return
            if got == SKIP:  # the clock starts past the queue's depth
                t0 = now
            t1 = now
            item.release()
            got += 1


def run(workers, n_queues, n):
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        port_file = os.path.join(tmp, "port")
        server = subprocess.Popen(
            [sys.executable, "-m", "psana_ray_tpu_torch.queue_server", "--host", "127.0.0.1",
             "--port", "0", "--port_file", port_file, "--queue_size", "40", "--workers",
             str(workers), "--drain_s", "1", "--log_level", "WARNING"],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT})
        try:
            while not os.path.exists(port_file):
                if server.poll() is not None:
                    raise RuntimeError("the queue server did not start")
                time.sleep(0.05)
            with open(port_file) as f:
                port = int(f.read())
            out = ctx.Queue()
            procs = []
            for name in QUEUES[:n_queues]:
                procs.append(ctx.Process(target=_consume, args=(port, name, n, out)))
                procs.append(ctx.Process(target=_produce, args=(port, name, n)))
            for p in procs:
                p.start()
            results = [out.get(timeout=300) for _ in range(n_queues)]
            for p in procs:
                p.join(timeout=60)
            if any(p.exitcode != 0 for p in procs) or any(r[1] != n - SKIP for r in results):
                raise RuntimeError(f"a producer or consumer failed: {results}")
        finally:
            server.terminate()
            server.wait(timeout=60)
    span = max(r[4] for r in results) - min(r[3] for r in results)
    fps = sum(r[1] for r in results) / span
    nbytes = 4 * SHAPE[0] * SHAPE[1] * SHAPE[2]
    return {"workers": workers, "queues": n_queues, "frames_per_queue": n,
            "timed_frames_per_queue": n - SKIP, "frames_per_s": fps,
            "gbytes_per_s": fps * nbytes / 1e9,
            "per_queue_frames_per_s": {r[0]: r[1] / r[2] for r in results}}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=128)
    p.add_argument("--rounds", type=int, default=2)
    a = p.parse_args()
    for n_queues in (1, 2):
        for _ in range(a.rounds):
            for workers in (1, 2, 2, 1):
                print(json.dumps(run(workers, n_queues, a.frames)), flush=True)


if __name__ == "__main__":
    main()
