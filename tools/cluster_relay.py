#!/usr/bin/env python3
"""The relay rate of one queue server against a cluster of two, for one
logical queue, with no card work.

Run from the root of a checkout (the numbers in PERF.md come from the
H100 machine):

    python3 tools/cluster_relay.py [--frames 256] [--rounds 2]

Arrangements, each in its own processes on 127.0.0.1 with memory queues
(``chip_smoke.py``'s shapes): ``tcp``, one queue server (``--queue_size
40``) and a consumer on a push stream of 32 credits; ``cluster``, two
queue servers (``--queue_size 16``) and the logical queue in 4
partitions, two on each server, read by a ``ClusterClient`` streaming
each partition with 32 credits; ``cluster_w8``, the same with 8 credits a
partition (32 in all, as ``tcp``). A producer process sends seeded
epix10k2M-sized f32 frames with windowed puts; the consumer releases each
frame. Arrangements run in turns (``tcp``, ``cluster``, ``cluster_w8``,
then the reverse, a round) and each prints one JSON line: frames/s over
the frames after the first ``SKIP`` (what the queues can hold) and GB/s.
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
PARTITIONS = 4
SKIP = 64  # frames the queues hold: the producer may fill them before the consumer comes


def _queue(arrangement, addrs, window=None):
    """The producer's (``window`` None) or the consumer's handle."""
    if arrangement == "tcp":
        from psana_ray_tpu_torch.transport.tcp import TcpQueueClient

        host, port = addrs[0].split(":")
        c = TcpQueueClient(host, int(port), namespace="default", queue_name="relay",
                           maxsize=40)
    else:
        from psana_ray_tpu_torch.cluster import ClusterClient

        c = ClusterClient(addrs, queue_name=_even_queue(addrs), n_partitions=PARTITIONS,
                          maxsize=16)
    if window is not None:
        c.stream_open(window)
    return c


def _even_queue(addrs):
    """The first queue name ``relay_<i>`` with two partitions on each server."""
    from psana_ray_tpu_torch.cluster import PartitionMap

    for i in range(4096):
        m = PartitionMap.compute(addrs, f"relay_{i}", PARTITIONS)
        if all(len(m.partitions_on(a)) == PARTITIONS // len(addrs) for a in addrs):
            return m.queue_name
    raise RuntimeError(f"no even placement over {addrs}")


def _produce(arrangement, addrs, n):
    import numpy as np

    from psana_ray_tpu_torch.producer import produce

    rng = np.random.default_rng(0)
    frames = [rng.normal(100.0, 3.0, SHAPE).astype(np.float32) for _ in range(4)]
    c = _queue(arrangement, addrs)
    produce(((i, frames[i % 4], 1.0) for i in range(n)), c, timeout=120.0)
    c.disconnect()


def _consume(arrangement, addrs, window, out):
    from psana_ray_tpu_torch.records import EndOfStream

    c = _queue(arrangement, addrs, window)
    got, t0, t1 = 0, None, None
    while True:
        batch = c.get_batch_stream(32, timeout=60.0)
        if not batch:
            raise RuntimeError(f"nothing for 60 s after {got} frames")
        now = time.perf_counter()
        for item in batch:
            if isinstance(item, EndOfStream):
                c.disconnect()
                out.put((got - SKIP, t1 - t0))
                return
            if got == SKIP:
                t0 = now
            t1 = now
            item.release()
            got += 1


def _server(tmp, tag, queue_size):
    port_file = os.path.join(tmp, f"{tag}.port")
    proc = subprocess.Popen(
        [sys.executable, "-m", "psana_ray_tpu_torch.queue_server", "--host", "127.0.0.1",
         "--port", "0", "--port_file", port_file, "--queue_size", str(queue_size), "--drain_s",
         "1", "--log_level", "WARNING"], cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT})
    while not os.path.exists(port_file):
        if proc.poll() is not None:
            raise RuntimeError("a queue server did not start")
        time.sleep(0.05)
    with open(port_file) as f:
        return proc, f"127.0.0.1:{int(f.read())}"


def run(arrangement, n):
    ctx = mp.get_context("spawn")
    window = {"tcp": 32, "cluster": 32, "cluster_w8": 8}[arrangement]
    servers = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for k in range(1 if arrangement == "tcp" else 2):
                servers.append(_server(tmp, f"s{k}", 40 if arrangement == "tcp" else 16))
            addrs = [a for _, a in servers]
            out = ctx.Queue()
            procs = [ctx.Process(target=_consume, args=(arrangement, addrs, window, out)),
                     ctx.Process(target=_produce, args=(arrangement, addrs, n))]
            for p in procs:
                p.start()
            timed, span = out.get(timeout=300)
            for p in procs:
                p.join(timeout=60)
            if any(p.exitcode != 0 for p in procs) or timed != n - SKIP:
                raise RuntimeError(f"a producer or consumer failed: {timed} of {n - SKIP}")
        finally:
            for proc, _ in servers:
                proc.terminate()
                proc.wait(timeout=60)
    fps = timed / span
    return {"arrangement": arrangement, "servers": len(servers), "window": window,
            "frames": n, "timed_frames": timed, "frames_per_s": fps,
            "gbytes_per_s": fps * 4 * SHAPE[0] * SHAPE[1] * SHAPE[2] / 1e9}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=256)
    p.add_argument("--rounds", type=int, default=2)
    a = p.parse_args()
    order = ("tcp", "cluster", "cluster_w8")
    for _ in range(a.rounds):
        for arrangement in (*order, *reversed(order)):
            print(json.dumps(run(arrangement, a.frames)), flush=True)


if __name__ == "__main__":
    main()
