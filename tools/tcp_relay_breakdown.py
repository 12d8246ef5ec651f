#!/usr/bin/env python3
"""Where a frame's time goes on the TCP relay, on one host.

Run from the root of a checkout (no card needed; the numbers in PERF.md
come from the H100 machine):

    python3 tools/tcp_relay_breakdown.py [--frames 256] [--frame_mb 8.65]

Frames are f32 arrays of ``--frame_mb`` megabytes (epix10k2M's 16 x 352 x
384 by default), made from a seeded generator. Each line is one JSON
object with the frames/s and GB/s of one arrangement:

- ``socket``: a bare loopback TCP connection, ``sendall`` on one thread
  and ``recv_into`` one preallocated buffer on another: the kernel's copy
  in and out, no protocol;
- ``client_to_client``: the port's queue server in its own process
  (``python -m psana_ray_tpu_torch.queue_server``), a producer process
  sending with windowed puts, and this process draining a push stream,
  each frame released at once (no batch copy);
- ``client_to_client_copy``: the same, each frame copied into a reused
  32-frame arena first, as ``FrameBatcher.push_view`` does;
- ``in_process_server``: the server on a thread of this process, the
  producer on another thread: the three share one interpreter.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPE = (16, 352, 384)


def _frames(n_distinct: int, frame_mb: float):
    per = int(frame_mb * 1e6 / 4)
    shape = SHAPE if per == int(np.prod(SHAPE)) else (1, per)
    rng = np.random.default_rng(0)
    return [rng.normal(100.0, 3.0, shape).astype(np.float32) for _ in range(n_distinct)]


def bare_socket(frames, n):
    nbytes = frames[0].nbytes
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    buf = memoryview(bytearray(nbytes))
    done = {}

    def receive():
        conn, _ = srv.accept()
        t0 = 0.0
        for i in range(n + 1):
            if i == 1:  # the clock starts once the first frame is in
                t0 = time.perf_counter()
            got = 0
            while got < nbytes:
                k = conn.recv_into(buf[got:])
                if not k:
                    raise ConnectionError("closed")
                got += k
        done["s"] = time.perf_counter() - t0
        conn.close()

    t = threading.Thread(target=receive)
    t.start()
    c = socket.create_connection(("127.0.0.1", port))
    for i in range(n + 1):
        c.sendall(frames[i % len(frames)].data.cast("B"))
    t.join()
    c.close()
    srv.close()
    return done["s"]


def _produce(address, n, frame_mb, n_distinct):
    from psana_ray_tpu_torch.producer import produce
    from psana_ray_tpu_torch.transport.tcp import TcpQueueClient

    frames = _frames(n_distinct, frame_mb)
    host, port = address.split(":")
    c = TcpQueueClient(host, int(port))
    produce(((i, frames[i % len(frames)], 1.0) for i in range(n)), c, timeout=120.0)
    c.disconnect()


def drain(client, n, arena=None):
    from psana_ray_tpu_torch.records import EndOfStream

    client.stream_open(32)
    got, t0, first = 0, None, 0
    while True:
        batch = client.get_batch_stream(32, timeout=30.0)
        if not batch:
            raise RuntimeError(f"nothing for 30 s after {got} frames")
        if t0 is None:  # the clock starts once the first batch is in
            t0, first = time.perf_counter(), len(batch)
        for item in batch:
            if isinstance(item, EndOfStream):
                return got - first, time.perf_counter() - t0
            if arena is not None:
                arena[got % len(arena)] = item.panels
            item.release()
            got += 1


def through_server_process(n, frame_mb, n_distinct, copy):
    from psana_ray_tpu_torch.transport.tcp import TcpQueueClient

    with tempfile.TemporaryDirectory() as tmp:
        port_file = os.path.join(tmp, "port")
        server = subprocess.Popen(
            [sys.executable, "-m", "psana_ray_tpu_torch.queue_server", "--host", "127.0.0.1",
             "--port", "0", "--port_file", port_file, "--queue_size", "40", "--log_level",
             "WARNING"], cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT})
        try:
            while not os.path.exists(port_file):
                time.sleep(0.05)
            port = int(open(port_file).read())
            producer = mp.get_context("spawn").Process(
                target=_produce, args=(f"127.0.0.1:{port}", n, frame_mb, n_distinct))
            producer.start()
            client = TcpQueueClient("127.0.0.1", port)
            arena = None
            if copy:
                arena = np.empty((32, *_frames(1, frame_mb)[0].shape), np.float32)
            got, seconds = drain(client, n, arena)
            client.disconnect()
            producer.join(timeout=60)
        finally:
            server.terminate()
            server.wait(timeout=30)
    return got, seconds


def in_process_server(frames, n):
    from psana_ray_tpu_torch.producer import produce
    from psana_ray_tpu_torch.transport.tcp import TcpQueueClient, TcpQueueServer

    srv = TcpQueueServer(host="127.0.0.1", port=0, maxsize=40).serve_background()
    producer = TcpQueueClient("127.0.0.1", srv.port)
    t = threading.Thread(target=produce, args=(((i, frames[i % len(frames)], 1.0)
                                                for i in range(n)), producer))
    t.start()
    consumer = TcpQueueClient("127.0.0.1", srv.port)
    got, seconds = drain(consumer, n)
    t.join()
    producer.disconnect()
    consumer.disconnect()
    srv.shutdown()
    return got, seconds


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=256)
    p.add_argument("--frame_mb", type=float, default=4 * float(np.prod(SHAPE)) / 1e6)
    p.add_argument("--distinct", type=int, default=8)
    a = p.parse_args()
    frames = _frames(a.distinct, a.frame_mb)
    nbytes = frames[0].nbytes

    def emit(name, timed, seconds):
        # the frames that arrived after the clock started, over its seconds
        rate = timed / seconds if seconds > 0 else 0.0
        print(json.dumps({"arrangement": name, "timed_frames": timed, "seconds": seconds,
                          "frames_per_s": rate, "gbytes_per_s": rate * nbytes / 1e9,
                          "frame_bytes": nbytes}), flush=True)

    emit("socket", a.frames, bare_socket(frames, a.frames))
    for name, copy in (("client_to_client", False), ("client_to_client_copy", True)):
        emit(name, *through_server_process(a.frames, a.frame_mb, a.distinct, copy))
    emit("in_process_server", *in_process_server(frames, a.frames))


if __name__ == "__main__":
    main()
