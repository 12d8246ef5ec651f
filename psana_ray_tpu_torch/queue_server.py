"""The queue server program: one process hosting named queues over TCP.

The port's copy of ``psana_ray_tpu/queue_server.py``. Clients reach it
with ``--address tcp://host:port``, and their ``(namespace, queue_name)``
gets or creates a queue on it; the queues live until the process stops.
A JAX client talks to it as to the JAX package's server.

    python -m psana_ray_tpu_torch.queue_server --port 0 --port_file port.txt \\
        --queue_size 40 --max_conns 64

``--port 0`` binds a free port and ``--port_file`` writes it (atomically)
once the server listens. ``--shm NAME`` backs the queues with shm rings
(the default queue ring ``NAME``, a named queue ring
``<namespace>__<queue_name>``), so local processes can attach through
``shm://`` while remote ones come over TCP. SIGINT or SIGTERM drains:
puts are refused while consumers read on, for up to ``--drain_s``
seconds or until every queue is empty; then every queue closes (blocked
clients see a dead transport) and the server stops. A second signal
skips the rest of the drain.

The JAX command's worker fleet, durable, replica, stall, obs and
autotune flags are refused (ROADMAP.md Queue 1 Item 8). The process
imports no torch.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading
import time

from psana_ray_tpu_torch.utils.cli import add_refused_flags, refuse_unported

logger = logging.getLogger(__name__)

# the JAX command's flags of modules the port has not ported
NOT_PORTED_FLAGS = (
    "--workers", "--durable_dir", "--segment_bytes", "--retain_segments", "--fsync",
    "--fsync_batch_n", "--ram_items", "--replicate_peers", "--advertise", "--replica_codec",
    "--metrics_host", "--metrics_port", "--trace_dir", "--trace_sample", "--flight_dir",
    "--history_interval", "--history_samples", "--profile_hz", "--profile_dir", "--autotune",
    "--autotune_interval", "--stall_poll_s", "--stall_full_s", "--stall_idle_s",
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m psana_ray_tpu_torch.queue_server")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=6379, help="listening port (0: a free one)")
    p.add_argument("--queue_size", type=int, default=100)
    p.add_argument("--shm", default=None, metavar="NAME",
                   help="back the queues with shm rings: the default queue ring NAME, a named "
                        "queue ring <namespace>__<queue_name> (local processes attach through "
                        "shm://)")
    p.add_argument("--port_file", default=None,
                   help="write the bound port to this file once listening")
    p.add_argument("--max_conns", type=int, default=0,
                   help="refuse connections past this many with a protocol error (0: no limit)")
    p.add_argument("--drain_s", type=float, default=10.0,
                   help="on SIGINT/SIGTERM: refuse puts and let consumers drain for up to this "
                        "many seconds before the queues close (0: close at once)")
    p.add_argument("--log_level", default="INFO")
    add_refused_flags(p, NOT_PORTED_FLAGS)
    a = p.parse_args(argv)
    refuse_unported(p, a, NOT_PORTED_FLAGS,
                    "the worker fleet, durable queues, replication, stall detection, obs and "
                    "autotune")
    return a


def _shm_backing(name: str, maxsize: int):
    from psana_ray_tpu_torch.transport.shm_ring import ShmRingBuffer

    try:
        return ShmRingBuffer.create(name, maxsize=maxsize)
    except RuntimeError:
        return ShmRingBuffer.attach(name, retries=1, interval_s=0.1)


def main(argv=None) -> int:
    a = parse_args(argv)
    logging.basicConfig(level=getattr(logging, a.log_level.upper(), logging.INFO),
                        format="%(asctime)s - %(levelname)s - %(message)s")
    from psana_ray_tpu_torch.transport.ring import RingBuffer
    from psana_ray_tpu_torch.transport.tcp import TcpQueueServer

    queue_factory = None
    if a.shm:
        backing = _shm_backing(a.shm, a.queue_size)

        # the ring name of transport.addressing.shm_ring_name: a local
        # consumer with the same config reads the ring remote producers feed
        def queue_factory(ns, name, maxsize):
            logger.info("named queue (%s, %s) -> shm ring %r", ns, name, f"{ns}__{name}")
            return _shm_backing(f"{ns}__{name}", maxsize)

        logger.info("backing queues: shm rings (default ring %r)", a.shm)
    else:
        backing = RingBuffer(a.queue_size)
    server = TcpQueueServer(backing, host=a.host, port=a.port, maxsize=a.queue_size,
                            queue_factory=queue_factory, max_conns=a.max_conns).serve_background()
    if a.port_file:
        with open(a.port_file + ".tmp", "w") as f:
            f.write(str(server.port))
        os.replace(a.port_file + ".tmp", a.port_file)  # atomic: no torn read
    logger.info("queue server listening on %s:%d (size=%d%s): clients use --address "
                "tcp://<host>:%d", a.host, server.port, a.queue_size,
                f", max_conns={a.max_conns}" if a.max_conns else "", server.port)

    done = threading.Event()
    force = threading.Event()

    def _stop(sig, frame):
        if done.is_set():
            logger.info("second signal %s: forcing immediate shutdown", sig)
            force.set()
            return
        logger.info("signal %s: shutting down queue server", sig)
        done.set()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    done.wait()
    if a.drain_s > 0 and not force.is_set():
        server.begin_drain()
        start = time.monotonic()
        while time.monotonic() - start < a.drain_s and not force.is_set():
            if server.depth() == 0:
                logger.info("drained: all queues empty")
                break
            force.wait(0.2)
        else:
            logger.warning("drain window ended with %d item(s) still queued", server.depth())
    stats = server.stats_all()
    server.close_all()  # every blocked client sees a dead transport
    server.shutdown()
    logger.info("queue server stopped: %s", stats)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
