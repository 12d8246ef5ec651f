"""The queue server program: one process (or a fleet of them) hosting
named queues over TCP.

The port's copy of ``psana_ray_tpu/queue_server.py``. Clients reach it
with ``--address tcp://host:port``, and their ``(namespace, queue_name)``
gets or creates a queue on it; the queues live until the process stops.
A JAX client talks to it as to the JAX package's server.

    python -m psana_ray_tpu_torch.queue_server --port 0 --port_file port.txt \\
        --queue_size 40 --max_conns 64 --workers 2 --durable_dir /data/queues

``--port 0`` binds a free port and ``--port_file`` writes it (atomically)
once the server listens. ``--shm NAME`` backs the queues with shm rings
(the default queue ring ``NAME``, a named queue ring
``<namespace>__<queue_name>``), so local processes can attach through
``shm://`` while remote ones come over TCP.

``--durable_dir DIR`` backs every queue with a segment log under
``DIR/<namespace>__<queue_name>`` (the default queue's is
``DIR/default__default``), in the JAX package's format: queued frames
survive ``kill -9`` and restart (the boot re-exposes what lies above the
committed offset, cutting a torn tail), depth beyond ``--ram_items``
spills to the log and goes out by ``sendfile``, and consumers can
``--replay`` the retained range; the consumer groups that clients of
``cluster://`` coordinate through this server (the 'N' RPC) are stored
in ``DIR/groups.json`` (``DIR/groups-w<id>.json`` for a fleet's worker)
and recovered at boot, in the JAX package's format. ``--workers N`` forks N servers that
share the port by ``SO_REUSEPORT``; each named queue lives on one worker
(rendezvous-pinned), connections migrate to it over ``SCM_RIGHTS``, and a
worker that dies is forked again under its id, its queues recovered from
their logs at the next OPEN. The parent forks before it starts a thread
and serves nothing itself.

SIGINT or SIGTERM drains: puts are refused while consumers read on, for
up to ``--drain_s`` seconds or until every queue is empty; then every
queue closes (blocked clients see a dead transport), the segment logs
are flushed and unmapped, and the server stops. A second signal skips
the rest of the drain. A fleet's parent forwards the signal to its
workers, each of which drains so.

A cluster of these servers is an address list on the clients
(``--cluster host:port,host:port``), the first server being the groups'
coordinator; start it first. ``--replicate_peers A,B,... --advertise A``
(with ``--durable_dir``; not with ``--workers``) chain-replicates each
durable partition log to the next server of its rendezvous ranking, holds
producer answers until the follower has logged the frame, and keeps the
coordinator's group state on the next peer under a leader lease
(:mod:`psana_ray_tpu_torch.cluster.replication`); ``--replica_codec``
compresses the links. The JAX command's stall, obs and autotune flags are
refused (ROADMAP.md Queue 1 Item 8). The process, and every worker it forks,
imports no torch.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import signal
import socket
import tempfile
import threading
import time

from psana_ray_tpu_torch.config import DurabilityConfig
from psana_ray_tpu_torch.utils.cli import add_refused_flags, refuse_unported

logger = logging.getLogger(__name__)

# the JAX command's flags of modules the port has not ported
NOT_PORTED_FLAGS = (
    "--metrics_host", "--metrics_port",
    "--trace_dir", "--trace_sample", "--flight_dir", "--history_interval", "--history_samples",
    "--profile_hz", "--profile_dir", "--autotune", "--autotune_interval", "--stall_poll_s",
    "--stall_full_s", "--stall_idle_s",
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m psana_ray_tpu_torch.queue_server")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=6379, help="listening port (0: a free one)")
    p.add_argument("--queue_size", type=int, default=100)
    p.add_argument("--workers", type=int, default=1,
                   help="fork this many servers sharing the one port by SO_REUSEPORT: each "
                        "named queue lives on one worker, connections migrate to it, and a "
                        "worker that dies is forked again with its queues recovered from the "
                        "durable log. Incompatible with --shm")
    p.add_argument("--shm", default=None, metavar="NAME",
                   help="back the queues with shm rings: the default queue ring NAME, a named "
                        "queue ring <namespace>__<queue_name> (local processes attach through "
                        "shm://)")
    p.add_argument("--durable_dir", default=None, metavar="DIR",
                   help="back every queue with a recycled mmap'd segment log under DIR: queued "
                        "frames survive kill -9 and restart, depth beyond RAM spills to the "
                        "log, consumers can --replay the retained range. Incompatible with "
                        "--shm")
    dur = DurabilityConfig()
    p.add_argument("--segment_bytes", type=int, default=dur.segment_bytes,
                   help="size of one pre-allocated segment file (it must hold the largest "
                        "record)")
    p.add_argument("--retain_segments", type=int, default=dur.retain_segments,
                   help="consumed segments kept for --replay before they are recycled; "
                        "unconsumed records are never recycled")
    p.add_argument("--fsync", choices=("none", "batch", "always"), default=dur.fsync,
                   help="segment-log fsync policy: 'none' survives process death but a "
                        "machine crash may lose the tail; 'batch' fsyncs every "
                        "--fsync_batch_n appends, on a roll and on a commit; 'always' after "
                        "every append")
    p.add_argument("--fsync_batch_n", type=int, default=dur.fsync_batch_n,
                   help="appends per fsync under --fsync batch")
    p.add_argument("--ram_items", type=int, default=dur.ram_items,
                   help="RAM-resident records a durable queue before delivery reads the log "
                        "(0: the queue's size)")
    p.add_argument("--replicate_peers", default=None, metavar="HOST:PORT,...",
                   help="chain-replicate durable partition logs across this static server "
                        "list: each durable queue this server owns ships its segment log to "
                        "the next server in the partition's rendezvous ranking, producer "
                        "answers wait for the follower (the replicated ack floor), and the "
                        "consumer-group coordinator's state replicates under a leader lease. "
                        "Start every server of the cluster with the same list. Requires "
                        "--durable_dir and --advertise")
    p.add_argument("--advertise", default=None, metavar="HOST:PORT",
                   help="this server's own address as --replicate_peers spells it (placement "
                        "is computed from the list, so the spelling must match exactly)")
    p.add_argument("--replica_codec", default=None,
                   help="wire codec of the replication links ('auto', a codec name, or unset "
                        "for raw)")
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
    refuse_unported(p, a, NOT_PORTED_FLAGS, "stall detection, obs and autotune")
    if a.durable_dir and a.shm:
        p.error("--durable_dir and --shm are mutually exclusive (the segment log backs "
                "in-process queues; shm rings have their own lifetime)")
    if a.replicate_peers and not (a.durable_dir and a.advertise):
        p.error("--replicate_peers requires --durable_dir (the segment log is what replicates) "
                "and --advertise (this server's own address in the peer list)")
    if a.replicate_peers:
        peers = _peer_list(a.replicate_peers)
        if a.advertise not in peers:
            # a spelling mismatch would leave every queue unreplicated, quietly
            p.error(f"--advertise {a.advertise!r} does not appear in --replicate_peers {peers} "
                    f"— the spellings must match exactly or no queue will ever replicate")
    if a.workers > 1:
        if not hasattr(socket, "SO_REUSEPORT"):
            p.error("--workers needs SO_REUSEPORT, which this platform does not expose — "
                    "run a single worker")
        if a.shm:
            p.error("--workers is incompatible with --shm (shm rings already give local "
                    "processes multi-process access; pick one data plane)")
        if a.replicate_peers:
            p.error("--workers is incompatible with --replicate_peers (replica links bind "
                    "queues directly to one serving process; run replicated servers "
                    "single-worker)")
    return a


def _peer_list(spec: str):
    return [s.strip() for s in spec.split(",") if s.strip()]


def _shm_backing(name: str, maxsize: int):
    from psana_ray_tpu_torch.transport.shm_ring import ShmRingBuffer

    try:
        return ShmRingBuffer.create(name, maxsize=maxsize)
    except RuntimeError:
        return ShmRingBuffer.attach(name, retries=1, interval_s=0.1)


def _durable_factory(a):
    """The queue factory of ``--durable_dir``: one segment log a queue,
    recovered (its boot scan) when the queue is first opened."""
    from psana_ray_tpu_torch.storage import DurableRingBuffer, SegmentLog

    def factory(ns, name, maxsize):
        qdir = os.path.join(a.durable_dir, f"{ns}__{name}")
        log = SegmentLog(qdir, segment_bytes=a.segment_bytes, retain_segments=a.retain_segments,
                         fsync=a.fsync, fsync_batch_n=a.fsync_batch_n, name=f"{ns}/{name}")
        # spilled records are delivered unread: the loop sends them by sendfile
        q = DurableRingBuffer(log, maxsize=maxsize, name=f"{ns}__{name}",
                              ram_items=a.ram_items or None)
        # one line every open, a fresh directory's too: a respawned worker
        # reports its recovery whether or not anything was left unconsumed
        logger.info("durable queue (%s, %s): recovered %d unconsumed record(s) of %d from "
                    "%s in %.1f ms (committed offset %d%s)", ns, name, q.reexposed,
                    log.recovered_records, qdir, log.recovery_ms, log.committed(""),
                    ", torn tail cut" if log.torn_tail_repaired else "")
        return q

    return factory


def _write_port_file(path: str, port: int) -> None:
    with open(path + ".tmp", "w") as f:
        f.write(str(port))
    os.replace(path + ".tmp", path)  # atomic: no torn read


def main(argv=None) -> int:
    a = parse_args(argv)
    logging.basicConfig(level=getattr(logging, a.log_level.upper(), logging.INFO),
                        format="%(asctime)s - %(levelname)s - %(message)s")
    if a.durable_dir:
        os.makedirs(a.durable_dir, exist_ok=True)
    if a.workers > 1:
        return _run_workers(a)
    return _serve(a)


def _await_fleet(host: str, port: int, sock_dir: str, n: int, timeout_s: float = 30.0) -> None:
    """Until every worker has bound its adoption socket and the port
    answers a connection (bounded), so the port file names a serving
    fleet."""
    deadline = time.monotonic() + timeout_s
    probe_host = "127.0.0.1" if host in ("0.0.0.0", "") else host
    while time.monotonic() < deadline:
        if all(os.path.exists(os.path.join(sock_dir, f"worker-{i}.sock")) for i in range(n)):
            try:
                socket.create_connection((probe_host, port), timeout=1.0).close()
                return
            except OSError:
                pass
        time.sleep(0.02)
    logger.warning("the worker fleet was not serving after %.0f s", timeout_s)


def _run_workers(a) -> int:
    """The parent of a ``--workers`` fleet: resolve the shared port, fork
    the workers (each builds its whole server in :func:`_serve`), respawn
    the dead, forward the shutdown."""
    from psana_ray_tpu_torch.transport.splice import probe_report
    from psana_ray_tpu_torch.transport.workers import (
        WorkerContext,
        WorkerSupervisor,
        resolve_port,
    )

    port = resolve_port(a.host, a.port)
    sock_dir = tempfile.mkdtemp(prefix="psana-workers-")

    def worker(worker_id):
        _serve(a, worker_ctx=WorkerContext(worker_id, a.workers, sock_dir), port=port)

    done = threading.Event()

    def _stop(sig, frame):
        logger.info("signal %s: shutting down the worker fleet", sig)
        done.set()

    # before the fork: a signal in between must not kill the parent alone
    # (the workers reset theirs to the default)
    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    sup = WorkerSupervisor(a.workers, worker).start()
    try:
        _await_fleet(a.host, port, sock_dir, a.workers)
        if a.port_file:
            _write_port_file(a.port_file, port)
        logger.info("queue server: %d workers on %s:%d by SO_REUSEPORT (sendfile: %s): clients "
                    "use --address tcp://<host>:%d", a.workers, a.host, port, probe_report(), port)
        done.wait()
    finally:
        # each worker drains in its own SIGTERM handler
        sup.stop(timeout_s=a.drain_s + 10.0)
        shutil.rmtree(sock_dir, ignore_errors=True)
    logger.info("queue server stopped: workers %s", sup.snapshot())
    return 0


def _serve(a, worker_ctx=None, port=None) -> int:
    """One whole queue server: its backing, the TCP server, the drain on a
    signal. With ``worker_ctx`` it is a worker of a fleet: it binds the
    shared port with ``SO_REUSEPORT`` and owns only its queues."""
    from psana_ray_tpu_torch.transport.ring import RingBuffer
    from psana_ray_tpu_torch.transport.tcp import TcpQueueServer
    from psana_ray_tpu_torch.transport.workers import DEFAULT_QUEUE_WORKER

    queue_factory = None
    group_store_path = None
    replication = None
    if a.durable_dir:
        group_store_path = os.path.join(
            a.durable_dir, "groups.json" if worker_ctx is None
            else f"groups-w{worker_ctx.worker_id}.json")
        queue_factory = _durable_factory(a)
        if worker_ctx is None or worker_ctx.worker_id == DEFAULT_QUEUE_WORKER:
            backing = queue_factory("default", "default", a.queue_size)
        else:
            # ops on the default queue migrate to its owner: a plain ring
            # stands in without touching the owner's log
            backing = RingBuffer(a.queue_size)
        logger.info("backing queues: segment logs under %s (segment_bytes=%d, retain=%d, "
                    "fsync=%s)", a.durable_dir, a.segment_bytes, a.retain_segments, a.fsync)
        if a.replicate_peers:
            from psana_ray_tpu_torch.cluster.replication import ReplicationManager

            peers = _peer_list(a.replicate_peers)
            # an unknown codec raises here, at start
            replication = ReplicationManager(a.durable_dir, peers, a.advertise,
                                             codec=a.replica_codec,
                                             segment_bytes=a.segment_bytes,
                                             retain_segments=a.retain_segments, fsync=a.fsync,
                                             fsync_batch_n=a.fsync_batch_n)
            logger.info("replication: chain over %s (advertise=%s, codec=%s) — owned durable "
                        "queues ship to their rendezvous runner-up; producer acks ride the "
                        "replicated floor", peers, a.advertise, a.replica_codec or "raw")
    elif a.shm:
        backing = _shm_backing(a.shm, a.queue_size)

        # the ring name of transport.addressing.shm_ring_name: a local
        # consumer with the same config reads the ring remote producers feed
        def queue_factory(ns, name, maxsize):
            logger.info("named queue (%s, %s) -> shm ring %r", ns, name, f"{ns}__{name}")
            return _shm_backing(f"{ns}__{name}", maxsize)

        logger.info("backing queues: shm rings (default ring %r)", a.shm)
    else:
        backing = RingBuffer(a.queue_size)
    server = TcpQueueServer(backing, host=a.host, port=a.port if port is None else port,
                            maxsize=a.queue_size, queue_factory=queue_factory,
                            max_conns=a.max_conns, worker_ctx=worker_ctx,
                            group_store_path=group_store_path,
                            replication=replication).serve_background()
    if worker_ctx is not None:
        logger.info("worker %d of %d (pid %d) listening on %s:%d", worker_ctx.worker_id,
                    worker_ctx.n_workers, os.getpid(), a.host, server.port)
    else:
        if a.port_file:
            _write_port_file(a.port_file, server.port)
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
    for q in server.all_queues():
        log = getattr(q, "log", None)
        if log is not None:
            log.close()  # flush and unmap the segments
    who = ""
    if worker_ctx is not None:
        worker_ctx.close()
        who = f"worker {worker_ctx.worker_id}: "
        logger.info("%sconnections migrated %d, adopted %d", who, worker_ctx.migrated,
                    worker_ctx.adopted)
    if a.durable_dir:
        # the process's counters: what its logs appended, fsynced, rolled,
        # recycled and spilled, and what went out by sendfile
        from psana_ray_tpu_torch.storage import DURABLE
        from psana_ray_tpu_torch.transport.splice import SPLICE

        logger.info("%sdurable log counters %s sendfile %s", who, json.dumps(DURABLE.stats()),
                    json.dumps(SPLICE.snapshot()))
    if replication is not None:
        from psana_ray_tpu_torch.cluster.replication import REPL

        logger.info("replication counters %s", json.dumps(REPL.stats()))
    logger.info("queue server stopped: %s", stats)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
