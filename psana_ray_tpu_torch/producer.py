"""Producer runtime and CLI: sharded ingest into a named, backpressured queue.

The port's copy of ``psana_ray_tpu/producer.py`` over the port's
transports (``auto``/``local``, ``shm://``, ``tcp://`` and ``cluster://``). :class:`ProducerRuntime`
runs ``num_local_shards`` ingest threads into one queue: each opens its
strided shard of a source (:func:`~psana_ray_tpu_torch.sources.open_source`:
synthetic, ``replay:<path>`` or psana), applies the bad-pixel and manual
masks on the host, optionally narrows the panels to a wire dtype, and
puts each event with the reference's backoff envelope. All shards meet
at one ``threading.Barrier``, then local shard 0 puts one
:class:`EndOfStream` per expected consumer, carrying the shards this
runtime covered of the global count. A shard resumes from a consumer's
:class:`~psana_ray_tpu_torch.checkpoint.StreamCursor` (at least once).

The CLI keeps the JAX command's flags, defaults and log lines:

    python -m psana_ray_tpu_torch.producer --exp replay:run42.npz \\
        --address tcp://ingest-head:6379 --wire_codec shuffle-rle \\
        --num_shards 2 --num_consumers 2

``--cluster host:port,host:port --partitions P`` shards the queue over a
cluster of queue servers. ``--metrics_port`` serves the producer's
metrics, ``--history_interval`` samples them, ``--trace_dir`` and
``--trace_sample`` trace 1 frame in N (the ``produce`` instant and the
``enqueue`` span of each sampled frame, its ``src`` and ``enq`` hop
stamps), ``--flight_dir`` arms the flight recorder and ``--profile_hz``
(97 by default; 0 turns it off) runs the continuous profiler, its spool
written into ``--profile_dir`` at exit, and ``--autotune on|observe``
closes the loop on the put window and the wire codec, judged by the
produce rate, as in the JAX package. Also here:
:func:`produce`, the inner loop alone, and :func:`produce_synthetic`, a
``spawn`` producer process that feeds a named shm ring, a queue server or
a cluster from a seeded :class:`SyntheticSource`.

Nothing here imports torch: a producer process never touches the card.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading
import time
from typing import Iterable, List, Optional, Tuple

import numpy as np

from psana_ray_tpu_torch.config import MaskConfig, PipelineConfig, RetrievalMode, SourceConfig
from psana_ray_tpu_torch.config import TransportConfig
from psana_ray_tpu_torch.obs.exporter import add_metrics_args, start_metrics_server
from psana_ray_tpu_torch.obs.flight import FLIGHT
from psana_ray_tpu_torch.obs.profiling import (
    TAG_ENQUEUE,
    add_profile_args,
    configure_profiling_from_args,
    set_stage,
    swap_stage,
    wire_bytes,
)
from psana_ray_tpu_torch.obs.registry import MetricsRegistry
from psana_ray_tpu_torch.obs.stages import HOP_ENQ, HOP_SRC, STAGE_ENQUEUE
from psana_ray_tpu_torch.obs.timeseries import add_history_args, configure_history_from_args
from psana_ray_tpu_torch.obs.tracing import (
    SPAN_PRODUCE,
    TRACER,
    add_trace_args,
    configure_from_args,
    exchange_anchors,
)
from psana_ray_tpu_torch.records import EndOfStream, FrameRecord, mark_hop, narrow_panels
from psana_ray_tpu_torch.sources import SyntheticSource, open_source
from psana_ray_tpu_torch.transport import BackoffPolicy, Registry, TransportClosed, TransportWedged
from psana_ray_tpu_torch.transport.addressing import (
    add_cluster_args,
    add_wire_args,
    apply_cluster_args,
    apply_wire_args,
    open_queue,
)
from psana_ray_tpu_torch.transport.shm_ring import ShmRingBuffer
from psana_ray_tpu_torch.utils.metrics import PipelineMetrics

logger = logging.getLogger(__name__)


def produce(
    events: Iterable[Tuple[int, np.ndarray, float]],
    queue,
    shard_rank: int = 0,
    total_shards: int = 1,
    timeout: Optional[float] = None,
) -> int:
    """Put every ``(event_idx, panels, photon_energy)`` as a
    :class:`FrameRecord` with ``put_wait`` (blocking while the queue is
    full), or through :class:`_Sender`'s windowed puts where the queue has
    them (a TCP client: every ack read back before it returns), then one
    EOS covering this shard. Returns the events put. ``events`` is e.g.
    ``SyntheticSource.iter_indexed_events("raw")``. Raises
    ``TimeoutError`` if a put waits longer than ``timeout``, and
    ``TransportClosed`` if the queue closes."""
    sender = None
    if hasattr(queue, "put_pipelined"):
        sender = _Sender(queue, None, threading.Event(), PipelineMetrics(), timeout=timeout)

    def put(item, what):
        if sender is None:
            prev = swap_stage(TAG_ENQUEUE)
            try:
                ok = queue.put_wait(item, timeout=timeout)
            finally:
                set_stage(prev)
            if not ok:
                raise TimeoutError(f"queue full for {timeout} s at {what}")
        elif not sender.send(item):
            raise TransportClosed(f"the queue closed at {what}")

    n = 0
    for idx, panels, energy in events:
        put(FrameRecord(shard_rank, int(idx), panels, float(energy), time.time()), f"event {idx}")
        n += 1
    put(EndOfStream(producer_rank=shard_rank, total_events=n, total_shards=total_shards),
        "end of stream")
    if sender is not None and not sender.flush():
        raise TransportClosed("the queue closed before every put was acknowledged")
    return n


def produce_synthetic(
    target: str,
    detector_name: str,
    n_events: int,
    pool_events: int,
    seed: int = 0,
    dtype: str = "float32",
    produced=None,
    run: int = 1,
    queue_name: str = "shared_queue",
    partitions: int = 8,
    retain: Optional[int] = None,
    stats=None,
    interval_s: float = 0.0,
) -> int:
    """A producer process's body, for ``multiprocessing``'s ``spawn``
    start method: draw the RAW events ``0 .. pool_events - 1`` of
    ``SyntheticSource(detector_name, seed, dtype, run)``, then attach to
    ``target`` (an shm ring's name; a ``tcp://host:port`` address: the
    named queue ``("default", queue_name)`` there; or a
    ``cluster://host:port,...`` address: that queue in ``partitions``
    partitions, keeping ``retain`` acknowledged frames a partition for a
    failover's resend, the client's default where None), put ``n_events``
    of them (the pool cycled, event index ``i`` carrying pool event
    ``i % pool_events``; over TCP with windowed puts) and one EOS, and
    detach, waiting ``interval_s`` before each event (a detector's pace;
    0: as fast as the transport takes them). ``produced`` (a
    ``multiprocessing.Value``) receives the count, ``stats`` (a
    ``multiprocessing`` queue, optional) the largest resident set of the
    process sampled every 16 events and once the last put is acknowledged
    (the retained records still held), and, over a cluster, the client's
    ``CLUSTER`` counters. A retained record holds the pool's array, not a
    copy."""
    src = SyntheticSource(run=run, num_events=pool_events, detector_name=detector_name,
                          seed=seed, dtype=dtype)
    pool = [src.event(i, "raw") for i in range(pool_events)]
    if target.startswith("cluster://"):
        from psana_ray_tpu_torch.cluster.client import ClusterClient

        kw = {} if retain is None else {"retain": retain}
        queue = ClusterClient(target, queue_name=queue_name, n_partitions=partitions, **kw)
    elif target.startswith("tcp://"):
        queue = open_queue(TransportConfig(address=target, queue_name=queue_name),
                           role="producer")
    else:
        queue = ShmRingBuffer.attach(target, retries=100, interval_s=0.1)

    rss = [_rss_bytes()]

    def events():
        for i in range(n_events):
            if interval_s > 0:
                time.sleep(interval_s)
            if i % 16 == 0:
                rss.append(_rss_bytes())
            yield (i, *pool[i % pool_events])

    try:
        n = produce(events(), queue, timeout=120.0)
        rss.append(_rss_bytes())
    finally:
        queue.disconnect()
    if produced is not None:
        produced.value = n
    if stats is not None:
        from psana_ray_tpu_torch.cluster.telemetry import CLUSTER

        sampled = [r for r in rss if r is not None]
        stats.put({"peak_rss_bytes": max(sampled) if sampled else None,
                   "cluster": CLUSTER.stats() if target.startswith("cluster://") else None})
    return n


def _rss_bytes() -> Optional[int]:
    """This process's resident set now, from ``/proc/self/statm`` (None
    without it). ``ru_maxrss`` would not do: a ``spawn`` child's holds its
    parent's peak at the fork, which the exec keeps."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


class _Sender:
    """Backpressured frame sender, on the fastest path the transport has:

    - windowed puts (TCP, ``put_pipelined``): each record leaves at once,
      up to the client's window in flight before the sender waits for
      acks; backpressure arrives as delayed acks, and a reconnect resends
      exactly the unacked tail. :meth:`flush` (``flush_puts``) waits for
      every ack: the end of a shard, before the barrier and the EOS;
    - ``put_batch`` of up to ``batch_size`` records where the transport
      has it, with the backoff envelope on a refused or partly accepted
      put;
    - one ``put`` a record otherwise (in-process and shm: a put is a
      memcpy).

    Over TCP every path sends scatter-gather from the record's panels: the
    producer copies no payload. A windowed send or flush that waits longer
    than ``timeout`` raises ``TimeoutError`` (None: it waits until the
    transport closes or ``stop_event`` is set)."""

    def __init__(self, queue, backoff, stop_event, metrics, batch_size: int = 16,
                 timeout: Optional[float] = None):
        self.queue = queue
        self.backoff = backoff
        self.stop = stop_event
        self.metrics = metrics
        self.timeout = timeout
        self.windowed = hasattr(queue, "put_pipelined")
        self.batch_size = (batch_size if not self.windowed and hasattr(queue, "put_batch")
                           else 1)
        self.pending: List[FrameRecord] = []

    def send(self, rec) -> bool:
        """Send ``rec`` (windowed) or buffer it and flush a full buffer.
        False: the transport closed or the runtime stopped. The profiler
        bills the call to "enqueue"."""
        prev = swap_stage(TAG_ENQUEUE)
        try:
            if self.windowed:
                return self._send_windowed(rec)
            self.pending.append(rec)
            if len(self.pending) >= self.batch_size:
                return self._flush()
            return True
        finally:
            set_stage(prev)

    def _windowed(self, call) -> bool:
        """Retry ``call(deadline)`` in bounded slices, so that stop() stays
        prompt while the window is full. False: the transport closed or the
        runtime stopped."""
        end = None if self.timeout is None else time.monotonic() + self.timeout
        while not self.stop.is_set():
            now = time.monotonic()
            if end is not None and now >= end:
                raise TimeoutError(f"windowed puts unacknowledged for {self.timeout} s")
            try:
                if call(min(now + 0.5, end) if end is not None else now + 0.5):
                    return True
            except TransportWedged:
                raise
            except TransportClosed:
                return False
        return False

    def _send_windowed(self, rec) -> bool:
        t_try = time.monotonic()
        hops = getattr(rec, "hops", None)
        if hops is not None:
            hops[HOP_ENQ] = t_try
        if not self._windowed(lambda deadline: self.queue.put_pipelined(rec, deadline=deadline)):
            return False
        if isinstance(rec, FrameRecord):
            self.metrics.observe_frame(rec.nbytes)
            self._observe_enqueue(rec, t_try)
        return True

    def _observe_enqueue(self, rec: FrameRecord, t_try: float) -> None:
        """The enqueue stage of an accepted record (source read done ->
        the put that took it, backpressure included): the histogram, and
        for a sampled frame the ``produce`` instant and ``enqueue`` span."""
        h = rec.hops
        if h is not None and HOP_SRC in h:
            self.metrics.stages.observe(STAGE_ENQUEUE, t_try - h[HOP_SRC])
        trace = rec.trace
        if trace is not None and trace.sampled and TRACER.enabled:
            t_src = h[HOP_SRC] if h and HOP_SRC in h else t_try
            TRACER.instant(trace.trace_id, SPAN_PRODUCE, t_src)
            TRACER.span(trace.trace_id, STAGE_ENQUEUE, t_src, t_try)

    def flush(self) -> bool:
        """Put every buffered record with the backoff envelope (windowed:
        wait until every put in flight is acked). False: the transport
        closed or the runtime stopped (records may remain buffered; the
        stream is dead either way). The profiler bills it to "enqueue"."""
        prev = swap_stage(TAG_ENQUEUE)
        try:
            return self._flush()
        finally:
            set_stage(prev)

    def _flush(self) -> bool:
        if self.windowed:
            return self._windowed(lambda deadline: self.queue.flush_puts(deadline=deadline))
        while self.pending:
            if self.stop.is_set():
                return False
            # the enqueue stamp goes on before the put, so an in-process
            # consumer never pops a record without it (a retry re-stamps)
            t_try = time.monotonic()
            for r in (self.pending if self.batch_size > 1 else self.pending[:1]):
                if getattr(r, "hops", None) is not None:
                    r.hops[HOP_ENQ] = t_try
            try:
                if self.batch_size > 1:
                    accepted = self.queue.put_batch(self.pending)
                else:
                    accepted = 1 if self.queue.put(self.pending[0]) else 0
            except TransportWedged:
                raise  # a crashed peer wedged the ring: an error, not a clean exit
            except TransportClosed:
                return False
            if accepted:
                for r in self.pending[:accepted]:
                    self.metrics.observe_frame(r.nbytes)
                    if isinstance(r, FrameRecord):
                        self._observe_enqueue(r, t_try)
                del self.pending[:accepted]
                self.backoff.reset()
            else:
                self.backoff.wait()
        return True


class ProducerRuntime:
    """Drives ``num_local_shards`` ingest threads into one named queue.
    ``shard_rank_offset`` and ``total_shards`` place them in the global
    shard space when several producer processes feed one stream."""

    def __init__(
        self,
        config: PipelineConfig,
        registry: Optional[Registry] = None,
        num_local_shards: int = 1,
        shard_rank_offset: int = 0,
        total_shards: Optional[int] = None,
        stage_timing: bool = False,
    ):
        """``stage_timing`` stamps the hops of every record (the CLI turns
        it on with ``--metrics_port``); a sampled frame is stamped anyway."""
        self.config = config
        self.registry = registry or Registry.default()
        self.num_local_shards = num_local_shards
        self.shard_rank_offset = shard_rank_offset
        self.total_shards = total_shards or num_local_shards
        self.stage_timing = stage_timing
        self.metrics = PipelineMetrics()
        self._queue = None
        self._barrier = threading.Barrier(num_local_shards)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._errors: List[BaseException] = []

    def bootstrap(self):
        """Open (get or create) the queue; idempotent."""
        if self._queue is not None:
            return self._queue
        t = self.config.transport
        self._queue = open_queue(t, role="producer", registry=self.registry)
        if not self.metrics.has_queue:
            self.metrics.attach_queue(self._queue)
        logger.info(
            "queue %r ready (namespace=%r address=%r size=%d)",
            t.queue_name, t.namespace, t.address, t.queue_size,
        )
        return self._queue

    def _pump(self, local_idx: int):
        """One shard: read, mask, narrow, send; then the barrier and, on
        local shard 0, the EOS markers."""
        cfg = self.config
        rank = self.shard_rank_offset + local_idx
        t = cfg.transport
        try:
            start_event = self._resume_point(rank)
            source = open_source(
                cfg.source.exp,
                cfg.source.run,
                cfg.source.detector_name,
                shard_rank=rank,
                num_shards=self.total_shards,
                num_events=cfg.source.num_events,
                seed=cfg.source.seed,
                dtype=cfg.source.dtype,
                start_event=start_event,
            )
            if start_event:
                logger.info("rank %d resuming at event >= %d", rank, start_event)
            mask = self._load_mask(source)
            backoff = BackoffPolicy(t.backoff_base_s, t.backoff_cap_s, t.backoff_jitter_s)
            sender = _Sender(self._queue, backoff, self._stop, self.metrics, t.put_batch_size)
            produced = 0
            for idx, data, energy in source.iter_indexed_events(cfg.source.mode):
                if self._stop.is_set():
                    break
                if cfg.source.max_steps is not None and produced >= cfg.source.max_steps:
                    logger.info("rank %d: reached max_steps=%d", rank, cfg.source.max_steps)
                    break
                if mask is not None:
                    data = np.where(mask, data, 0)
                if t.wire_dtype:  # lossy, opt-in: narrowed before the encode
                    data = narrow_panels(np.asarray(data), t.wire_dtype)
                trace_ctx = TRACER.maybe_trace()  # None on the unsampled path
                rec = FrameRecord(rank, int(idx), data, energy, timestamp=time.time(),
                                  trace=trace_ctx)
                if self.stage_timing or trace_ctx is not None:
                    mark_hop(rec, HOP_SRC)  # source read done
                if not sender.send(rec):
                    logger.warning("rank %d: queue dead, exiting", rank)
                    return
                produced += 1
                logger.debug(
                    "rank %d produced idx=%d shape=%s energy=%.2f",
                    rank, idx, rec.panels.shape, energy,
                )
            if not sender.flush():  # the buffer's tail goes before the EOS
                logger.warning("rank %d: queue dead at flush, exiting", rank)
                return
            self._barrier.wait(timeout=600)  # the EOS follows every shard's data
            if local_idx == 0:
                self._emit_eos()
        except BaseException as e:  # noqa: BLE001 (recorded, re-raised by join())
            self._errors.append(e)
            logger.exception("rank %d failed", rank)
            try:
                self._barrier.abort()
            except Exception:
                pass

    def _emit_eos(self):
        """One EOS a consumer, carrying this runtime's shard coverage, so a
        consumer's :class:`~psana_ray_tpu_torch.records.EosTally` stops
        only when every runtime feeding the queue is done. A dead queue is
        logged, not raised."""
        t = self.config.transport
        eos = EndOfStream(
            producer_rank=self.shard_rank_offset,
            shards_done=self.num_local_shards,
            total_shards=self.total_shards,
        )
        for _ in range(t.num_consumers):
            try:
                while not self._queue.put_wait(eos, timeout=5.0):
                    if self._stop.is_set():
                        return
            except TransportWedged:
                raise
            except TransportClosed:
                logger.warning("queue died before EOS could be delivered")
                return
        FLIGHT.record("eos_emitted", producer_rank=self.shard_rank_offset,
                      consumers=t.num_consumers)
        logger.info("EOS delivered to %d consumer(s)", t.num_consumers)

    def _resume_point(self, rank: int) -> int:
        """Where shard ``rank`` starts: ``start_event``, raised to the
        cursor's contiguous watermark for the shard when ``cursor_path``
        names a cursor. A cursor written for another shard count is
        refused: its watermarks would skip events."""
        cfg = self.config.source
        start = cfg.start_event
        if cfg.cursor_path:
            from psana_ray_tpu_torch.checkpoint import StreamCursor

            cursor = StreamCursor.load(cfg.cursor_path)
            if cursor.positions:
                if cursor.stride != self.total_shards:
                    raise ValueError(
                        f"cursor {cfg.cursor_path!r} was written for "
                        f"stride={cursor.stride} but this producer topology "
                        f"has total_shards={self.total_shards}"
                    )
                start = max(start, cursor.resume_point(rank))
        return start

    def _load_mask(self, source) -> Optional[np.ndarray]:
        m = self.config.mask
        mask = None
        if m.uses_bad_pixel_mask:
            mask = source.create_bad_pixel_mask()
        if m.manual_mask_path:
            manual = np.load(m.manual_mask_path)
            mask = manual if mask is None else (mask.astype(bool) & manual.astype(bool))
        return mask

    def run(self, block: bool = True):
        if self._queue is None:
            self.bootstrap()
        self._threads = [
            threading.Thread(target=self._pump, args=(i,), name=f"producer-shard-{i}")
            for i in range(self.num_local_shards)
        ]
        for t in self._threads:
            t.start()
        if block:
            self.join()

    def join(self):
        """Wait for every shard; re-raise the first shard's error."""
        for t in self._threads:
            t.join()
        if self._errors:
            raise self._errors[0]

    def stop(self):
        self._stop.set()


def parse_arguments(argv=None):
    """The JAX CLI's flags, same spellings and defaults: ``(PipelineConfig,
    args)``."""
    from psana_ray_tpu_torch.autotune import add_autotune_args

    p = argparse.ArgumentParser(prog="python -m psana_ray_tpu_torch.producer")
    p.add_argument("--exp", default="synthetic",
                   help="synthetic[-*], replay:<path.npz|.npy>, or a psana experiment")
    p.add_argument("--run", type=int, default=1)
    p.add_argument("--detector_name", default="epix10k2M")
    p.add_argument("--calib", action="store_true",
                   help="calibrated mode (without it: the assembled image)")
    p.add_argument("--uses_bad_pixel_mask", action="store_true")
    p.add_argument("--manual_mask_path", default=None)
    p.add_argument("--ray_address", "--address", dest="address", default="auto",
                   help="auto (in-process), shm://[name], tcp://host:port or "
                        "cluster://host:port,... (or --cluster)")
    p.add_argument("--ray_namespace", "--namespace", dest="namespace", default="default")
    p.add_argument("--queue_name", default="shared_queue")
    p.add_argument("--queue_size", type=int, default=100)
    p.add_argument("--num_consumers", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--log_level", default="INFO")
    add_metrics_args(p)
    add_trace_args(p)
    add_history_args(p)
    add_profile_args(p)
    add_autotune_args(p)
    add_cluster_args(p)
    add_wire_args(p, producer=True)
    p.add_argument("--num_shards", type=int, default=1, help="local ingest workers")
    p.add_argument("--num_events", type=int, default=1024, help="synthetic events")
    p.add_argument(
        "--shard_rank_offset", type=int, default=None,
        help="global shard offset of this process (default: from the MPI/PMI/Slurm env)",
    )
    p.add_argument(
        "--total_shards", type=int, default=None,
        help="global shard count across all producer processes (default: from the env)",
    )
    p.add_argument("--start_event", type=int, default=0,
                   help="skip events below this index in every shard (resume floor)")
    p.add_argument(
        "--cursor_path", default=None,
        help="StreamCursor JSON written by a consumer (its --cursor_path): each shard "
             "resumes past its contiguous processed watermark (at least once)",
    )
    a = p.parse_args(argv)
    try:
        transport = apply_wire_args(apply_cluster_args(TransportConfig(
            address=a.address,
            namespace=a.namespace,
            queue_name=a.queue_name,
            queue_size=a.queue_size,
            num_consumers=a.num_consumers,
        ), a), a)
    except (TypeError, ValueError) as e:
        p.error(f"--cluster/--wire_codec/--wire_dtype: {e}")
    return PipelineConfig(
        source=SourceConfig(
            exp=a.exp,
            run=a.run,
            detector_name=a.detector_name,
            # as the reference: without --calib the mode is the assembled
            # image, not raw ADUs
            mode=RetrievalMode.CALIB if a.calib else RetrievalMode.IMAGE,
            max_steps=a.max_steps,
            num_events=a.num_events,
            start_event=a.start_event,
            cursor_path=a.cursor_path,
        ),
        mask=MaskConfig(a.uses_bad_pixel_mask, a.manual_mask_path),
        transport=transport,
    ), a


def detect_process_rank() -> tuple:
    """``(process_rank, world_size)`` from the launcher's environment
    (Open MPI, MPICH/PMI, Slurm), else ``(0, 1)``."""
    for rank_var, size_var in (
        ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"),
        ("PMI_RANK", "PMI_SIZE"),
        ("SLURM_PROCID", "SLURM_NTASKS"),
    ):
        if rank_var in os.environ:
            return int(os.environ[rank_var]), int(os.environ.get(size_var, 1))
    return 0, 1


def shard_topology(args) -> tuple:
    """``(shard_rank_offset, total_shards)`` of this process: the flags
    where given, else the launcher's rank and size times ``--num_shards``,
    so N processes of M local shards tile the global event space."""
    rank, world = detect_process_rank()
    offset = (
        args.shard_rank_offset
        if args.shard_rank_offset is not None
        else rank * args.num_shards
    )
    total = (
        args.total_shards if args.total_shards is not None else world * args.num_shards
    )
    return offset, total


def main(argv=None):
    from psana_ray_tpu_torch.utils.hostmem import enable_large_alloc_reuse

    enable_large_alloc_reuse()  # MB-scale frame buffers: heap reuse, no re-faulting
    config, args = parse_arguments(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format=config.log.fmt,
    )
    offset, total = shard_topology(args)
    runtime = ProducerRuntime(
        config,
        num_local_shards=args.num_shards,
        shard_rank_offset=offset,
        total_shards=total,
        stage_timing=args.metrics_port > 0,
    )

    def _sigint(signum, frame):
        logger.info("SIGINT — stopping producer")
        runtime.stop()

    signal.signal(signal.SIGINT, _sigint)
    MetricsRegistry.default().register("producer", runtime.metrics)
    metrics_server = start_metrics_server(args.metrics_port, host=args.metrics_host)
    history = configure_history_from_args(args)
    # the cost model divides by the frames sent: a TCP put copies nothing
    configure_profiling_from_args(args, "producer",
                                  frames_fn=lambda: runtime.metrics.frames.count,
                                  bytes_fn=wire_bytes)
    monitor = None
    observed = (metrics_server is not None or history is not None or args.trace_dir
                or args.flight_dir)
    if observed and str(config.transport.address).startswith(("tcp://", "cluster://")):
        # the depth for scrapes, history samples and flight dumps over a
        # connection of its own: on the data connection a stats() probe
        # waits behind a put held by backpressure or a reconnect, and a
        # dump asked for during a stall would wait for the stall's end
        try:
            monitor = open_queue(config.transport, role="consumer",
                                 address=config.transport.address)
            runtime.metrics.attach_queue(monitor)
        except Exception as e:  # noqa: BLE001 (the depth is optional)
            logger.debug("queue monitor unavailable: %s", e)
    tracer = configure_from_args(args, "producer", queue=monitor)
    # autotune: the put window and the wire codec on/off, judged by the
    # produce rate; an explicit --wire_codec (a name or "none") pins the
    # codec's knob ("auto" delegates, "" is the default)
    autotune = None
    if args.autotune != "off":
        from psana_ray_tpu_torch.autotune import Objective, configure_autotune_from_args
        from psana_ray_tpu_torch.autotune.knobs import put_window_knob, wire_codec_knob

        q = runtime.bootstrap()
        pinned = {}
        wc = config.transport.wire_codec
        if wc and wc != "auto":
            pinned["wire_codec_on"] = "--wire_codec set explicitly"
        autotune = configure_autotune_from_args(
            args, [put_window_knob(q), wire_codec_knob(q)], Objective("producer.frames_total"),
            pinned=pinned)
    try:
        if tracer is not None and monitor is None:
            # the clock exchanges over the data connection, before the stream
            exchange_anchors(runtime.bootstrap())
        runtime.run(block=True)
    finally:
        if autotune is not None:
            autotune.stop()
        queue = runtime._queue
        if hasattr(queue, "flush_puts"):  # TCP, a cluster: a clean goodbye to the servers
            queue.disconnect()
        if history is not None:
            history.stop()
        if metrics_server is not None:
            metrics_server.close()
        if monitor is not None and hasattr(monitor, "disconnect"):
            try:
                monitor.disconnect()
            except Exception:  # noqa: BLE001 (already closing)
                pass
    logger.info("producer done: %s", runtime.metrics.status_line())


if __name__ == "__main__":
    main()
