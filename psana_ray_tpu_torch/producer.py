"""Producer runtime and CLI: sharded ingest into a named, backpressured queue.

The port's copy of ``psana_ray_tpu/producer.py`` over the port's
transports (``auto``/``local`` and ``shm://``). :class:`ProducerRuntime`
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
        --address shm://run42 --num_shards 2 --num_consumers 2

The JAX CLI's obs, autotune, cluster and wire-codec flags are refused
(ROADMAP.md Queue 1 Item 8), as are ``tcp://`` and ``cluster://``
addresses. Also here: :func:`produce`, the inner loop alone, and
:func:`produce_synthetic`, a ``spawn`` producer process that feeds a
named shm ring from a seeded :class:`SyntheticSource`.

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
from psana_ray_tpu_torch.records import EndOfStream, FrameRecord, narrow_panels, validate_wire_dtype
from psana_ray_tpu_torch.sources import SyntheticSource, open_source
from psana_ray_tpu_torch.transport import BackoffPolicy, Registry, TransportClosed, TransportWedged
from psana_ray_tpu_torch.transport.addressing import open_queue
from psana_ray_tpu_torch.transport.shm_ring import ShmRingBuffer
from psana_ray_tpu_torch.utils.cli import add_refused_flags, refuse_unported
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
    full), then one EOS covering this shard. Returns the events put.
    ``events`` is e.g. ``SyntheticSource.iter_indexed_events("raw")``.
    Raises ``TimeoutError`` if a put waits longer than ``timeout``."""
    n = 0
    for idx, panels, energy in events:
        rec = FrameRecord(shard_rank, int(idx), panels, float(energy), time.time())
        if not queue.put_wait(rec, timeout=timeout):
            raise TimeoutError(f"queue full for {timeout} s at event {idx}")
        n += 1
    eos = EndOfStream(producer_rank=shard_rank, total_events=n, total_shards=total_shards)
    if not queue.put_wait(eos, timeout=timeout):
        raise TimeoutError(f"queue full for {timeout} s at end of stream")
    return n


def produce_synthetic(
    ring_name: str,
    detector_name: str,
    n_events: int,
    pool_events: int,
    seed: int = 0,
    dtype: str = "float32",
    produced=None,
    run: int = 1,
) -> int:
    """A producer process's body, for ``multiprocessing``'s ``spawn``
    start method: attach to the shm ring ``ring_name``, draw the RAW
    events ``0 .. pool_events - 1`` of ``SyntheticSource(detector_name,
    seed, dtype, run)``, put ``n_events`` of them (the pool cycled, event
    index ``i`` carrying pool event ``i % pool_events``) and one EOS, then
    detach. ``produced`` (a ``multiprocessing.Value``) receives the count."""
    src = SyntheticSource(run=run, num_events=pool_events, detector_name=detector_name,
                          seed=seed, dtype=dtype)
    pool = [src.event(i, "raw") for i in range(pool_events)]
    ring = ShmRingBuffer.attach(ring_name, retries=100, interval_s=0.1)
    try:
        events = ((i, *pool[i % pool_events]) for i in range(n_events))
        n = produce(events, ring, timeout=120.0)
    finally:
        ring.disconnect()
    if produced is not None:
        produced.value = n
    return n


class _Sender:
    """Backpressured frame sender: ``put_batch`` of up to ``batch_size``
    records where the transport has it, one ``put`` a record otherwise
    (the port's transports: a put is a memcpy). A refused or partly
    accepted put waits the backoff and retries the rest, in order. The
    TCP transport's windowed sender is not ported (ROADMAP.md Queue 1
    Item 8)."""

    def __init__(self, queue, backoff, stop_event, metrics, batch_size: int = 16):
        self.queue = queue
        self.backoff = backoff
        self.stop = stop_event
        self.metrics = metrics
        self.batch_size = batch_size if hasattr(queue, "put_batch") else 1
        self.pending: List[FrameRecord] = []

    def send(self, rec) -> bool:
        """Buffer ``rec`` and flush when the buffer is full. False: the
        transport closed or the runtime stopped."""
        self.pending.append(rec)
        if len(self.pending) >= self.batch_size:
            return self.flush()
        return True

    def flush(self) -> bool:
        """Put every buffered record with the backoff envelope. False: the
        transport closed or the runtime stopped (records may remain
        buffered; the stream is dead either way)."""
        while self.pending:
            if self.stop.is_set():
                return False
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
    ):
        self.config = config
        self.registry = registry or Registry.default()
        self.num_local_shards = num_local_shards
        self.shard_rank_offset = shard_rank_offset
        self.total_shards = total_shards or num_local_shards
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
                rec = FrameRecord(rank, int(idx), data, energy, timestamp=time.time())
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


# the JAX CLI's obs, autotune, cluster and wire-codec flags
NOT_PORTED_FLAGS = (
    "--metrics_host", "--metrics_port", "--trace_dir", "--trace_sample", "--flight_dir",
    "--history_interval", "--history_samples", "--profile_hz", "--profile_dir", "--cluster",
    "--partitions", "--wire_codec", "--autotune", "--autotune_interval",
)


def parse_arguments(argv=None):
    """The JAX CLI's flags, same spellings and defaults: ``(PipelineConfig,
    args)``. A flag of :data:`NOT_PORTED_FLAGS` exits non-zero naming
    ROADMAP.md Item 8."""
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
                   help="auto (in-process) or shm://[name]")
    p.add_argument("--ray_namespace", "--namespace", dest="namespace", default="default")
    p.add_argument("--queue_name", default="shared_queue")
    p.add_argument("--queue_size", type=int, default=100)
    p.add_argument("--num_consumers", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--log_level", default="INFO")
    p.add_argument("--wire_dtype", default="", metavar="DTYPE",
                   help="lossy, opt-in: narrow panels to this dtype before they are encoded "
                        "(uint16 halves f32 frames; integer targets round and clip)")
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
    add_refused_flags(p, NOT_PORTED_FLAGS)
    a = p.parse_args(argv)
    refuse_unported(p, a, NOT_PORTED_FLAGS,
                    "the obs, autotune, cluster and wire-codec modules")
    if a.wire_dtype:
        try:
            validate_wire_dtype(a.wire_dtype)
        except (TypeError, ValueError) as e:
            p.error(f"--wire_dtype: {e}")
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
        transport=TransportConfig(
            address=a.address,
            namespace=a.namespace,
            queue_name=a.queue_name,
            queue_size=a.queue_size,
            num_consumers=a.num_consumers,
            wire_dtype=a.wire_dtype,
        ),
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
    )

    def _sigint(signum, frame):
        logger.info("SIGINT — stopping producer")
        runtime.stop()

    signal.signal(signal.SIGINT, _sigint)
    runtime.run(block=True)
    logger.info("producer done: %s", runtime.metrics.status_line())


if __name__ == "__main__":
    main()
