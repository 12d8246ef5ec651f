"""Consumer client and CLI: the reference's ``DataReader`` surface.

The port's copy of ``psana_ray_tpu/consumer.py`` over the port's
transports (``auto``/``local``, ``shm://``, ``tcp://`` and ``cluster://``):

- ``DataReader(address, queue_name, namespace)``, a context manager;
  ``connect()`` resolves the named queue with the config's retry loop;
- ``read()``: one item, or None when the queue is momentarily empty;
  ``read_wait(timeout)`` blocks; the end of the stream is a typed
  :class:`EndOfStream`, never None;
- ``iter_records()`` yields frames until EOS markers cover every shard
  of every producer runtime, handing sibling consumers' markers back;
- ``DataReader(streaming=True, stream_window=W)`` subscribes a TCP
  connection (each of a cluster's partition connections) to server-push
  delivery with W frames of credit;
- a dead transport raises :class:`DataReaderError`.

The CLI, with the JAX command's flags, defaults and log lines:

    python -m psana_ray_tpu_torch.consumer 0 --address tcp://ingest-head:6379 \\
        --stream --wire_codec auto --status_interval 1

It logs a line a frame (``--quiet`` drops them; at ``--log_level DEBUG``
another with the CRC-32 of the frame's panels, and the connection's
wire codec once), a metrics heartbeat
every ``--status_interval`` seconds, and ``end of stream after N
frames``; ``--cursor_path`` keeps a resumable cursor and
``--profile_dir`` captures a ``torch.profiler`` trace of the consume
loop (the only path that loads torch) and gets the continuous profiler's
spool (``--profile_hz``, 97 by default, 0 off) beside it. ``--stream`` and
``--stream_window`` subscribe to server-push delivery over ``tcp://``
and ``cluster://`` (ignored elsewhere, as the JAX package does);
``--wire_codec``, ``--tenant`` and ``--tenant_weight`` ride the TCP
connections' capability exchange. ``--replay from=<offset|begin|resume>``
(with ``--replay_group``) reads a durable queue server's retained log
over ``tcp://`` or ``cluster://`` without popping the live queue.
``--cluster host:port,host:port --partitions P`` reads a sharded queue,
``--group`` and ``--member_id`` as a member of a consumer group (one EOS
a member). ``--metrics_port`` serves the consumer's metrics (with the
wall-clock queue dwell of each frame), ``--history_interval`` samples
them, ``--trace_dir`` spools a ``dequeue`` span for each sampled frame
(after clock exchanges with the queue server over a connection of its
own) and ``--flight_dir`` arms the flight recorder; the heartbeat line
ends with the tracer's and the flight recorder's counts. ``--autotune
on|observe`` tunes the receive pool's retention floor and the stream
credit window (``--stream``) or the wire codec (pull mode), judged by the
consume rate; an explicit ``--stream_window`` or ``--wire_codec`` pins its
knob.
"""

from __future__ import annotations

import time
from typing import Any, Optional

from psana_ray_tpu_torch.config import TransportConfig
from psana_ray_tpu_torch.obs.flight import FLIGHT
from psana_ray_tpu_torch.obs.profiling.stagetag import TAG_DEQUEUE, set_stage, swap_stage
from psana_ray_tpu_torch.records import EosTally, is_eos
from psana_ray_tpu_torch.transport import EMPTY, RendezvousTimeout, TransportClosed


class DataReaderError(RuntimeError):
    """The transport died, or the queue was never found."""


class DataReader:
    def __init__(
        self,
        address: str = "auto",
        queue_name: Optional[str] = None,
        namespace: Optional[str] = None,
        config: Optional[TransportConfig] = None,
        streaming: bool = False,
        stream_window: int = 32,
        replay_from: Optional[str] = None,
        replay_group: Optional[str] = None,
    ):
        """``streaming=True`` subscribes a TCP connection to server-push
        delivery with ``stream_window`` frames of credit (reads drain the
        pushes; frames read and not yet acked redeliver to another
        consumer if this one dies); ignored on transports without
        streaming. ``replay_from`` (``"begin"``, ``"resume"`` or an
        offset; default the config's) reads a durable queue server's
        retained log over ``tcp://`` for the consumer group
        ``replay_group``, non-destructively: live consumers keep their
        frames, and what this reader consumed is committed for its group,
        so a crashed reader resumes with ``"resume"``. Replay is pull-mode
        (``streaming`` is ignored); a transport or queue without a log
        raises :class:`DataReaderError` at :meth:`connect`."""
        self.config = config or TransportConfig()
        self.address = address if address != "auto" else self.config.address
        self.queue_name = queue_name or self.config.queue_name
        self.namespace = namespace or self.config.namespace
        self.streaming = streaming
        self.stream_window = stream_window
        self.replay_from = (replay_from if replay_from is not None
                            else (self.config.replay_from or None))
        self.replay_group = replay_group or self.config.replay_group
        if self.replay_from is not None:
            self.streaming = False  # replay is pull-mode
        self._queue = None

    def _open(self):
        import dataclasses

        from psana_ray_tpu_torch.transport.addressing import open_queue

        cfg = dataclasses.replace(
            self.config, queue_name=self.queue_name, namespace=self.namespace
        )
        return open_queue(cfg, role="consumer", address=self.address)

    def connect(self) -> "DataReader":
        if self._queue is not None:
            return self
        try:
            self._queue = self._open()
        except RendezvousTimeout as e:
            raise DataReaderError(f"could not find queue {self.queue_name!r}: {e}") from e
        except TransportClosed as e:  # no queue server answered
            raise DataReaderError(f"could not reach queue {self.queue_name!r}: {e}") from e
        if self.replay_from is not None:
            try:
                if not hasattr(self._queue, "replay_open"):
                    raise DataReaderError(f"transport {self.address!r} does not support replay "
                                          f"(need a tcp:// or cluster:// durable queue server)")
                start = (self.replay_from if self.replay_from in ("begin", "resume")
                         else int(self.replay_from))
                self._queue.replay_open(start, group=self.replay_group)
            except (RuntimeError, ValueError) as e:  # DataReaderError, TransportClosed too
                q, self._queue = self._queue, None
                if hasattr(q, "disconnect"):
                    q.disconnect()
                if isinstance(e, DataReaderError):
                    raise
                raise DataReaderError(str(e)) from e
        if self.streaming and hasattr(self._queue, "stream_open"):
            try:
                self._queue.stream_open(self.stream_window)
            except TransportClosed as e:
                raise DataReaderError(str(e)) from e
        return self

    @property
    def queue(self) -> Any:
        """The transport handle once connected (None before)."""
        return self._queue

    def close(self):
        q = self._queue
        self._queue = None
        if q is not None and hasattr(q, "disconnect"):
            q.disconnect()

    def __enter__(self) -> "DataReader":
        return self.connect()

    def __exit__(self, *exc):
        self.close()

    # Over ``shm://`` a frame's panels are the reader's own copy: the
    # zero-copy slot views are the batcher's (``get_batch_view``). The
    # profiler bills each read to "dequeue".
    def read(self) -> Any:
        """Non-blocking read: FrameRecord | EndOfStream | None (empty)."""
        self._check_connected()
        prev = swap_stage(TAG_DEQUEUE)
        try:
            item = self._queue.get()
        except TransportClosed as e:
            raise DataReaderError(str(e)) from e
        finally:
            set_stage(prev)
        return None if item is EMPTY else item

    def read_wait(self, timeout: Optional[float] = None) -> Any:
        """Blocking read; None only on timeout."""
        self._check_connected()
        prev = swap_stage(TAG_DEQUEUE)
        try:
            item = self._queue.get_wait(timeout=timeout)
        except TransportClosed as e:
            raise DataReaderError(str(e)) from e
        finally:
            set_stage(prev)
        return None if item is EMPTY else item

    def read_batch(self, max_items: int, timeout: Optional[float] = None) -> list:
        self._check_connected()
        prev = swap_stage(TAG_DEQUEUE)
        try:
            return self._queue.get_batch(max_items, timeout=timeout)
        except TransportClosed as e:
            raise DataReaderError(str(e)) from e
        finally:
            set_stage(prev)

    def __iter__(self):
        """Iterate FrameRecords until the stream completes."""
        return self.iter_records()

    def iter_records(self, stop=None):
        """Yield FrameRecords until the stream completes or ``stop()``
        returns True (checked between reads, so stopping never discards a
        frame a sibling consumer could have had).

        With several producer runtimes on one queue, the stream completes
        once EOS markers cover every global shard (:class:`EosTally`);
        markers meant for sibling consumers are held and put back, never
        dropped, even against a full queue."""
        self._check_connected()
        tally = EosTally()
        try:
            while not (stop is not None and stop()):
                item = self.read_wait(timeout=1.0)
                if item is None:
                    # starved while holding a sibling's marker: put it back
                    # now, or two consumers each holding the other's marker
                    # wait for ever. After putting markers back, sleep
                    # before the next read: the put and this thread's next
                    # pop share one GIL slice, and without the yield it
                    # takes its own marker back before the blocked sibling
                    # wakes (a measured livelock of 60 s and more)
                    if tally.flush_duplicates(self._queue):
                        time.sleep(0.05)
                    continue
                tally.flush_duplicates(self._queue)  # a slot just freed
                if is_eos(item):
                    if tally.process(item):
                        FLIGHT.record("eos_complete", queue=self.queue_name)
                        return
                    continue
                yield item
        finally:
            tally.flush_duplicates(self._queue, final=True)

    def size(self) -> int:
        self._check_connected()
        try:
            return self._queue.size()
        except TransportClosed as e:
            raise DataReaderError(str(e)) from e

    def open_monitor(self):
        """A second handle on the queue for metrics polling, apart from
        the data handle the reads use."""
        return self._open()

    def _check_connected(self):
        if self._queue is None:
            raise DataReaderError("not connected — call connect() or use as context manager")


def _configure_autotune(a, p, reader):
    """The consumer's knobs: the receive pool's retention floor, and the
    stream credit window under ``--stream`` or the wire codec in pull mode
    (a streamed connection's codec is decided at each connect), judged by
    the consume rate. An explicit ``--stream_window`` pins its knob, as
    does an explicit ``--wire_codec`` (a name or "none"; "auto"
    delegates)."""
    from psana_ray_tpu_torch.autotune import Objective, configure_autotune_from_args
    from psana_ray_tpu_torch.autotune.knobs import (
        bufpool_retention_knob,
        stream_window_knob,
        wire_codec_knob,
    )
    from psana_ray_tpu_torch.utils.bufpool import BufferPool

    knobs = [bufpool_retention_knob(BufferPool.default())]
    pinned = {}
    if a.stream:
        knobs.append(stream_window_knob(reader.queue))
        if a.stream_window != p.get_default("stream_window"):
            pinned["stream_window"] = "--stream_window set explicitly"
    else:
        knobs.append(wire_codec_knob(reader.queue))
        if a.wire_codec and a.wire_codec != "auto":
            pinned["wire_codec_on"] = "--wire_codec set explicitly"
    return configure_autotune_from_args(a, knobs, Objective("consumer.frames_total"),
                                        pinned=pinned)


def main(argv=None):
    """The console consumer: reads the stream to its end, logging each
    frame, with typed EOS termination. Returns the exit code."""
    import argparse
    import logging
    import signal
    import threading

    from psana_ray_tpu_torch.utils.hostmem import enable_large_alloc_reuse

    enable_large_alloc_reuse()  # MB-scale frame buffers: heap reuse, no re-faulting
    p = argparse.ArgumentParser(prog="python -m psana_ray_tpu_torch.consumer")
    p.add_argument("consumer_id", type=int, nargs="?", default=0)
    p.add_argument("--ray_address", "--address", dest="address", default="auto",
                   help="auto (in-process), shm://[name], tcp://host:port or "
                        "cluster://host:port,... (or --cluster)")
    p.add_argument("--ray_namespace", "--namespace", dest="namespace", default="default")
    p.add_argument("--queue_name", default="shared_queue")
    p.add_argument("--stream", action="store_true",
                   help="subscribe to server-push streaming (tcp://, cluster://); ignored on auto "
                        "and shm://")
    p.add_argument("--stream_window", type=int, default=32,
                   help="streaming credit window (TCP transports)")
    p.add_argument("--replay", default=None, metavar="from=<offset|begin|resume>",
                   help="read a durable queue server's retained log (tcp://, cluster://) "
                        "instead of the live queue: from=begin replays all it retains, "
                        "from=resume continues after --replay_group's committed offset, from=N "
                        "starts at offset N")
    p.add_argument("--replay_group", default="replay",
                   help="consumer group whose committed offset --replay advances")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--quiet", action="store_true", help="suppress per-frame lines")
    p.add_argument("--log_level", default="INFO")
    p.add_argument("--profile_dir", default=None,
                   help="capture a torch.profiler trace of the consume loop into a "
                        "timestamped subdirectory of this directory (Chrome trace format), "
                        "and write the continuous profiler's spool beside it")
    p.add_argument("--status_interval", type=float, default=0.0,
                   help="log a metrics heartbeat (frames/s, Gbit/s, queue depth) every N "
                        "seconds; 0 = off")
    p.add_argument(
        "--cursor_path", default=None,
        help="persist a StreamCursor (contiguous per-shard watermark of processed events) "
             "here; a restarted producer with the same --cursor_path resumes past it (at "
             "least once). Give each competing consumer its own file",
    )
    p.add_argument("--cursor_stride", type=int, default=1,
                   help="total producer shards feeding this stream (the producer's "
                        "total_shards)")
    p.add_argument("--cursor_save_every", type=int, default=32,
                   help="persist the cursor every N processed frames (and at exit); <= 0 "
                        "saves at exit only")
    from psana_ray_tpu_torch.transport.addressing import (
        add_cluster_args,
        add_tenant_args,
        add_wire_args,
        apply_cluster_args,
        apply_tenant_args,
        apply_wire_args,
    )
    from psana_ray_tpu_torch.obs.exporter import add_metrics_args
    from psana_ray_tpu_torch.obs.profiling import add_profile_args
    from psana_ray_tpu_torch.obs.timeseries import add_history_args
    from psana_ray_tpu_torch.obs.tracing import add_trace_args
    from psana_ray_tpu_torch.autotune import add_autotune_args

    add_metrics_args(p)
    add_trace_args(p)
    add_history_args(p)
    add_profile_args(p)  # takes --profile_hz; --profile_dir is the parser's already
    add_autotune_args(p)
    add_cluster_args(p, consumer=True)
    add_wire_args(p)
    add_tenant_args(p)
    a = p.parse_args(argv)
    try:
        # --cluster rewrites the address and carries the partitions and group
        reader_config = apply_tenant_args(apply_wire_args(
            apply_cluster_args(TransportConfig(address=a.address), a), a), a)
    except (TypeError, ValueError) as e:
        p.error(str(e))
    a.address = reader_config.address
    logging.basicConfig(
        level=getattr(logging, a.log_level.upper(), logging.INFO),
        format="%(asctime)s - %(levelname)s - %(message)s",
    )
    log = logging.getLogger("consumer")

    stop = False

    def _sigint(sig, frame):
        nonlocal stop
        stop = True

    signal.signal(signal.SIGINT, _sigint)
    n = 0

    def _should_stop():
        # checked between reads: stopping never discards a frame already read
        return stop or (a.max_frames is not None and n >= a.max_frames)

    from psana_ray_tpu_torch.utils.trace import trace

    cursor = None
    if a.cursor_path:
        from psana_ray_tpu_torch.checkpoint import StreamCursor

        cursor = StreamCursor.load(a.cursor_path)
        if not cursor.positions:
            cursor.stride = a.cursor_stride
        elif cursor.stride != a.cursor_stride:
            log.error(
                "cursor %s has stride=%d but --cursor_stride=%d; refusing "
                "(wrong stride computes wrong watermarks and can skip data)",
                a.cursor_path, cursor.stride, a.cursor_stride,
            )
            return 1

    # per-frame counters always (they feed the final line); the heartbeat
    # thread, the endpoint and the history only when asked for, and after
    # every early return above
    from psana_ray_tpu_torch.obs.exporter import start_metrics_server
    from psana_ray_tpu_torch.obs.profiling import configure_profiling_from_args, wire_bytes
    from psana_ray_tpu_torch.obs.registry import MetricsRegistry
    from psana_ray_tpu_torch.obs.stages import STAGE_DEQUEUE, STAGE_QUEUE_DWELL
    from psana_ray_tpu_torch.obs.timeseries import configure_history_from_args
    from psana_ray_tpu_torch.obs.tracing import TRACER, configure_from_args, obs_status_suffix
    from psana_ray_tpu_torch.utils.metrics import PipelineMetrics

    metrics = PipelineMetrics()
    observe_dwell = a.status_interval > 0 or a.metrics_port > 0
    MetricsRegistry.default().register("consumer", metrics)
    metrics_server = start_metrics_server(a.metrics_port, host=a.metrics_host)
    history = configure_history_from_args(a)
    # a frame read over TCP is no WIRE copy: the cost model divides by the reads
    configure_profiling_from_args(a, "consumer", frames_fn=lambda: metrics.frames.count,
                                  bytes_fn=wire_bytes)
    heartbeat_done = threading.Event()
    heartbeat = None
    if a.status_interval > 0:
        def _heartbeat():
            # the suffix shows tracing on in a live run: rate, spans, events
            while not heartbeat_done.wait(a.status_interval):
                log.info("consumer %d status: %s%s", a.consumer_id, metrics.status_line(),
                         obs_status_suffix())

        heartbeat = threading.Thread(target=_heartbeat, daemon=True, name="consumer-heartbeat")
        heartbeat.start()

    # a checksum of every frame's panels, at DEBUG only: it reads each frame once more
    checksum = log.isEnabledFor(logging.DEBUG)
    if checksum:
        import zlib

        import numpy as np
    monitor = None
    autotune = None
    try:
        replay_from = None
        if a.replay is not None:
            replay_from = a.replay[5:] if a.replay.startswith("from=") else a.replay
            if replay_from not in ("begin", "resume") and not replay_from.isdigit():
                log.error("--replay wants from=<offset|begin|resume>, got %r", a.replay)
                return 1
        with trace(a.profile_dir), DataReader(
            address=a.address, queue_name=a.queue_name, namespace=a.namespace,
            config=reader_config,
            streaming=a.stream, stream_window=a.stream_window,
            replay_from=replay_from, replay_group=a.replay_group,
        ) as reader:
            if checksum:
                log.debug("consumer %d: wire codec %s", a.consumer_id,
                          getattr(reader.queue, "codec_name", None))
            if observe_dwell or a.trace_dir:
                # the depth, and the tracer's clock exchanges, over a handle
                # of its own: an op on the data connection acks its deliveries
                try:
                    monitor = reader.open_monitor()
                    metrics.attach_queue(monitor)
                except Exception as e:  # noqa: BLE001 (depth is optional)
                    log.debug("queue monitor unavailable: %s", e)
            configure_from_args(a, "consumer", queue=monitor)
            if a.autotune != "off":
                autotune = _configure_autotune(a, p, reader)
            try:
                for rec in reader.iter_records(stop=_should_stop):
                    t_rec = time.monotonic()
                    n += 1
                    metrics.observe_frame(rec.nbytes)
                    rec_trace = rec.trace
                    if observe_dwell and rec.timestamp:
                        # wall-clock dwell, the producer's stamp to this read;
                        # a sampled frame's trace id is its bucket's exemplar
                        metrics.stages.observe(
                            STAGE_QUEUE_DWELL, max(0.0, time.time() - rec.timestamp),
                            exemplar=rec_trace.trace_id
                            if rec_trace is not None and rec_trace.sampled else None)
                    if not a.quiet:
                        log.info(
                            "consumer %d: rank=%d idx=%d shape=%s energy=%.2f",
                            a.consumer_id, rec.shard_rank, rec.event_idx,
                            rec.panels.shape, rec.photon_energy,
                        )
                    if checksum:
                        log.debug("consumer %d: rank=%d idx=%d crc32=%08x", a.consumer_id,
                                  rec.shard_rank, rec.event_idx,
                                  zlib.crc32(np.ascontiguousarray(rec.panels)))
                    if cursor is not None:
                        # after the record is handled: the watermark never
                        # runs ahead; ValueError is a stride misconfiguration
                        cursor.advance(rec.shard_rank, rec.event_idx)
                        if a.cursor_save_every > 0 and n % a.cursor_save_every == 0:
                            cursor.save(a.cursor_path)
                    if rec_trace is not None and rec_trace.sampled and TRACER.enabled:
                        # read done -> the record handled (log line, cursor)
                        TRACER.span(rec_trace.trace_id, STAGE_DEQUEUE, t_rec, time.monotonic())
            finally:
                if cursor is not None:
                    cursor.save(a.cursor_path)
        log.info(
            "consumer %d: end of stream after %d frames (%s)",
            a.consumer_id, n, metrics.status_line(),
        )
    except DataReaderError as e:
        log.error("consumer %d: queue is dead (%s); exiting", a.consumer_id, e)
        return 1
    except ValueError as e:  # cursor stride/shard misconfiguration
        log.error("consumer %d: %s", a.consumer_id, e)
        return 1
    finally:
        heartbeat_done.set()
        if autotune is not None:
            autotune.stop()
        if history is not None:
            history.stop()
        if heartbeat is not None:
            heartbeat.join(timeout=1.0)
        if metrics_server is not None:
            metrics_server.close()
        metrics.attach_queue(None)  # the monitor handle is about to go
        if monitor is not None and hasattr(monitor, "disconnect"):
            try:
                monitor.disconnect()
            except Exception:  # noqa: BLE001 (already closing)
                pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
