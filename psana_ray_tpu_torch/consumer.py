"""Consumer client and CLI: the reference's ``DataReader`` surface.

The port's copy of ``psana_ray_tpu/consumer.py`` over the port's
transports (``auto``/``local`` and ``shm://``):

- ``DataReader(address, queue_name, namespace)``, a context manager;
  ``connect()`` resolves the named queue with the config's retry loop;
- ``read()``: one item, or None when the queue is momentarily empty;
  ``read_wait(timeout)`` blocks; the end of the stream is a typed
  :class:`EndOfStream`, never None;
- ``iter_records()`` yields frames until EOS markers cover every shard
  of every producer runtime, handing sibling consumers' markers back;
- a dead transport raises :class:`DataReaderError`.

The CLI, with the JAX command's flags, defaults and log lines:

    python -m psana_ray_tpu_torch.consumer 0 --address shm://run42 \\
        --status_interval 1 --profile_dir traces/

It logs a line a frame (``--quiet`` drops them), a metrics heartbeat
every ``--status_interval`` seconds, and ``end of stream after N
frames``; ``--cursor_path`` keeps a resumable cursor and
``--profile_dir`` captures a ``torch.profiler`` trace of the consume
loop (the only path that loads torch). The JAX CLI's obs, autotune,
cluster, tenant and wire-codec flags are refused (ROADMAP.md Queue 1 Item
8). ``--stream`` is taken and ignored, as the JAX package does on
transports without streaming; ``--replay`` needs a durable TCP queue
server and fails with ``DataReaderError``.
"""

from __future__ import annotations

import time
from typing import Any, Optional

from psana_ray_tpu_torch.config import TransportConfig
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
        """``streaming`` subscribes a TCP connection to server-push
        delivery; the port's transports have none, so it is ignored.
        ``replay_from`` (``"begin"``, ``"resume"`` or an offset) reads a
        durable queue server's retained log; no transport of the port has
        one, so :meth:`connect` raises :class:`DataReaderError`."""
        self.config = config or TransportConfig()
        self.address = address if address != "auto" else self.config.address
        self.queue_name = queue_name or self.config.queue_name
        self.namespace = namespace or self.config.namespace
        self.streaming = streaming
        self.stream_window = stream_window
        self.replay_from = replay_from
        self.replay_group = replay_group or "replay"
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
        if self.replay_from is not None and not hasattr(self._queue, "replay_open"):
            raise DataReaderError(
                f"transport {self.address!r} does not support replay "
                f"(need a tcp:// or cluster:// durable queue server)"
            )
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
    # zero-copy slot views are the batcher's (``get_batch_view``).
    def read(self) -> Any:
        """Non-blocking read: FrameRecord | EndOfStream | None (empty)."""
        self._check_connected()
        try:
            item = self._queue.get()
        except TransportClosed as e:
            raise DataReaderError(str(e)) from e
        return None if item is EMPTY else item

    def read_wait(self, timeout: Optional[float] = None) -> Any:
        """Blocking read; None only on timeout."""
        self._check_connected()
        try:
            item = self._queue.get_wait(timeout=timeout)
        except TransportClosed as e:
            raise DataReaderError(str(e)) from e
        return None if item is EMPTY else item

    def read_batch(self, max_items: int, timeout: Optional[float] = None) -> list:
        self._check_connected()
        try:
            return self._queue.get_batch(max_items, timeout=timeout)
        except TransportClosed as e:
            raise DataReaderError(str(e)) from e

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


# the JAX CLI's obs, autotune, cluster, tenant and wire-codec flags
NOT_PORTED_FLAGS = (
    "--metrics_host", "--metrics_port", "--trace_dir", "--trace_sample", "--flight_dir",
    "--history_interval", "--history_samples", "--profile_hz", "--cluster", "--partitions",
    "--group", "--member_id", "--wire_codec", "--tenant", "--tenant_weight", "--autotune",
    "--autotune_interval",
)


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
                   help="auto (in-process) or shm://[name]")
    p.add_argument("--ray_namespace", "--namespace", dest="namespace", default="default")
    p.add_argument("--queue_name", default="shared_queue")
    p.add_argument("--stream", action="store_true",
                   help="server-push streaming (TCP transports); ignored on auto and shm://")
    p.add_argument("--stream_window", type=int, default=32,
                   help="streaming credit window (TCP transports)")
    p.add_argument("--replay", default=None, metavar="from=<offset|begin|resume>",
                   help="read a durable TCP queue server's retained log (not ported: fails "
                        "on auto and shm://)")
    p.add_argument("--replay_group", default="replay",
                   help="consumer group whose committed offset --replay advances")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--quiet", action="store_true", help="suppress per-frame lines")
    p.add_argument("--log_level", default="INFO")
    p.add_argument("--profile_dir", default=None,
                   help="capture a torch.profiler trace of the consume loop into a "
                        "timestamped subdirectory of this directory (Chrome trace format)")
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
    from psana_ray_tpu_torch.utils.cli import add_refused_flags, refuse_unported

    add_refused_flags(p, NOT_PORTED_FLAGS)
    a = p.parse_args(argv)
    refuse_unported(p, a, NOT_PORTED_FLAGS,
                    "the obs, autotune, cluster, tenant and wire-codec modules")
    logging.basicConfig(
        level=getattr(logging, a.log_level.upper(), logging.INFO),
        format="%(asctime)s - %(levelname)s - %(message)s",
    )
    log = logging.getLogger("consumer")
    reader_config = TransportConfig(address=a.address)

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
    # thread only when asked for, and after every early return above
    from psana_ray_tpu_torch.obs.stages import STAGE_QUEUE_DWELL
    from psana_ray_tpu_torch.utils.metrics import PipelineMetrics

    metrics = PipelineMetrics()
    heartbeat_done = threading.Event()
    heartbeat = None
    if a.status_interval > 0:
        def _heartbeat():
            while not heartbeat_done.wait(a.status_interval):
                log.info("consumer %d status: %s", a.consumer_id, metrics.status_line())

        heartbeat = threading.Thread(target=_heartbeat, daemon=True, name="consumer-heartbeat")
        heartbeat.start()

    monitor = None
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
            if a.status_interval > 0:
                # depth in the heartbeat, over a handle of its own
                try:
                    monitor = reader.open_monitor()
                    metrics.attach_queue(monitor)
                except Exception as e:  # noqa: BLE001 (depth is optional)
                    log.debug("queue monitor unavailable: %s", e)
            try:
                for rec in reader.iter_records(stop=_should_stop):
                    n += 1
                    metrics.observe_frame(rec.nbytes)
                    if a.status_interval > 0 and rec.timestamp:
                        # wall-clock dwell, the producer's stamp to this read
                        metrics.stages.observe(STAGE_QUEUE_DWELL,
                                               max(0.0, time.time() - rec.timestamp))
                    if not a.quiet:
                        log.info(
                            "consumer %d: rank=%d idx=%d shape=%s energy=%.2f",
                            a.consumer_id, rec.shard_rank, rec.event_idx,
                            rec.panels.shape, rec.photon_energy,
                        )
                    if cursor is not None:
                        # after the record is handled: the watermark never
                        # runs ahead; ValueError is a stride misconfiguration
                        cursor.advance(rec.shard_rank, rec.event_idx)
                        if a.cursor_save_every > 0 and n % a.cursor_save_every == 0:
                            cursor.save(a.cursor_path)
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
        if heartbeat is not None:
            heartbeat.join(timeout=1.0)
        metrics.attach_queue(None)  # the monitor handle is about to go
        if monitor is not None and hasattr(monitor, "disconnect"):
            try:
                monitor.disconnect()
            except Exception:  # noqa: BLE001 (already closing)
                pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
