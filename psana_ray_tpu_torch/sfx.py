"""SFX serving pipeline: stream -> calibrate -> PeakNet-TPU -> peaks -> CXI.

Counterpart of the library surface of ``psana_ray_tpu/sfx.py``
(``SfxConfig``, ``DEFAULT_THRESHOLDS``, ``infer_s2d``, ``infer_features``,
``SfxPipeline``):

    queue -> batcher -> pinned staging -> fused_calibrate (calib_kernel,
    bf16) -> panels_to_nhwc("batch") -> peaknet_tpu_fused_infer (the
    conv_block_kernel levels) -> find_peaks -> host fold -> writer

Only the small ``(yx, score, n)`` tensors come back to the host, with a
non-blocking copy into pinned memory behind an event. The loop keeps one
batch in flight: batch N's device work is enqueued before batch N-1's
peaks are folded into raw coordinates and appended on the host. The
per-row metadata (``valid``, ``event_idx``, ``shard_rank``,
``photon_energy``) never goes to the card.

Coordinates (``peakYPosRaw``/``peakXPosRaw``): the vertically stacked
panel layout, ``y_raw = panel * H + y_panel``, ``x_raw = x_panel``.
Resume is at least once through
:class:`~psana_ray_tpu_torch.checkpoint.StreamCursor`.

The operator CLI, with the JAX package's flags and refusals:

    python -m psana_ray_tpu_torch.sfx --address shm://sfx \
        --serving_params serving.npz --output run42.cxi \
        --cursor_path run42.cursor --cursor_stride 4

It reads the stream over ``auto``, ``shm://`` or ``tcp://`` addresses
(a queue server's connection, with no codec negotiated), or from a
cluster of queue servers (``--cluster host:port,host:port --partitions P``,
``--group`` and ``--member_id`` for a consumer group), serves a
parameter file of the port (an orbax tree of the JAX package goes
through ``tools/convert_params.py`` first) and writes CXI.
``--metrics_port`` serves the pipeline's metrics as the ``sfx`` source,
``--history_interval`` samples them, ``--trace_dir`` spools the spans of
each sampled frame at its batch's dispatch, ``--flight_dir`` arms the
flight recorder and ``--profile_hz`` (97 by default, 0 off) runs the
continuous profiler for the run, its spool written into
``--profile_dir``, and ``--autotune on|observe`` tunes the drain's pop
size and poll interval and the receive pool's retention floor, judged by
the event rate, as in the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import os
import signal
import threading
import time
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from psana_ray_tpu_torch.checkpoint import StreamCursor, load_params
from psana_ray_tpu_torch.config import TransportConfig
from psana_ray_tpu_torch.convert import infer_features, infer_s2d, unet_from_flax
from psana_ray_tpu_torch.cxi import CxiWriter, PeakSet, unpad_peaks
from psana_ray_tpu_torch.device import resolve_device
from psana_ray_tpu_torch.infeed import InfeedPipeline
from psana_ray_tpu_torch.models.fused_unet import pack_unet, peaknet_tpu_fused_infer
from psana_ray_tpu_torch.models.heads import panels_to_nhwc
from psana_ray_tpu_torch.models.peaks import find_peaks
from psana_ray_tpu_torch.obs.exporter import add_metrics_args, start_metrics_server
from psana_ray_tpu_torch.obs.profiling import (
    add_profile_args,
    configure_profiling_from_args,
    default_profiler,
    stop_default_profiler,
    wire_bytes,
)
from psana_ray_tpu_torch.obs.registry import MetricsRegistry
from psana_ray_tpu_torch.obs.stages import RANGE_DRAIN, RANGE_SYNC, STAGE_DISPATCH
from psana_ray_tpu_torch.obs.timeseries import add_history_args, configure_history_from_args
from psana_ray_tpu_torch.obs.tracing import add_trace_args, configure_from_args, emit_batch_spans
from psana_ray_tpu_torch.ops.fused_calib import fused_calibrate
from psana_ray_tpu_torch.transport.addressing import (
    add_cluster_args,
    apply_cluster_args,
    open_queue,
)
from psana_ray_tpu_torch.transport.registry import TransportClosed
from psana_ray_tpu_torch.utils.hostmem import enable_large_alloc_reuse
from psana_ray_tpu_torch.utils.metrics import PipelineMetrics
from psana_ray_tpu_torch.utils.trace import annotate, annotate_stage

__all__ = ["DEFAULT_THRESHOLDS", "SfxConfig", "SfxPipeline", "infer_features", "infer_s2d", "main",
           "parse_args", "run"]


@dataclasses.dataclass
class SfxConfig:
    """Knobs of the pipeline."""

    batch_size: int = 8  # frames per device step (128 panel-rows of epix10k2M)
    peak_threshold: float = 0.5  # sigmoid probability floor of a peak
    max_peaks: int = 128  # per-panel candidates of find_peaks; per event: writer.max_peaks
    min_distance: int = 2  # local-maximum window radius
    calib_threshold: float = 10.0  # common-mode threshold of fused_calibrate


# batches staged ahead of the one computing; InfeedPipeline's floor of
# pooled arenas is PREFETCH_DEPTH + 4
PREFETCH_DEPTH = 2

# find_peaks thresholds by s2d factor (the JAX package's calibrated defaults)
DEFAULT_THRESHOLDS = {2: 0.5, 4: 0.5}


class Pending(NamedTuple):
    """A dispatched batch: its peaks (in pinned host memory behind
    ``event`` on the card), the host batch and when it was dispatched."""

    t0: float
    nbytes: int
    peaks: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    event: Optional[Any]
    batch: Any


class SfxPipeline:
    """The stream -> CXI serving loop.

    ``variables`` is the frozen-affine PeakNet-TPU serving tree (nested
    dicts of arrays, with or without a ``"params"`` level); features and
    s2d come from it, and an explicit ``features`` that differs is
    refused. ``writer`` has ``max_peaks`` and ``append(peak_sets)`` (a
    :class:`~psana_ray_tpu_torch.cxi.CxiWriter`). ``calib`` is a
    ``(pedestal, gain, mask)`` triple of ``[P, H, W]`` arrays for streams
    of RAW ADUs; omit it for calibrated streams. ``device``: the card
    unless ``"cpu"`` is passed.
    """

    def __init__(
        self,
        variables,
        writer,
        features: Optional[Tuple[int, ...]] = None,
        calib: Optional[tuple] = None,
        config: Optional[SfxConfig] = None,
        device=None,
    ):
        self.cfg = config or SfxConfig()
        self.writer = writer
        params = variables.get("params", variables)
        self.s2d = infer_s2d(params)
        self.features = infer_features(params)
        if features is not None and tuple(features) != self.features:
            raise ValueError(
                f"features={tuple(features)} does not match the checkpoint (trained with "
                f"{self.features}); the widths are a property of the tree"
            )
        self.device = resolve_device(device)
        self.model = unet_from_flax(params, device=self.device)
        self.params = pack_unet(self.model)
        self._calib = None
        if calib is not None:
            self._calib = tuple(torch.as_tensor(np.asarray(a)).to(self.device) for a in calib)
        self.n_events = 0
        self.n_peaks = 0
        self.metrics = PipelineMetrics()
        self.batcher = None  # the last run's FrameBatcher (its pooled arenas)

    @torch.no_grad()
    def device_step(self, frames: torch.Tensor):
        """``[B, P, H, W]`` raw-or-calibrated frames on the device ->
        panel-row peaks ``(yx [B*P, K, 2], score [B*P, K], n [B*P])``."""
        x = frames
        if self._calib is not None:
            ped, gain, mask = self._calib
            x = fused_calibrate(x, ped, gain, mask, threshold=self.cfg.calib_threshold,
                                out_dtype=torch.bfloat16)
        logits = peaknet_tpu_fused_infer(self.params, panels_to_nhwc(x, mode="batch"))
        return find_peaks(logits, max_peaks=self.cfg.max_peaks,
                          threshold=self.cfg.peak_threshold,
                          min_distance=self.cfg.min_distance)

    def dispatch(self, batch) -> Pending:
        """Enqueue one batch's device step and the copy of its peaks into
        pinned host memory, without waiting; :meth:`drain` takes the
        handle. ``batch.frames`` may be a device tensor or host numpy; the
        metadata stays on the host. A ``stage.dispatch`` range."""
        t0 = time.monotonic()
        with annotate_stage(STAGE_DISPATCH):
            frames = torch.as_tensor(batch.frames, device=self.device)
            nbytes = frames.numel() * frames.element_size()
            out = self.device_step(frames)
            if self.device.type != "cuda":
                return Pending(t0, nbytes, out, None, batch)
            host = tuple(torch.empty(a.shape, dtype=a.dtype, pin_memory=True) for a in out)
            for h, a in zip(host, out):
                h.copy_(a, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return Pending(t0, nbytes, host, event, batch)

    @annotate(RANGE_DRAIN)
    def drain(self, pending: Pending, cursor=None) -> int:
        """Wait for a :meth:`dispatch` handle and append its real events to
        the writer; returns the events appended. Padding rows never reach
        the writer; the cursor advances only after the append. A
        ``stage.drain`` range, its wait on the card a ``stage.sync`` range."""
        if pending.event is not None:
            with annotate(RANGE_SYNC):
                pending.event.synchronize()
        yx, score, n = (a.numpy() for a in pending.peaks)
        batch = pending.batch
        b, p, h, _ = batch.frames.shape
        valid = np.asarray(batch.valid)
        # latency: from dispatch to the peaks on the host
        self.metrics.observe_batch(int(valid.sum()), time.monotonic() - pending.t0,
                                   nbytes=pending.nbytes)
        event_idx, shard_rank = np.asarray(batch.event_idx), np.asarray(batch.shard_rank)
        energy = np.asarray(batch.photon_energy)
        sets = []
        for i in range(b):
            if not valid[i]:
                continue
            rows = slice(i * p, (i + 1) * p)
            panels = unpad_peaks(yx[rows], score[rows], n[rows])  # one a panel, in panel order
            ys = np.concatenate([q.y + panel * h for panel, q in enumerate(panels)])
            xs = np.concatenate([q.x for q in panels])
            ss = np.concatenate([q.intensity for q in panels])
            if len(ss) > self.writer.max_peaks:  # keep the brightest
                keep = np.argsort(-ss)[: self.writer.max_peaks]
                ys, xs, ss = ys[keep], xs[keep], ss[keep]
            sets.append(PeakSet(event_idx=int(event_idx[i]), shard_rank=int(shard_rank[i]),
                                y=ys, x=xs, intensity=ss, photon_energy=float(energy[i])))
            self.n_peaks += len(ss)
        self.writer.append(sets)
        if cursor is not None:
            for s in sets:  # after the append: the watermark never runs ahead
                cursor.advance(s.shard_rank, s.event_idx)
        self.n_events += len(sets)
        return len(sets)

    def process_batch(self, batch, cursor=None) -> int:
        """:meth:`dispatch` and :meth:`drain` of one batch, with no overlap."""
        return self.drain(self.dispatch(batch), cursor=cursor)

    def run(
        self,
        queue,
        poll_interval_s: float = 0.01,
        cursor=None,
        cursor_path: Optional[str] = None,
        cursor_save_every: int = 32,
        stop=None,
        max_events: Optional[int] = None,
        drain_control=None,
    ) -> int:
        """Drain ``queue`` to end of stream (or ``stop``/``max_events``);
        returns the events written by this call. ``drain_control`` (a
        :class:`~psana_ray_tpu_torch.infeed.batcher.DrainControl`) makes
        the drain's pop size and poll interval live dials.

        Batches are staged onto the device by an :class:`InfeedPipeline`
        (frames only, two batches ahead, each straight from one of
        ``PREFETCH_DEPTH + 4`` pooled arenas, pinned on the card). One
        batch is in flight: the in-flight batch is always drained before
        returning, so
        ``stop`` and ``max_events`` may overshoot by up to
        ``2 * batch_size - 1`` events, as in the JAX package."""
        start = self.n_events
        prefetcher = InfeedPipeline(queue, self.cfg.batch_size, device=self.device,
                                    prefetch_depth=PREFETCH_DEPTH, poll_interval_s=poll_interval_s,
                                    metrics=self.metrics, batcher_buffers=PREFETCH_DEPTH + 4,
                                    stage_meta=False, stop=stop, drain_control=drain_control)
        self.batcher = prefetcher.batcher

        def drain_one(pending) -> bool:
            """Drain and save the cursor; True once ``max_events`` is reached."""
            wrote = self.drain(pending, cursor=cursor)
            if cursor is not None and cursor_path and cursor_save_every > 0:
                if self.n_events // cursor_save_every != (self.n_events - wrote) // cursor_save_every:
                    cursor.save(cursor_path)
            return max_events is not None and self.n_events - start >= max_events

        pending = None
        try:
            for batch in prefetcher:
                nxt = self.dispatch(batch)
                if batch.hops:  # traced records: their spans end at the dispatch
                    emit_batch_spans(batch, time.monotonic())
                # clear ``pending`` before draining it: a drain that raises
                # after its append must not be drained again below
                prev, pending = pending, None
                if prev is not None and drain_one(prev):
                    pending = nxt
                    break
                pending = nxt
        finally:
            try:
                if pending is not None:
                    prev, pending = pending, None
                    drain_one(prev)
            finally:
                prefetcher.close()
                if cursor is not None and cursor_path:
                    cursor.save(cursor_path)
        return self.n_events - start


def parse_args(argv=None):
    """The CLI's flags, with the JAX package's names and defaults."""
    from psana_ray_tpu_torch.autotune import add_autotune_args

    ap = argparse.ArgumentParser(prog="python -m psana_ray_tpu_torch.sfx",
                                 description="stream -> calibrate -> PeakNet-TPU -> peaks -> CXI")
    ap.add_argument("--ray_address", "--address", dest="address", default="auto",
                    help="auto (in-process), shm://[name], tcp://host:port or "
                         "cluster://host:port,... (or --cluster)")
    ap.add_argument("--ray_namespace", "--namespace", dest="namespace", default="default")
    ap.add_argument("--queue_name", default="shared_queue")
    ap.add_argument("--output", required=True, help="CXI (HDF5) output path")
    ap.add_argument("--serving_params", required=True,
                    help="the port's serving parameter file (export_serving_params output; "
                         "convert a JAX orbax tree with tools/convert_params.py)")
    ap.add_argument("--mode", choices=["auto", "quality", "throughput"], default="auto",
                    help="cross-check the tree's operating point: 'quality' asserts s2d=2, "
                         "'throughput' s2d=4, 'auto' trusts the tree")
    ap.add_argument("--features", default="auto",
                    help="comma-separated encoder widths as a cross-check against the tree "
                         "(default: inferred from it)")
    ap.add_argument("--calib_npz", default=None,
                    help="npz with pedestal/gain/mask [P,H,W] arrays, for streams of RAW ADUs")
    ap.add_argument("--batch", type=int, default=SfxConfig.batch_size,
                    help="frames a device step")
    ap.add_argument("--peak_threshold", type=float, default=None,
                    help="sigmoid probability floor of a peak (default: the mode's entry in "
                         "DEFAULT_THRESHOLDS)")
    ap.add_argument("--max_peaks", type=int, default=128,
                    help="per-event cap: the CXI row width (brightest kept)")
    ap.add_argument("--panel_max_peaks", type=int, default=128,
                    help="per-panel candidate cap of find_peaks")
    ap.add_argument("--min_distance", type=int, default=2)
    ap.add_argument("--max_events", type=int, default=None)
    ap.add_argument("--cursor_path", default=None)
    ap.add_argument("--cursor_stride", type=int, default=1,
                    help="total producer shards (must match the producer topology)")
    ap.add_argument("--cursor_save_every", type=int, default=32)
    ap.add_argument("--overwrite", action="store_true",
                    help="allow truncating an existing --output on a fresh run (a resumed "
                         "run always appends)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; the card by default")
    ap.add_argument("--log_level", default="INFO")
    add_metrics_args(ap)
    add_trace_args(ap)
    add_history_args(ap)
    add_profile_args(ap)
    add_autotune_args(ap)
    add_cluster_args(ap, consumer=True)
    return ap.parse_args(argv)


def run(a, writer=None, metrics: Optional[PipelineMetrics] = None) -> int:
    """Serve the stream that the parsed flags ``a`` name; returns the exit
    code. ``writer`` (anything with ``max_peaks`` and ``append``) takes the
    peak sets in place of a :class:`~psana_ray_tpu_torch.cxi.CxiWriter` on
    ``--output``; ``metrics`` takes the pipeline's per-batch record. Every
    refusal comes before the queue is opened."""
    logging.basicConfig(level=getattr(logging, a.log_level.upper(), logging.INFO),
                        format="%(asctime)s - %(levelname)s - %(message)s")
    log = logging.getLogger("sfx")
    enable_large_alloc_reuse()
    if writer is None:
        try:
            import h5py  # noqa: F401
        except ImportError:
            log.error("writing CXI needs h5py, which is not installed")
            return 1
    try:
        variables = load_params(a.serving_params)
        params = variables.get("params", variables)
        s2d, trained = infer_s2d(params), infer_features(params)
    except (OSError, ValueError) as e:
        log.error("cannot serve %s: %s", a.serving_params, e)
        return 1
    want = {"quality": 2, "throughput": 4}.get(a.mode)
    if want is not None and s2d != want:
        log.error("--mode %s expects s2d=%d but %s was trained with s2d=%d; refusing (the mode "
                  "is a property of the trained tree)", a.mode, want, a.serving_params, s2d)
        return 1
    if a.peak_threshold is None:
        a.peak_threshold = DEFAULT_THRESHOLDS.get(s2d, 0.5)
    if a.features != "auto":
        try:
            features = tuple(int(f) for f in a.features.split(","))
        except ValueError:
            log.error("--features %r is not a comma-separated integer list (or the default "
                      "'auto')", a.features)
            return 1
        if features != trained:
            log.error("--features %s does not match %s (trained with %s); the widths are a "
                      "property of the tree: drop --features", a.features, a.serving_params,
                      ",".join(map(str, trained)))
            return 1
    calib = None
    if a.calib_npz:
        with np.load(a.calib_npz) as z:
            calib = (z["pedestal"], z["gain"], z["mask"])
    cursor = None
    if a.cursor_path:
        cursor = StreamCursor.load(a.cursor_path)
        if not cursor.positions:
            cursor.stride = a.cursor_stride
        elif cursor.stride != a.cursor_stride:
            log.error("cursor %s has stride=%d but --cursor_stride=%d; refusing",
                      a.cursor_path, cursor.stride, a.cursor_stride)
            return 1
    # a resumed run (the cursor has positions) appends: truncating would lose
    # every event the cursor marked done, which the producer will not re-send
    resuming = cursor is not None and bool(cursor.positions)
    if writer is None and not resuming and os.path.exists(a.output) and not a.overwrite:
        log.error("%s exists and this is not a resume (cursor empty or absent); pass "
                  "--overwrite to truncate it or point --output elsewhere", a.output)
        return 1

    try:
        device = resolve_device(a.device)
    except RuntimeError as e:
        log.error("%s", e)
        return 1

    try:
        # --cluster rewrites the address and carries the partitions and group
        config = apply_cluster_args(TransportConfig(address=a.address, namespace=a.namespace,
                                                    queue_name=a.queue_name), a)
        queue = open_queue(config, role="consumer")
    except (TimeoutError, TransportClosed, ValueError) as e:
        log.error("could not open queue %s: %s", a.queue_name, e)
        return 1
    metrics_server = start_metrics_server(a.metrics_port, host=a.metrics_host)
    history = configure_history_from_args(a)
    # the depth for scrapes and the tracer's clock exchanges over a handle of
    # its own: an op on the data connection acks the deliveries it holds
    monitor = None
    if metrics_server is not None or a.trace_dir:
        try:
            monitor = open_queue(config, role="consumer")
        except Exception as e:  # noqa: BLE001 (the depth is optional)
            log.debug("queue monitor unavailable: %s", e)
    configure_from_args(a, "sfx", queue=monitor)
    stop = threading.Event()
    main_thread = threading.current_thread() is threading.main_thread()
    previous = signal.signal(signal.SIGINT, lambda *_: stop.set()) if main_thread else None
    cfg = SfxConfig(batch_size=a.batch, peak_threshold=a.peak_threshold,
                    max_peaks=a.panel_max_peaks, min_distance=a.min_distance)
    profiler = None
    autotune = None
    drain_control = None
    try:
        with contextlib.ExitStack() as stack:
            if writer is None:
                writer = stack.enter_context(
                    CxiWriter(a.output, max_peaks=a.max_peaks, mode="a" if resuming else "w"))
            pipe = SfxPipeline(variables, writer, calib=calib, config=cfg, device=device)
            if metrics is not None:
                pipe.metrics = metrics
            MetricsRegistry.default().register("sfx", pipe.metrics)
            if default_profiler() is None:  # a caller's own sampler stays the caller's
                profiler = configure_profiling_from_args(
                    a, "sfx", frames_fn=lambda: pipe.metrics.frames.count, bytes_fn=wire_bytes)
            if monitor is not None:
                pipe.metrics.attach_queue(monitor)
            if a.autotune != "off":
                # the drain's pop size (group ``serving``: it defers to a
                # bound gateway's policy) and poll interval, and the pool's
                # retention floor, judged by the event rate
                from psana_ray_tpu_torch.autotune import (
                    Objective,
                    configure_autotune_from_args,
                )
                from psana_ray_tpu_torch.autotune.knobs import (
                    bufpool_retention_knob,
                    drain_chunk_knob,
                    drain_poll_knob,
                )
                from psana_ray_tpu_torch.infeed.batcher import DrainControl
                from psana_ray_tpu_torch.utils.bufpool import BufferPool

                drain_control = DrainControl(chunk=a.batch, poll_s=0.01)
                autotune = configure_autotune_from_args(
                    a, [drain_chunk_knob(drain_control), drain_poll_knob(drain_control),
                        bufpool_retention_knob(BufferPool.default())],
                    Objective("sfx.frames_total"))
            log.info("sfx pipeline up on %s: s2d=%d, features %s, threshold %.3f, calib %s",
                     pipe.device, s2d, trained, a.peak_threshold,
                     "on the device" if calib else "upstream")
            t0 = time.monotonic()
            n = pipe.run(queue, cursor=cursor, cursor_path=a.cursor_path,
                         cursor_save_every=a.cursor_save_every, stop=stop,
                         max_events=a.max_events, drain_control=drain_control)
            dt = time.monotonic() - t0
            m = pipe.metrics.summary()
            log.info("end of stream: %d events, %d peaks (%.1f s, %.1f events/s; batch p50 "
                     "%.1f ms, p99 %.1f ms)", n, pipe.n_peaks, dt, n / dt if dt > 0 else 0.0,
                     m["p50_ms"], m["p99_ms"])
    except ValueError as e:
        # a foreign or mismatched output file, a bad tree: explain and exit
        log.error("%s", e)
        return 1
    finally:
        if autotune is not None:
            autotune.stop()
        if main_thread:
            signal.signal(signal.SIGINT, previous)
        if hasattr(queue, "disconnect"):
            queue.disconnect()
        if profiler is not None:
            stop_default_profiler()  # writes the spool
        if history is not None:
            history.stop()
        if metrics_server is not None:
            metrics_server.close()
        if monitor is not None and hasattr(monitor, "disconnect"):
            try:
                monitor.disconnect()
            except Exception:  # noqa: BLE001 (already closing)
                pass
    return 0


def main(argv=None) -> int:
    """``python -m psana_ray_tpu_torch.sfx``: :func:`parse_args` then :func:`run`."""
    return run(parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
