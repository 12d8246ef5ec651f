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

The operator CLI of the JAX package (orbax checkpoints, shm/TCP
transports, autotune) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from psana_ray_tpu_torch.convert import infer_features, infer_s2d, unet_from_flax
from psana_ray_tpu_torch.cxi import PeakSet
from psana_ray_tpu_torch.device import resolve_device
from psana_ray_tpu_torch.infeed import InfeedPipeline, PipelineMetrics
from psana_ray_tpu_torch.models.fused_unet import pack_unet, peaknet_tpu_fused_infer
from psana_ray_tpu_torch.models.heads import panels_to_nhwc
from psana_ray_tpu_torch.models.peaks import find_peaks
from psana_ray_tpu_torch.ops.fused_calib import fused_calibrate

__all__ = ["DEFAULT_THRESHOLDS", "SfxConfig", "SfxPipeline", "infer_features", "infer_s2d"]


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
        metadata stays on the host."""
        t0 = time.monotonic()
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

    def drain(self, pending: Pending, cursor=None) -> int:
        """Wait for a :meth:`dispatch` handle and append its real events to
        the writer; returns the events appended. Padding rows never reach
        the writer; the cursor advances only after the append."""
        if pending.event is not None:
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
            rows = range(i * p, (i + 1) * p)
            ys = np.concatenate([yx[r, :n[r], 0].astype(np.float32) + (r - i * p) * h for r in rows])
            xs = np.concatenate([yx[r, :n[r], 1].astype(np.float32) for r in rows])
            ss = np.concatenate([score[r, :n[r]].astype(np.float32) for r in rows])
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
    ) -> int:
        """Drain ``queue`` to end of stream (or ``stop``/``max_events``);
        returns the events written by this call.

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
                                    stage_meta=False, stop=stop)
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
