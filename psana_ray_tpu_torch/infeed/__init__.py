"""Infeed: fixed-shape batching, pinned-memory device prefetch and the
multi-detector fan-in. :class:`PipelineMetrics` is
:mod:`psana_ray_tpu_torch.utils.metrics`'s, re-exported."""

from psana_ray_tpu_torch.infeed.batcher import Batch, FrameBatcher, batches_from_queue
from psana_ray_tpu_torch.infeed.fanin import DetectorStream, FanInPipeline
from psana_ray_tpu_torch.infeed.pipeline import DevicePrefetcher, InfeedPipeline, StopStream, drive_step
from psana_ray_tpu_torch.utils.metrics import PipelineMetrics

__all__ = [
    "Batch",
    "DetectorStream",
    "DevicePrefetcher",
    "FanInPipeline",
    "FrameBatcher",
    "InfeedPipeline",
    "PipelineMetrics",
    "StopStream",
    "batches_from_queue",
    "drive_step",
]
