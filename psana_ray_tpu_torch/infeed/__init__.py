"""Infeed: fixed-shape batching and pinned-memory device prefetch."""

from psana_ray_tpu_torch.infeed.batcher import Batch, FrameBatcher, batches_from_queue
from psana_ray_tpu_torch.infeed.pipeline import (
    DevicePrefetcher,
    InfeedPipeline,
    PipelineMetrics,
    StopStream,
    drive_step,
)

__all__ = [
    "Batch",
    "DevicePrefetcher",
    "FrameBatcher",
    "InfeedPipeline",
    "PipelineMetrics",
    "StopStream",
    "batches_from_queue",
    "drive_step",
]
