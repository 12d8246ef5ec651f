"""Infeed: fixed-shape batching, pinned-memory device prefetch, the
multi-detector fan-in and the multi-host consumers (loaded at first use:
they import ``torch.distributed``). :class:`PipelineMetrics` is
:mod:`psana_ray_tpu_torch.utils.metrics`'s, re-exported."""

import importlib

from psana_ray_tpu_torch.infeed.batcher import Batch, FrameBatcher, StreamStalled, batches_from_queue
from psana_ray_tpu_torch.infeed.fanin import DetectorStream, FanInPipeline
from psana_ray_tpu_torch.infeed.pipeline import DevicePrefetcher, InfeedPipeline, StopStream, drive_step
from psana_ray_tpu_torch.utils.metrics import PipelineMetrics

_MULTIHOST = ("GlobalStreamConsumer", "MultiDetectorGlobalConsumer", "batch_sharding",
              "make_global_Batch", "make_global_batch")

__all__ = sorted([
    "Batch",
    "DetectorStream",
    "DevicePrefetcher",
    "FanInPipeline",
    "FrameBatcher",
    "InfeedPipeline",
    "PipelineMetrics",
    "StopStream",
    "StreamStalled",
    "batches_from_queue",
    "drive_step",
    *_MULTIHOST,
])


def __getattr__(name: str):
    if name not in _MULTIHOST:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module("psana_ray_tpu_torch.infeed.multihost"), name)
    globals()[name] = value
    return value
