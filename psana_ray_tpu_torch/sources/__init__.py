"""Detector sources: the port's own copies of the detector specs, the
synthetic and replay sources, the psana adapter (LCLS hosts only) and
:func:`open_source`, which picks one by experiment name."""

from psana_ray_tpu_torch.config import RetrievalMode
from psana_ray_tpu_torch.sources.base import (
    DETECTORS,
    DataSource,
    DetectorSpec,
    open_source,
    shard_indices,
)
from psana_ray_tpu_torch.sources.replay import ReplaySource
from psana_ray_tpu_torch.sources.synthetic import SyntheticSource

__all__ = ["DETECTORS", "DataSource", "DetectorSpec", "ReplaySource", "RetrievalMode",
           "SyntheticSource", "open_source", "shard_indices"]
