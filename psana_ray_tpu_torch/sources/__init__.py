"""Detector sources: the port's own copies of the specs and the synthetic source."""

from psana_ray_tpu_torch.sources.base import DETECTORS, DetectorSpec, RetrievalMode, shard_indices
from psana_ray_tpu_torch.sources.synthetic import SyntheticSource

__all__ = ["DETECTORS", "DetectorSpec", "RetrievalMode", "SyntheticSource", "shard_indices"]
