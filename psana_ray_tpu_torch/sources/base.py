"""Detector geometry registry, retrieval modes and shard assignment.

The port's own copy of what it needs from ``psana_ray_tpu/sources/base.py``
and ``psana_ray_tpu/config.py``: the same detector specs and the same
strided shard policy (rank r of N gets events r, r+N, r+2N, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


class RetrievalMode:
    """Event retrieval mode (psana's ImageRetrievalMode): ``calib`` =
    calibrated panel stack, ``raw`` = uncalibrated ADUs. The reference's
    assembled ``image`` mode has no consumer in the port yet."""

    CALIB = "calib"
    RAW = "raw"


@dataclasses.dataclass(frozen=True)
class DetectorSpec:
    """Geometry + signal statistics of a detector family."""

    name: str
    panels: int
    height: int
    width: int
    adu_offset: float = 100.0  # pedestal level in raw ADUs
    adu_gain: float = 35.0  # ADUs per photon
    bad_pixel_fraction: float = 0.003

    @property
    def frame_shape(self) -> Tuple[int, int, int]:
        return (self.panels, self.height, self.width)

    @property
    def pixels(self) -> int:
        return self.panels * self.height * self.width


DETECTORS = {
    "epix10k2M": DetectorSpec("epix10k2M", panels=16, height=352, width=384),
    "jungfrau4M": DetectorSpec("jungfrau4M", panels=8, height=512, width=1024),
    "epix100": DetectorSpec("epix100", panels=1, height=704, width=768),
    # a tiny geometry for the CPU tests of the SFX path
    "smoke_a": DetectorSpec("smoke_a", panels=2, height=16, width=128),
}


def shard_indices(num_events: int, shard_rank: int, num_shards: int) -> np.ndarray:
    """Strided shard: rank r gets events r, r+N, ... Disjoint + exhaustive."""
    if not (0 <= shard_rank < num_shards):
        raise ValueError(f"shard_rank {shard_rank} not in [0, {num_shards})")
    return np.arange(shard_rank, num_events, num_shards)
