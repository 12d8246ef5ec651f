"""The DataSource protocol, detector geometry, shard assignment and the
backend dispatch.

The port's own copy of ``psana_ray_tpu/sources/base.py``: the same
detector specs, the same strided shard policy (rank r of N gets events
r, r+N, r+2N, ...), and :func:`open_source`, which picks a backend by
experiment name.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Protocol, Tuple, runtime_checkable

import numpy as np

from psana_ray_tpu_torch.config import RetrievalMode


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
    # a tiny geometry for the CPU tests
    "smoke_a": DetectorSpec("smoke_a", panels=2, height=16, width=128),
}


@runtime_checkable
class DataSource(Protocol):
    """What the producer reads: events with or without their global
    index, and the detector's bad-pixel mask."""

    def iter_events(self, mode: str = RetrievalMode.CALIB) -> Iterator[Tuple[np.ndarray, float]]:
        ...

    def iter_indexed_events(
        self, mode: str = RetrievalMode.CALIB
    ) -> Iterator[Tuple[int, np.ndarray, float]]:
        ...

    def create_bad_pixel_mask(self) -> np.ndarray:
        ...


def shard_indices(num_events: int, shard_rank: int, num_shards: int) -> np.ndarray:
    """Strided shard: rank r gets events r, r+N, ... Disjoint + exhaustive."""
    if not (0 <= shard_rank < num_shards):
        raise ValueError(f"shard_rank {shard_rank} not in [0, {num_shards})")
    return np.arange(shard_rank, num_events, num_shards)


def open_source(
    exp: str,
    run: int,
    detector_name: str,
    shard_rank: int = 0,
    num_shards: int = 1,
    **kwargs,
):
    """A backend by experiment name: ``synthetic`` / ``synthetic-*`` ->
    :class:`SyntheticSource`, ``replay:<path>`` -> :class:`ReplaySource`,
    anything else the psana adapter, which exists only where psana is
    installed (LCLS hosts)."""
    from psana_ray_tpu_torch.sources.replay import ReplaySource
    from psana_ray_tpu_torch.sources.synthetic import SyntheticSource

    if exp.startswith("synthetic"):
        return SyntheticSource(
            exp, run, detector_name, shard_rank=shard_rank, num_shards=num_shards, **kwargs
        )
    if exp.startswith("replay:"):
        return ReplaySource(
            exp.split(":", 1)[1],
            detector_name=detector_name,
            shard_rank=shard_rank,
            num_shards=num_shards,
            **kwargs,
        )
    try:
        from psana_ray_tpu_torch.sources.psana_compat import PsanaSource
    except ImportError as e:
        raise RuntimeError(
            f"experiment {exp!r} requires psana (LCLS host). For local runs use "
            f"exp='synthetic' or exp='replay:<path.npz>'."
        ) from e
    return PsanaSource(
        exp, run, detector_name, shard_rank=shard_rank, num_shards=num_shards, **kwargs
    )
