"""Adapter for a real psana installation on LCLS hosts.

The port's own copy of ``psana_ray_tpu/sources/psana_compat.py``: the
surface the reference reads from its psana wrapper (construct with exp,
run and detector name; ``iter_events(mode)``; ``create_bad_pixel_mask``).
Importing it fails where psana is not installed, and
:func:`~psana_ray_tpu_torch.sources.open_source` imports it only for an
experiment that is neither synthetic nor a replay.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

try:
    import psana  # type: ignore  # exists on LCLS hosts only
except ImportError as _e:
    raise ImportError("psana is not installed (expected off LCLS hosts)") from _e

from psana_ray_tpu_torch.config import RetrievalMode


class PsanaSource:
    """Shard-aware psana reader (smalldata parallel mode)."""

    def __init__(self, exp, run, detector_name, shard_rank=0, num_shards=1, start_event=0, **_):
        self.exp, self.run, self.detector_name = exp, run, detector_name
        self.shard_rank, self.num_shards = shard_rank, num_shards
        self.start_event = start_event
        self._ds = psana.DataSource(exp=exp, run=run)
        self._run = next(self._ds.runs())
        self._det = self._run.Detector(detector_name)
        self._ebeam = self._run.Detector("ebeam")

    def create_bad_pixel_mask(self) -> np.ndarray:
        mask = self._det.raw.mask(calib_const=True, status=True)
        return np.asarray(mask, dtype=np.uint8)

    def iter_events(self, mode: str = RetrievalMode.CALIB) -> Iterator[Tuple[np.ndarray, float]]:
        for _, data, energy in self.iter_indexed_events(mode):
            yield data, energy

    def iter_indexed_events(
        self, mode: str = RetrievalMode.CALIB
    ) -> Iterator[Tuple[int, np.ndarray, float]]:
        """Yield ``(global_event_idx, data, photon_energy in keV)`` for this
        shard. A damaged event (psana gives None) uses up its index and is
        skipped, so indices stay aligned across shards."""
        for i, evt in enumerate(self._run.events()):
            if i % self.num_shards != self.shard_rank or i < self.start_event:
                continue
            if mode == RetrievalMode.CALIB:
                data = self._det.raw.calib(evt)
            elif mode == RetrievalMode.IMAGE:
                data = self._det.raw.image(evt)
            else:
                data = self._det.raw.raw(evt)
            if data is None:
                continue
            energy = float(self._ebeam.raw.ebeamPhotonEnergy(evt) or 0.0) / 1000.0
            yield i, np.asarray(data, dtype=np.float32), energy
