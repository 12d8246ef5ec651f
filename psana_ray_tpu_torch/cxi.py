"""CXI (HDF5) peak-list output: :class:`PeakSet` and :class:`CxiWriter`.

The port's own copy of the writer of ``psana_ray_tpu/cxi.py``, with the
same HDF5 layout, so that files from either package read back through
either package's readers. Under ``/entry_1/result_1``: ``nPeaks [N]``,
``peakXPosRaw`` / ``peakYPosRaw`` / ``peakTotalIntensity [N, max_peaks]``
(CrystFEL's CXI peak-list layout); under ``/LCLS``: ``photon_energy_eV``,
``shard_rank`` and ``event_idx`` per event. ``h5py`` is imported by the
writer only, when a file is opened.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class PeakSet:
    """The peak list of one event (unpadded)."""

    event_idx: int
    shard_rank: int
    y: np.ndarray  # [n] float32 row position
    x: np.ndarray  # [n] float32 column position
    intensity: np.ndarray  # [n] float32
    photon_energy: float = 0.0  # keV

    @property
    def n(self) -> int:
        return len(self.y)


class CxiWriter:
    """Append peak lists to a CXI file, one resizable chunked dataset per
    column, flushed after every batch.

    ``mode="w"`` creates or truncates; ``mode="a"`` reopens an existing
    file and appends after its last event (the resume path), and needs
    the ``max_peaks`` the file was created with.
    """

    def __init__(self, path: str, max_peaks: int = 128, mode: str = "w"):
        import h5py

        if mode not in ("w", "a"):
            raise ValueError(f"mode must be 'w' or 'a', got {mode!r}")
        self.path = path
        self.max_peaks = max_peaks
        if mode == "a" and os.path.exists(path):
            self._f = h5py.File(path, "r+")
            try:
                g, lcls = self._f["entry_1/result_1"], self._f["LCLS"]
                self._cols = [g["nPeaks"], g["peakXPosRaw"], g["peakYPosRaw"],
                              g["peakTotalIntensity"], lcls["photon_energy_eV"],
                              lcls["shard_rank"], lcls["event_idx"]]
                existing = int(self._cols[1].shape[1])
                if existing != max_peaks:
                    raise ValueError(f"cannot append with max_peaks={max_peaks}: {path} was "
                                     f"created with max_peaks={existing}")
            except BaseException as e:
                self._f.close()  # it holds the HDF5 lock
                if isinstance(e, KeyError):
                    raise ValueError(f"{path} exists but is not a CxiWriter file (missing {e}); "
                                     f"refusing to append to a foreign HDF5 layout") from e
                raise
            self._count = int(self._cols[0].shape[0])
            return
        self._f = h5py.File(path, "w")
        g = self._f.create_group("entry_1").create_group("result_1")
        lcls = self._f.create_group("LCLS")

        def column(group, name, shape, dtype):
            return group.create_dataset(name, shape=(0, *shape), maxshape=(None, *shape),
                                        dtype=dtype, chunks=(256, *shape))

        row = (max_peaks,)
        self._cols = [
            column(g, "nPeaks", (), np.int32),
            column(g, "peakXPosRaw", row, np.float32),
            column(g, "peakYPosRaw", row, np.float32),
            column(g, "peakTotalIntensity", row, np.float32),
            column(lcls, "photon_energy_eV", (), np.float64),
            column(lcls, "shard_rank", (), np.int32),
            column(lcls, "event_idx", (), np.int64),
        ]
        self._count = 0

    def append(self, peaks: Sequence[PeakSet]) -> None:
        """Append a batch of events: rows assembled in numpy, one slice
        written per dataset. Lists longer than ``max_peaks`` are cut."""
        if not peaks:
            return
        m, b = self.max_peaks, len(peaks)
        n_a = np.zeros(b, np.int32)
        x_a = np.zeros((b, m), np.float32)
        y_a = np.zeros((b, m), np.float32)
        i_a = np.zeros((b, m), np.float32)
        e_a = np.zeros(b, np.float64)
        r_a = np.zeros(b, np.int32)
        ev_a = np.zeros(b, np.int64)
        for j, p in enumerate(peaks):
            k = min(p.n, m)
            n_a[j] = k
            x_a[j, :k] = p.x[:k]
            y_a[j, :k] = p.y[:k]
            i_a[j, :k] = p.intensity[:k]
            e_a[j] = p.photon_energy * 1000.0  # keV -> eV
            r_a[j] = p.shard_rank
            ev_a[j] = p.event_idx
        start, end = self._count, self._count + b
        for col, rows in zip(self._cols, (n_a, x_a, y_a, i_a, e_a, r_a, ev_a)):
            col.resize(end, axis=0)
            col[start:end] = rows
        self._count = end
        self._f.flush()

    @property
    def n_events(self) -> int:
        return self._count

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
