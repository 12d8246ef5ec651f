"""Synthetic detector source: deterministic, shardable, physically plausible.

The port's own copy of ``psana_ray_tpu/sources/synthetic.py``: for the
same (exp, run, detector, seed) it gives bit-identical frames, pedestal,
gain map and bad-pixel mask. Frames model an area detector in ADUs:
pedestal + Gaussian noise + Poisson photon background with bright
Bragg-like peaks, and a per-panel common-mode offset in raw mode; the
``image`` mode tiles the panels into one 2-D mosaic. Every event is
generated from ``seed ^ hash(exp, run, event_idx)``, so any rank can
regenerate any event, and a shard resumes at ``start_event`` with the
same frames. With ``hit_fraction`` set, each event is a hit (peaks
planted) with that probability and otherwise a miss (background only): the
labelled hit-finding corpus the classifiers train on.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from psana_ray_tpu_torch.config import RetrievalMode
from psana_ray_tpu_torch.sources.base import DETECTORS, DetectorSpec, shard_indices


def _stable_seed(exp: str, run: int, base_seed: int) -> int:
    h = 2166136261
    for b in f"{exp}/{run}/{base_seed}".encode():
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


class SyntheticSource:
    """Deterministic synthetic frames for one (exp, run, detector) shard."""

    def __init__(
        self,
        exp: str = "synthetic",
        run: int = 1,
        detector_name: str = "epix10k2M",
        num_events: int = 1024,
        seed: int = 0,
        shard_rank: int = 0,
        num_shards: int = 1,
        dtype: str = "float32",
        peak_count: int = 24,
        start_event: int = 0,
        hit_fraction: Optional[float] = None,
    ):
        if detector_name not in DETECTORS:
            raise ValueError(f"unknown detector {detector_name!r}; have {sorted(DETECTORS)}")
        self.exp = exp
        self.run = run
        self.spec: DetectorSpec = DETECTORS[detector_name]
        self.num_events = num_events
        self.shard_rank = shard_rank
        self.num_shards = num_shards
        self.dtype = np.dtype(dtype)
        self.peak_count = peak_count
        self.start_event = start_event  # resume floor: events below it are skipped
        # None keeps every event a hit and the frames bit-identical to a
        # source without the knob (no extra random draw)
        if hit_fraction is not None and not 0.0 <= hit_fraction <= 1.0:
            raise ValueError(f"hit_fraction must be in [0, 1], got {hit_fraction}")
        self.hit_fraction = hit_fraction
        self._seed = _stable_seed(exp, run, seed)
        self._pedestal: Optional[np.ndarray] = None
        self._gain_map: Optional[np.ndarray] = None

    def create_bad_pixel_mask(self) -> np.ndarray:
        """1 = good pixel, 0 = bad. Deterministic per (exp, run, detector)."""
        rng = np.random.default_rng(self._seed ^ 0xBAD)
        mask = rng.random(self.spec.frame_shape) >= self.spec.bad_pixel_fraction
        return mask.astype(np.uint8)

    def pedestal(self) -> np.ndarray:
        """Per-pixel pedestal (dark level); computed once, cached."""
        if self._pedestal is None:
            rng = np.random.default_rng(self._seed ^ 0x9ED)
            self._pedestal = (
                self.spec.adu_offset + 3.0 * rng.standard_normal(self.spec.frame_shape)
            ).astype(np.float32)
        return self._pedestal

    def gain_map(self) -> np.ndarray:
        """Per-pixel RELATIVE gain (mean 1.0). Raw ADUs carry
        ``spec.adu_gain`` ADUs per photon on top of it, so calibrating with
        this map alone gives ADU-scaled output."""
        if self._gain_map is None:
            rng = np.random.default_rng(self._seed ^ 0x6A1)
            self._gain_map = (
                1.0 + 0.02 * rng.standard_normal(self.spec.frame_shape)
            ).astype(np.float32)
        return self._gain_map

    def event(self, idx: int, mode: str = RetrievalMode.CALIB) -> Tuple[np.ndarray, float]:
        """Generate event ``idx`` (globally indexed): ``(panels, photon
        energy in keV)``. Deterministic; every random draw is the JAX
        package's, in its order."""
        data, energy, _ = self.event_with_truth(idx, mode)
        return data, energy

    def event_with_truth(
        self, idx: int, mode: str = RetrievalMode.CALIB
    ) -> Tuple[np.ndarray, float, np.ndarray]:
        """Like :meth:`event`, also returning the planted peaks as
        ``[n_peaks, 4]`` float32 rows ``(panel, cy, cx, amplitude)``, the
        truth :func:`~psana_ray_tpu_torch.models.peaks.peak_metrics` scores
        against. The same random draws as :meth:`event`."""
        rng = np.random.default_rng((self._seed << 20) ^ idx)
        spec = self.spec
        p, h, w = spec.frame_shape
        photons = rng.poisson(0.08, size=(p, h, w)).astype(np.float32)
        is_hit = self.hit_fraction is None or bool(rng.random() < self.hit_fraction)
        n_peaks = int(rng.integers(self.peak_count // 2, self.peak_count + 1)) if is_hit else 0
        yy = np.arange(h, dtype=np.float32)[:, None]
        xx = np.arange(w, dtype=np.float32)[None, :]
        truth = np.zeros((n_peaks, 4), dtype=np.float32)
        for j in range(n_peaks):
            pi = int(rng.integers(0, p))
            cy, cx = rng.uniform(4, h - 4), rng.uniform(4, w - 4)
            amp = rng.uniform(50, 800)
            sig = rng.uniform(0.8, 2.2)
            photons[pi] += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig**2))
            truth[j] = (pi, cy, cx, amp)
        photon_energy = float(rng.uniform(8.0, 12.0))  # keV

        if mode == RetrievalMode.CALIB:
            data = photons
        elif mode == RetrievalMode.RAW:
            # pedestal + gain*photons + per-panel common-mode offset + noise
            cm = rng.uniform(-8.0, 8.0, size=(p, 1, 1)).astype(np.float32)
            noise = 2.5 * rng.standard_normal((p, h, w)).astype(np.float32)
            data = self.pedestal() + spec.adu_gain * photons * self.gain_map() + cm + noise
        elif mode == RetrievalMode.IMAGE:
            # assembled mosaic: the panels tiled row-major into one 2-D image
            cols = max(1, int(np.floor(np.sqrt(p))))
            rows = (p + cols - 1) // cols
            img = np.zeros((rows * h, cols * w), dtype=np.float32)
            for pi in range(p):
                r, c = divmod(pi, cols)
                img[r * h: (r + 1) * h, c * w: (c + 1) * w] = photons[pi]
            data = img
        else:
            raise ValueError(f"unknown mode {mode!r}")
        if np.issubdtype(self.dtype, np.integer):
            # clip before the cast: a float ADU slightly below 0 would wrap
            info = np.iinfo(self.dtype)
            data = np.clip(data, info.min, info.max)
        return data.astype(self.dtype, copy=False), photon_energy, truth

    def iter_events(self, mode: str = RetrievalMode.CALIB) -> Iterator[Tuple[np.ndarray, float]]:
        """Yield ``(data, photon_energy)`` for this shard."""
        for idx in self.shard_event_indices():
            yield self.event(int(idx), mode)

    def iter_indexed_events(
        self, mode: str = RetrievalMode.CALIB
    ) -> Iterator[Tuple[int, np.ndarray, float]]:
        """Yield ``(global_event_idx, data, photon_energy)`` for this shard."""
        for idx in self.shard_event_indices():
            data, energy = self.event(int(idx), mode)
            yield int(idx), data, energy

    def shard_event_indices(self) -> np.ndarray:
        idxs = shard_indices(self.num_events, self.shard_rank, self.num_shards)
        return idxs[idxs >= self.start_event]

    def __len__(self) -> int:
        return len(self.shard_event_indices())
