"""Replay source: stream frames recorded in ``.npz`` / ``.npy`` files.

The port's own copy of ``psana_ray_tpu/sources/replay.py``. File format:
``.npz`` with ``frames [N, P, H, W]`` (or ``[N, H, W]``, promoted to
``[N, 1, H, W]``), optional ``photon_energy [N]`` and optional
``bad_pixel_mask [P, H, W]``; or a bare ``.npy`` of frames. Frames are
memory-mapped, never loaded whole: a ``.npy`` by ``np.load(mmap_mode)``,
an uncompressed ``.npz`` member (``np.savez``) by mapping its bytes in
place, so a shard touches only its own strided events. A compressed
member (``np.savez_compressed``) decompresses whole on first access.
"""

from __future__ import annotations

import logging
import os
import zipfile
from typing import Iterator, Optional, Tuple

import numpy as np

from psana_ray_tpu_torch.config import RetrievalMode
from psana_ray_tpu_torch.sources.base import shard_indices

logger = logging.getLogger(__name__)


def _mmap_npz_member(path: str, name: str) -> Optional[np.ndarray]:
    """A true mmap of an uncompressed ``.npz`` member: its ``.npy`` bytes
    sit contiguously in the file, after the zip local header and the npy
    header. None when the member is compressed or the layout is not the
    expected one (the caller then lets numpy decompress it)."""
    try:
        with zipfile.ZipFile(path) as zf:
            info = zf.getinfo(name)
            if info.compress_type != zipfile.ZIP_STORED:
                return None
            with zf.open(info) as member:
                version = np.lib.format.read_magic(member)
                if version == (1, 0):
                    shape, fortran, dtype = np.lib.format.read_array_header_1_0(member)
                else:
                    shape, fortran, dtype = np.lib.format.read_array_header_2_0(member)
                npy_header = member.tell()
            if fortran or dtype.hasobject:
                return None
        # the local header's extra field may differ from the central
        # directory's: read its length from the file
        with open(path, "rb") as f:
            f.seek(info.header_offset + 26)
            name_len = int.from_bytes(f.read(2), "little")
            extra_len = int.from_bytes(f.read(2), "little")
        offset = info.header_offset + 30 + name_len + extra_len + npy_header
        return np.memmap(path, dtype=dtype, mode="r", shape=shape, offset=offset)
    except Exception as e:  # an exotic archive: numpy reads it instead
        logger.debug("npz mmap of %s[%s] unavailable: %r", path, name, e)
        return None


def _warn_if_exceeds_ram(path: str, name: str) -> None:
    """Warn when a compressed member would decompress past the free RAM."""
    try:
        with zipfile.ZipFile(path) as zf:
            nbytes = zf.getinfo(name).file_size
        avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, KeyError):
        return
    if nbytes > 0.8 * avail:
        logger.warning(
            "replay member %s[%s] is %.1f GB but only %.1f GB RAM is free; "
            "it will decompress fully on first access. Record with np.savez "
            "(uncompressed, mmap-able) or a bare .npy for >RAM runs.",
            path, name, nbytes / 1e9, avail / 1e9,
        )


class ReplaySource:
    """One strided shard of a recorded run. The retrieval mode is the
    recording's: ``mode`` is accepted and ignored."""

    def __init__(
        self,
        path: str,
        detector_name: str = "epix10k2M",
        shard_rank: int = 0,
        num_shards: int = 1,
        start_event: int = 0,
        **_,
    ):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self.detector_name = detector_name
        self.shard_rank = shard_rank
        self.num_shards = num_shards
        self.start_event = start_event
        if path.endswith(".npz"):
            z = np.load(path)
            frames = _mmap_npz_member(path, "frames.npy")
            if frames is None:
                _warn_if_exceeds_ram(path, "frames.npy")
                frames = z["frames"]
            self._frames = frames
            self._energy = z["photon_energy"] if "photon_energy" in z else None
            self._mask = z["bad_pixel_mask"] if "bad_pixel_mask" in z else None
        else:
            self._frames = np.load(path, mmap_mode="r")
            self._energy = None
            self._mask = None
        if self._frames.ndim == 3:  # [N, H, W] -> [N, 1, H, W]
            self._frames = self._frames[:, None]

    @property
    def num_events(self) -> int:
        return len(self._frames)

    def create_bad_pixel_mask(self) -> np.ndarray:
        if self._mask is not None:
            return self._mask.astype(np.uint8)
        return np.ones(self._frames.shape[1:], dtype=np.uint8)

    def shard_event_indices(self) -> np.ndarray:
        idxs = shard_indices(self.num_events, self.shard_rank, self.num_shards)
        return idxs[idxs >= self.start_event]

    def iter_events(self, mode: str = RetrievalMode.CALIB) -> Iterator[Tuple[np.ndarray, float]]:
        for _, data, energy in self.iter_indexed_events(mode):
            yield data, energy

    def iter_indexed_events(
        self, mode: str = RetrievalMode.CALIB
    ) -> Iterator[Tuple[int, np.ndarray, float]]:
        """Yield ``(global_event_idx, data, photon_energy)`` for this shard
        (9.5 keV where the file records no energy)."""
        for idx in self.shard_event_indices():
            e = float(self._energy[idx]) if self._energy is not None else 9.5
            yield int(idx), np.asarray(self._frames[int(idx)]), e

    def __len__(self) -> int:
        return len(self.shard_event_indices())
