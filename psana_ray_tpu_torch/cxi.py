"""CXI (HDF5) peak lists: :class:`PeakSet`, :class:`CxiWriter`, the
readers and the merge tool.

The port's own copy of ``psana_ray_tpu/cxi.py``, with the same HDF5
layout, so that files from either package read back through either
package's readers and merge with either package's :func:`merge_cxi`.
Under ``/entry_1/result_1``: ``nPeaks [N]``, ``peakXPosRaw`` /
``peakYPosRaw`` / ``peakTotalIntensity [N, max_peaks]`` (CrystFEL's CXI
peak-list layout); under ``/LCLS``: ``photon_energy_eV``, ``shard_rank``
and ``event_idx`` per event. ``h5py`` is imported only by the functions
that open a file. The merge tool runs as

    python -m psana_ray_tpu_torch.cxi run1.cxi run2.cxi --output merged.cxi
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from typing import Optional, Sequence

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


def unpad_peaks(yx, score, n, event_idx=None, shard_rank=None, photon_energy=None):
    """``find_peaks``' padded ``(yx [R, K, 2], score [R, K], n [R])`` (numpy,
    on the host) -> one unpadded :class:`PeakSet` a row; ``event_idx``,
    ``shard_rank`` and ``photon_energy`` stamp the rows (default: the row
    index, 0 and 0.0)."""
    yx, score, n = np.asarray(yx), np.asarray(score), np.asarray(n)
    out = []
    for i in range(len(n)):
        k = int(n[i])
        out.append(PeakSet(
            event_idx=int(event_idx[i]) if event_idx is not None else i,
            shard_rank=int(shard_rank[i]) if shard_rank is not None else 0,
            y=yx[i, :k, 0].astype(np.float32),
            x=yx[i, :k, 1].astype(np.float32),
            intensity=score[i, :k].astype(np.float32),
            photon_energy=float(photon_energy[i]) if photon_energy is not None else 0.0,
        ))
    return out


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


def _open_cxi_readonly(path: str):
    """Open a CxiWriter-layout file for reading: ``(file, datasets)``; a
    foreign HDF5 layout raises ``ValueError``."""
    import h5py

    f = h5py.File(path, "r")
    try:
        g = f["entry_1/result_1"]
        refs = {"n": g["nPeaks"], "x": g["peakXPosRaw"], "y": g["peakYPosRaw"],
                "i": g["peakTotalIntensity"], "energy": f["LCLS/photon_energy_eV"],
                "rank": f["LCLS/shard_rank"], "event": f["LCLS/event_idx"]}
    except KeyError as e:
        f.close()
        raise ValueError(f"{path} is not a CxiWriter file (missing {e}); refusing to read a "
                         f"foreign HDF5 layout") from e
    return f, refs


def read_cxi_peaks(path: str):
    """``(nPeaks, x, y, intensity, event_idx)`` arrays of a CXI file."""
    f, refs = _open_cxi_readonly(path)
    with f:
        return refs["n"][:], refs["x"][:], refs["y"][:], refs["i"][:], refs["event"][:]


def read_cxi_peaksets(path: str) -> list:
    """Every event of a CXI file as an unpadded :class:`PeakSet`, with its
    provenance and photon energy (keV)."""
    f, refs = _open_cxi_readonly(path)
    with f:
        n, x, y, inten = refs["n"][:], refs["x"][:], refs["y"][:], refs["i"][:]
        energy, rank, event = refs["energy"][:], refs["rank"][:], refs["event"][:]
    return [PeakSet(event_idx=int(event[i]), shard_rank=int(rank[i]),
                    y=y[i, :n[i]].astype(np.float32), x=x[i, :n[i]].astype(np.float32),
                    intensity=inten[i, :n[i]].astype(np.float32),
                    photon_energy=float(energy[i]) / 1000.0)  # eV -> keV
            for i in range(len(n))]


def merge_cxi(inputs: Sequence[str], output: str, max_peaks: Optional[int] = None,
              keep: str = "last", chunk_events: int = 1024) -> int:
    """Merge per-run CXI files into one, dropping at-least-once replays on
    the ``(shard_rank, event_idx)`` stamp; returns the events written.

    ``keep="last"`` keeps the latest occurrence in input-then-row order (a
    resumed run's event supersedes the crashed run's), ``"first"`` the
    earliest. The output is sorted by ``(shard_rank, event_idx)``. Two
    passes: the first reads only the stamps to choose the winners, the
    second copies them ``chunk_events`` at a time, each slab read with one
    sorted selection a dataset and input file. ``max_peaks`` defaults to
    the widest input's row; a narrower one is refused (a merge is
    lossless), and so is an ``output`` that exists."""
    if keep not in ("last", "first"):
        raise ValueError(f"keep must be 'last' or 'first', got {keep!r}")
    if chunk_events < 1:
        raise ValueError(f"chunk_events must be >= 1, got {chunk_events}")
    if os.path.exists(output):
        raise ValueError(f"refusing to overwrite existing {output}; point --output at a new file")

    with contextlib.ExitStack() as stack:
        handles = []
        for path in inputs:
            f, refs = _open_cxi_readonly(path)
            stack.callback(f.close)
            handles.append(refs)
        widths = {p: int(h["x"].shape[1]) for p, h in zip(inputs, handles)}
        if max_peaks is None:
            max_peaks = max(widths.values())
        else:
            too_wide = {p: w for p, w in widths.items() if w > max_peaks}
            if too_wide:
                raise ValueError(
                    f"max_peaks={max_peaks} would truncate peak lists from {sorted(too_wide)} "
                    f"(row width {max(too_wide.values())}); a merge must be lossless: raise "
                    f"max_peaks or omit it")

        # pass 1: the stamps only -> the winning (input, row) of each key
        winners: dict = {}
        for fi, refs in enumerate(handles):
            rank, event = refs["rank"][:], refs["event"][:]
            for ri in range(len(rank)):
                key = (int(rank[ri]), int(event[ri]))
                if keep == "last" or key not in winners:
                    winners[key] = (fi, ri)
        ordered = sorted(winners)

        # pass 2: slab by slab in key order, one read a dataset and input
        with CxiWriter(output, max_peaks=max_peaks) as w:
            for c0 in range(0, len(ordered), chunk_events):
                slab = ordered[c0:c0 + chunk_events]
                by_file: dict = {}
                for pos, key in enumerate(slab):
                    fi, ri = winners[key]
                    by_file.setdefault(fi, []).append((ri, pos))
                rows: list = [None] * len(slab)
                for fi, pairs in by_file.items():
                    refs = handles[fi]
                    pairs.sort()  # h5py selections take increasing indices
                    ris = [ri for ri, _ in pairs]
                    n_a, y_a, x_a = refs["n"][ris], refs["y"][ris], refs["x"][ris]
                    i_a, e_a = refs["i"][ris], refs["energy"][ris]
                    for j, (_, pos) in enumerate(pairs):
                        k = int(n_a[j])
                        rank, event = slab[pos]
                        rows[pos] = PeakSet(
                            event_idx=event, shard_rank=rank,
                            y=y_a[j, :k].astype(np.float32), x=x_a[j, :k].astype(np.float32),
                            intensity=i_a[j, :k].astype(np.float32),
                            photon_energy=float(e_a[j]) / 1000.0)
                w.append(rows)
    return len(ordered)


def merge_cxi_main(argv=None) -> int:
    """The merge command: merge and dedupe per-run CXI files."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m psana_ray_tpu_torch.cxi",
                                 description="merge and dedupe per-run CXI files")
    ap.add_argument("inputs", nargs="+", help="CXI files, oldest run first")
    ap.add_argument("--output", required=True, help="must not already exist")
    ap.add_argument("--max_peaks", type=int, default=None,
                    help="output row width (default: the widest input's; a narrower value "
                         "is refused rather than truncating)")
    ap.add_argument("--keep", choices=["last", "first"], default="last",
                    help="which duplicate of a (shard_rank, event_idx) to keep (default: "
                         "last, a resumed run supersedes the crashed one)")
    ap.add_argument("--chunk_events", type=int, default=1024,
                    help="events copied a slab in the second pass")
    a = ap.parse_args(argv)
    try:
        n = merge_cxi(a.inputs, a.output, max_peaks=a.max_peaks, keep=a.keep,
                      chunk_events=a.chunk_events)
    except (ValueError, OSError) as e:
        # refusals and a missing or unreadable input: operator errors
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"merged {len(a.inputs)} file(s) -> {a.output}: {n} unique events")
    return 0


if __name__ == "__main__":
    raise SystemExit(merge_cxi_main())
