"""Frame records and the typed end-of-stream marker.

A reduced copy of ``psana_ray_tpu/records.py``: the in-process record, the
EOS marker with shard coverage, and the consumer-side tally. The wire
format, buffer leases, hop stamps and trace context are left out: they
arrive with the transport slices.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from psana_ray_tpu_torch.transport.ring import TransportClosed


@dataclasses.dataclass(frozen=True, eq=False)
class FrameRecord:
    """One detector event: ``panels`` is always 3-D ``[P, H, W]`` (a 2-D
    frame gets a leading panel axis)."""

    shard_rank: int
    event_idx: int
    panels: np.ndarray
    photon_energy: float
    timestamp: float = 0.0

    def __post_init__(self):
        panels = np.asarray(self.panels)
        if panels.ndim == 2:
            panels = panels[None]
        if panels.ndim != 3:
            raise ValueError(f"panels must be 2-D or 3-D, got ndim={panels.ndim}")
        object.__setattr__(self, "panels", panels)

    @property
    def nbytes(self) -> int:
        return int(self.panels.nbytes)


@dataclasses.dataclass(frozen=True)
class EndOfStream:
    """Typed end-of-stream marker. Each producer runtime emits one, carrying
    how many shards it covered (``shards_done``) of how many exist
    (``total_shards``); consumers stop once every shard is covered."""

    producer_rank: int = 0
    total_events: int = -1  # -1 = unknown
    shards_done: int = 1
    total_shards: int = 1


class EosTally:
    """Tallies EOS markers from several producer runtimes.

    :meth:`process` returns True once the ``shards_done`` of distinct
    producer ranks sum to ``total_shards``. Coverage is idempotent per
    rank. A second marker from a rank already seen belongs to a sibling
    consumer: it is held and handed back by :meth:`flush_duplicates`.
    """

    def __init__(self):
        self._shards_by_rank = {}
        self._total = 1
        self._pending_dups: List[EndOfStream] = []

    @property
    def complete(self) -> bool:
        return sum(self._shards_by_rank.values()) >= self._total

    def is_duplicate(self, eos: EndOfStream) -> bool:
        return eos.producer_rank in self._shards_by_rank

    def observe(self, eos: EndOfStream) -> bool:
        self._shards_by_rank[eos.producer_rank] = eos.shards_done
        self._total = max(self._total, eos.total_shards)
        return self.complete

    def process(self, eos: EndOfStream) -> bool:
        if self.is_duplicate(eos):
            self._pending_dups.append(eos)
            return self.complete
        return self.observe(eos)

    def flush_duplicates(self, queue, final: bool = False) -> int:
        """Return held sibling markers to ``queue`` (non-blocking; with
        ``final`` a short blocking put each). Returns how many went back."""
        placed = 0
        while self._pending_dups:
            eos = self._pending_dups[0]
            try:
                ok = queue.put_wait(eos, timeout=1.0) if final else queue.put(eos)
            except TransportClosed:  # the sibling sees the dead queue itself
                self._pending_dups.clear()
                break
            if not ok:
                break
            self._pending_dups.pop(0)
            placed += 1
        return placed
