"""The producer's inner loop: events into a queue, then one EOS.

The port's reduced counterpart of ``psana_ray_tpu/producer.py``: what a
producer runtime does per event (stamp rank and index, put with
backpressure) and at the end of its shard (one :class:`EndOfStream`).
The full runtime, its CLI and the shm/TCP transports are a later slice.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional, Tuple

import numpy as np

from psana_ray_tpu_torch.records import EndOfStream, FrameRecord


def produce(
    events: Iterable[Tuple[int, np.ndarray, float]],
    queue,
    shard_rank: int = 0,
    total_shards: int = 1,
    timeout: Optional[float] = None,
) -> int:
    """Put every ``(event_idx, panels, photon_energy)`` as a
    :class:`FrameRecord` with ``put_wait`` (blocking while the queue is
    full), then one EOS covering this shard. Returns the events put.
    ``events`` is e.g. ``SyntheticSource.iter_indexed_events("raw")``.
    Raises ``TimeoutError`` if a put waits longer than ``timeout``."""
    n = 0
    for idx, panels, energy in events:
        rec = FrameRecord(shard_rank, int(idx), panels, float(energy), time.time())
        if not queue.put_wait(rec, timeout=timeout):
            raise TimeoutError(f"queue full for {timeout} s at event {idx}")
        n += 1
    eos = EndOfStream(producer_rank=shard_rank, total_events=n, total_shards=total_shards)
    if not queue.put_wait(eos, timeout=timeout):
        raise TimeoutError(f"queue full for {timeout} s at end of stream")
    return n
