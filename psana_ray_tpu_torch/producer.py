"""The producer's inner loop: events into a queue, then one EOS.

The port's reduced counterpart of ``psana_ray_tpu/producer.py``: what a
producer runtime does per event (stamp rank and index, put with
backpressure) and at the end of its shard (one :class:`EndOfStream`), and
:func:`produce_synthetic`, a producer process that feeds a named shm ring
from a seeded :class:`SyntheticSource`. The full runtime, its CLI and the
TCP transport are a later slice (Queue 1 Item 8).
"""

from __future__ import annotations

import time
from typing import Iterable, Optional, Tuple

import numpy as np

from psana_ray_tpu_torch.records import EndOfStream, FrameRecord
from psana_ray_tpu_torch.sources import SyntheticSource
from psana_ray_tpu_torch.transport.shm_ring import ShmRingBuffer


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


def produce_synthetic(
    ring_name: str,
    detector_name: str,
    n_events: int,
    pool_events: int,
    seed: int = 0,
    dtype: str = "float32",
    produced=None,
    run: int = 1,
) -> int:
    """A producer process's body, for ``multiprocessing``'s ``spawn``
    start method: attach to the shm ring ``ring_name``, draw the RAW
    events ``0 .. pool_events - 1`` of ``SyntheticSource(detector_name,
    seed, dtype, run)``, put ``n_events`` of them (the pool cycled, event
    index ``i`` carrying pool event ``i % pool_events``) and one EOS, then
    detach. ``produced`` (a ``multiprocessing.Value``) receives the count.
    Imports no torch, so the process never touches the card."""
    src = SyntheticSource(run=run, num_events=pool_events, detector_name=detector_name,
                          seed=seed, dtype=dtype)
    pool = [src.event(i, "raw") for i in range(pool_events)]
    ring = ShmRingBuffer.attach(ring_name, retries=100, interval_s=0.1)
    try:
        events = ((i, *pool[i % pool_events]) for i in range(n_events))
        n = produce(events, ring, timeout=120.0)
    finally:
        ring.disconnect()
    if produced is not None:
        produced.value = n
    return n
