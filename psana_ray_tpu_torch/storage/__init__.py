"""Durable segment-log storage under the queue server.

The port's copy of ``psana_ray_tpu/storage/``, byte for byte the JAX
package's on-disk format, so a log directory written by either package's
queue server boots in the other's:

- :mod:`~psana_ray_tpu_torch.storage.segment`: fixed-size, pre-allocated,
  recycled mmap'd segment files with CRC-framed records (a torn tail
  from a crash is cut on the next boot, never served);
- :mod:`~psana_ray_tpu_torch.storage.log`: :class:`SegmentLog`, an
  append-only offset-addressed record log over a ring of segments, with
  bounded retention, committed offsets per consumer group and a
  crash-recovery scan; :class:`ReplayCursor`, a non-destructive reader;
- :mod:`~psana_ray_tpu_torch.storage.durable`: :class:`DurableRingBuffer`,
  the log-backed ``RingBuffer`` the queue server mounts under
  ``--durable_dir``;
- :mod:`~psana_ray_tpu_torch.storage.telemetry`: the process's durability
  counters (:data:`DURABLE`).

At least once end to end: duplicates possible, holes never, across
``kill -9`` too (page-cache writes outlive the process; the ``fsync``
policy chooses how much a machine crash may lose). Imports no torch.
"""

from psana_ray_tpu_torch.storage.durable import DurableRingBuffer, SpilledRecord
from psana_ray_tpu_torch.storage.log import (
    COMMIT_DELIVERED,
    FSYNC_ALWAYS,
    FSYNC_BATCH,
    FSYNC_NONE,
    REPLAY_BEGIN,
    REPLAY_RESUME,
    ReplayCursor,
    SegmentLog,
    set_disk_fault_hook,
)
from psana_ray_tpu_torch.storage.telemetry import DURABLE

__all__ = [
    "COMMIT_DELIVERED", "DURABLE", "DurableRingBuffer", "FSYNC_ALWAYS", "FSYNC_BATCH",
    "FSYNC_NONE", "REPLAY_BEGIN", "REPLAY_RESUME", "ReplayCursor", "SegmentLog",
    "SpilledRecord", "set_disk_fault_hook",
]
