"""Transports: the in-process bounded ring and the shared-memory ring."""

from psana_ray_tpu_torch.transport.registry import TransportClosed, TransportWedged
from psana_ray_tpu_torch.transport.ring import EMPTY, FULL, RingBuffer
from psana_ray_tpu_torch.transport.shm_ring import ShmRingBuffer

__all__ = ["EMPTY", "FULL", "RingBuffer", "ShmRingBuffer", "TransportClosed", "TransportWedged"]
