"""Transports: the in-process bounded ring, the shared-memory ring, the
in-process rendezvous registry, the producer's backoff policy and the
address schemes that select a transport
(:mod:`psana_ray_tpu_torch.transport.addressing`)."""

from psana_ray_tpu_torch.transport.backoff import BackoffPolicy
from psana_ray_tpu_torch.transport.registry import (
    Registry,
    RendezvousTimeout,
    TransportClosed,
    TransportWedged,
)
from psana_ray_tpu_torch.transport.ring import EMPTY, FULL, RingBuffer
from psana_ray_tpu_torch.transport.shm_ring import ShmRingBuffer

__all__ = ["EMPTY", "FULL", "BackoffPolicy", "Registry", "RendezvousTimeout", "RingBuffer",
           "ShmRingBuffer", "TransportClosed", "TransportWedged"]
