"""Transports: the in-process bounded ring, the shared-memory ring, the
TCP queue server and its client, the in-process rendezvous registry, the
producer's backoff policy and the address schemes that select a
transport (:mod:`psana_ray_tpu_torch.transport.addressing`)."""

from psana_ray_tpu_torch.transport.backoff import BackoffPolicy
from psana_ray_tpu_torch.transport.registry import (
    Registry,
    RendezvousTimeout,
    TransportClosed,
    TransportWedged,
)
from psana_ray_tpu_torch.transport.ring import EMPTY, FULL, RingBuffer
from psana_ray_tpu_torch.transport.shm_ring import ShmRingBuffer
from psana_ray_tpu_torch.transport.tcp import TcpQueueClient, TcpQueueServer

__all__ = ["EMPTY", "FULL", "BackoffPolicy", "Registry", "RendezvousTimeout", "RingBuffer",
           "ShmRingBuffer", "TcpQueueClient", "TcpQueueServer", "TransportClosed",
           "TransportWedged"]
