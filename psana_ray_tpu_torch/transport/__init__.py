"""In-process transport: the bounded ring buffer."""

from psana_ray_tpu_torch.transport.ring import EMPTY, FULL, RingBuffer, TransportClosed

__all__ = ["EMPTY", "FULL", "RingBuffer", "TransportClosed"]
