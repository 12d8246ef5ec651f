"""The transports' errors.

The port's copy of the two exceptions of
``psana_ray_tpu/transport/registry.py`` that its transports raise. The
rendezvous registry itself is not ported (the TCP transport and the
queue server, Queue 1 Item 8).
"""

from __future__ import annotations


class TransportClosed(RuntimeError):
    """The transport was closed: no further puts or gets."""


class TransportWedged(TransportClosed):
    """A peer process died mid-operation (it claimed a slot and never
    committed or released it), blocking the queue at that slot for good.

    A subclass of :class:`TransportClosed` so it is never mistaken for
    starvation. Handlers that treat closure as a clean end of stream (the
    batcher's tail flush) re-raise this subclass: a wedge means lost data.
    Recovery: destroy and recreate the ring; the items in the wedged
    region are lost."""
