"""Address schemes: one queue-opening surface for the port's transports.

The port's own copy of ``shm_ring_name`` and ``open_queue`` from
``psana_ray_tpu/transport/addressing.py``. The address string selects the
transport and the ``(namespace, queue_name)`` pair names the queue in it:

- ``auto`` / ``local``: the in-process :class:`Registry` (threads of one
  process);
- ``shm://`` or ``shm://<name>``: the cross-process shared-memory ring on
  one host. With no ``<name>`` the ring is named ``<namespace>__<queue_name>``,
  so a producer and a consumer rendezvous from their configs alone. The
  ring outlives its creator until destroyed.

Producers open with ``role="producer"`` (get-or-create), consumers with
``role="consumer"`` (resolve with the config's retry loop). ``tcp://``
and ``cluster://`` addresses (the queue server and the sharded queue
service) are not ported: they raise ``NotImplementedError`` naming
ROADMAP.md Queue 1 Item 8.
"""

from __future__ import annotations

from typing import Optional

from psana_ray_tpu_torch.config import TransportConfig
from psana_ray_tpu_torch.transport.registry import Registry, RendezvousTimeout


def shm_ring_name(config: TransportConfig, address: Optional[str] = None) -> str:
    """The shm ring's name for a config: an explicit ``shm://<name>`` wins,
    else ``<namespace>__<queue_name>``."""
    address = address or config.address
    explicit = address[len("shm://"):] if address.startswith("shm://") else ""
    return explicit or f"{config.namespace}__{config.queue_name}"


def open_queue(
    config: TransportConfig,
    role: str = "consumer",
    address: Optional[str] = None,
    registry: Optional[Registry] = None,
):
    """Open the queue named by ``config`` over the transport its address
    (``address``, else ``config.address``) selects. Returns an object with
    the transport contract (put/get/size/put_wait/get_wait/get_batch/close)."""
    if role not in ("producer", "consumer"):
        raise ValueError(f"role must be producer|consumer, got {role!r}")
    address = address or config.address

    if address in ("auto", "local"):
        from psana_ray_tpu_torch.transport.ring import RingBuffer

        reg = registry or Registry.default()
        if role == "producer":
            return reg.get_or_create(
                config.namespace, config.queue_name,
                lambda: RingBuffer(config.queue_size, name=config.queue_name))
        return reg.resolve(config.namespace, config.queue_name,
                           retries=config.rendezvous_retries,
                           interval_s=config.rendezvous_interval_s)

    if address.startswith("shm://"):
        from psana_ray_tpu_torch.transport.shm_ring import ShmRingBuffer

        name = shm_ring_name(config, address)
        if role == "consumer":
            return ShmRingBuffer.attach(name, retries=config.rendezvous_retries,
                                        interval_s=config.rendezvous_interval_s)
        # producer: get-or-create. The native create is O_EXCL, so of two
        # racing creators one wins and the other attaches
        try:
            return ShmRingBuffer.attach(name, retries=0, interval_s=0.01)
        except RendezvousTimeout:
            pass
        try:
            return ShmRingBuffer.create(name, maxsize=config.queue_size)
        except RuntimeError:
            return ShmRingBuffer.attach(name, retries=config.rendezvous_retries,
                                        interval_s=config.rendezvous_interval_s)

    scheme = address.split("://", 1)[0] if "://" in address else address
    if scheme in ("tcp", "cluster"):
        raise NotImplementedError(
            f"{scheme}:// addresses (the queue server and the sharded queue service) are not "
            f"ported: ROADMAP.md Queue 1 Item 8; use auto or shm://")
    raise ValueError(f"unknown address {address!r}: expected auto, local or shm://[name]")
