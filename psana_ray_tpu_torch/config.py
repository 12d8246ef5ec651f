"""Transport configuration: the port's own copy of the part of
``psana_ray_tpu/config.py``'s ``TransportConfig`` that queue addressing
reads.

The fields keep the JAX package's names and defaults (the reference's
``--ray_address --ray_namespace --queue_name --queue_size`` and its
10 x 1 s rendezvous loop). The JAX package's other fields (the TCP
transport's backoff and batching, the wire codec and dtype, tenants,
consumer groups, the cluster and durable replay) belong to transports the
port has not ported: naming one raises ``NotImplementedError`` that names
ROADMAP.md Queue 1 Item 8.
"""

from __future__ import annotations

import dataclasses

# the JAX package's TransportConfig fields that the port does not carry
NOT_PORTED = frozenset({
    "num_consumers", "backoff_base_s", "backoff_cap_s", "backoff_jitter_s", "poll_interval_s",
    "put_batch_size", "cluster_partitions", "group", "member_id", "replay_from",
    "replay_group", "wire_codec", "wire_dtype", "tenant", "tenant_weight",
})


@dataclasses.dataclass(init=False)
class TransportConfig:
    """Queue and rendezvous: the transport an address selects, the
    ``(namespace, queue_name)`` pair that names the queue in it, the
    queue's size where this side creates it, and the consumer's
    rendezvous loop (``rendezvous_retries`` x ``rendezvous_interval_s``)."""

    address: str = "auto"
    namespace: str = "default"
    queue_name: str = "shared_queue"
    queue_size: int = 100
    rendezvous_retries: int = 10
    rendezvous_interval_s: float = 1.0

    def __init__(self, address: str = "auto", namespace: str = "default",
                 queue_name: str = "shared_queue", queue_size: int = 100,
                 rendezvous_retries: int = 10, rendezvous_interval_s: float = 1.0,
                 **not_ported):
        unknown = sorted(set(not_ported) - NOT_PORTED)
        if unknown:
            raise TypeError(f"TransportConfig has no field {unknown[0]!r}")
        if not_ported:
            raise NotImplementedError(
                f"TransportConfig field(s) {sorted(not_ported)} belong to transports the port "
                f"has not ported (TCP, wire codecs, tenants, the cluster): ROADMAP.md Queue 1 "
                f"Item 8")
        self.address = address
        self.namespace = namespace
        self.queue_name = queue_name
        self.queue_size = queue_size
        self.rendezvous_retries = rendezvous_retries
        self.rendezvous_interval_s = rendezvous_interval_s
