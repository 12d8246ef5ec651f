"""The sharded queue cluster: N queue servers, one logical queue.

The port's copy of ``psana_ray_tpu/cluster/``:

- :mod:`~psana_ray_tpu_torch.cluster.hashring`: rendezvous placement of
  partitions (``PartitionMap``), the consumer group's assignment, and the
  ranking the queue server's worker fleet pins queues by;
- :mod:`~psana_ray_tpu_torch.cluster.coordinator`: the server's
  consumer-group registry behind the 'N' RPC, with its persisted store;
- :mod:`~psana_ray_tpu_torch.cluster.group`: a member's fenced lease;
- :mod:`~psana_ray_tpu_torch.cluster.client`: ``ClusterClient``, the
  routing client behind ``cluster://host:port,host:port`` addresses;
- :mod:`~psana_ray_tpu_torch.cluster.telemetry`: the ``CLUSTER`` counters;
- :mod:`~psana_ray_tpu_torch.cluster.replication`: chain replication of
  durable partition logs, the replicated ack floor, promotion and the
  coordinator's leader lease (the ``REPL`` counters).

``ClusterClient`` and ``GroupSession`` load lazily: ``transport.tcp``
imports the coordinator (the server hosts the groups) and the client
imports ``transport.tcp``; so does replication, which is imported from
its module. Imports no torch.
"""

from psana_ray_tpu_torch.cluster.coordinator import GroupRegistry, coordinator_address
from psana_ray_tpu_torch.cluster.hashring import (
    PartitionMap,
    assign_group_partitions,
    next_in_chain,
    partition_follower,
    partition_owner,
    partition_queue_name,
    ranked_owners,
)
from psana_ray_tpu_torch.cluster.telemetry import CLUSTER

__all__ = [
    "CLUSTER",
    "ClusterClient",
    "GroupRegistry",
    "GroupSession",
    "PartitionMap",
    "assign_group_partitions",
    "coordinator_address",
    "next_in_chain",
    "parse_cluster_address",
    "partition_follower",
    "partition_owner",
    "partition_queue_name",
    "ranked_owners",
]


def __getattr__(name):
    if name in ("ClusterClient", "parse_cluster_address"):
        from psana_ray_tpu_torch.cluster import client as _client

        return getattr(_client, name)
    if name == "GroupSession":
        from psana_ray_tpu_torch.cluster.group import GroupSession

        return GroupSession
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
