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
- :mod:`~psana_ray_tpu_torch.cluster.telemetry`: the ``CLUSTER`` counters.

``ClusterClient`` and ``GroupSession`` load lazily: ``transport.tcp``
imports the coordinator (the server hosts the groups) and the client
imports ``transport.tcp``. Replication (``cluster/replication.py``) is
not ported (ROADMAP.md Queue 1 Item 8). Imports no torch.
"""

from psana_ray_tpu_torch.cluster.coordinator import GroupRegistry, coordinator_address
from psana_ray_tpu_torch.cluster.hashring import (
    PartitionMap,
    assign_group_partitions,
    partition_owner,
    partition_queue_name,
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
    "parse_cluster_address",
    "partition_owner",
    "partition_queue_name",
]


def __getattr__(name):
    if name in ("ClusterClient", "parse_cluster_address"):
        from psana_ray_tpu_torch.cluster import client as _client

        return getattr(_client, name)
    if name == "GroupSession":
        from psana_ray_tpu_torch.cluster.group import GroupSession

        return GroupSession
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
