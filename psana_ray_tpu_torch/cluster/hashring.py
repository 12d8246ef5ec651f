"""Partition placement: rendezvous (highest-random-weight) hashing.

The port's copy of ``psana_ray_tpu/cluster/hashring.py``. A logical
queue becomes ``n_partitions`` partitions; partition ``p`` of
``queue_name`` is the ordinary named queue ``<queue_name>#p<p>``
(:func:`partition_queue_name`) on the one server that scores highest for
it. When a server joins, only the partitions it now wins move; when one
dies, only its partitions move, each to its runner-up. Every client
computes the same map from the same live set, so producers and consumers
agree on placement as long as they agree on the address list.

The score is ``hashlib``'s blake2b over ``f"{server}|{queue}|{p}"``, not
``hash()``'s, so every process and run, and the JAX package, computes
the same owner: clients of either package place partitions on servers of
either package. Server strings are used as the address list spells them
(``localhost`` and ``127.0.0.1`` are different servers here).

The whole ranking is the replication chain (:mod:`psana_ray_tpu_torch.
cluster.replication`): rank 0 owns a partition, rank 1 holds its replica,
and when rank 0 dies the recomputed map hands the partition to rank 1,
the server that already holds the bytes (``ranked_owners``,
``partition_follower``, ``next_in_chain``, ``PartitionMap.follower_of``).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Sequence, Tuple


def partition_queue_name(queue_name: str, partition: int) -> str:
    """The server-side named queue that hosts one partition."""
    return f"{queue_name}#p{partition}"


def _score(server: str, queue_name: str, partition: int) -> int:
    key = f"{server}|{queue_name}|{partition}".encode()
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(), "little")


def partition_owner(servers: Sequence[str], queue_name: str, partition: int) -> str:
    """The member owning ``(queue_name, partition)``: the highest score,
    ties broken by the member's name."""
    if not servers:
        raise ValueError("no live servers to place partitions on")
    return max(servers, key=lambda s: (_score(s, queue_name, partition), s))


def ranked_owners(servers: Sequence[str], queue_name: str, partition: int) -> Tuple[str, ...]:
    """Every server ranked by score for ``(queue_name, partition)``, best
    first: the replication chain. A server that mounts the partition
    replicates to the next rank after itself, so the chain extends again
    after every promotion."""
    return tuple(sorted(dict.fromkeys(servers),
                        key=lambda s: (_score(s, queue_name, partition), s), reverse=True))


def partition_follower(servers: Sequence[str], queue_name: str,
                       partition: int) -> Optional[str]:
    """The partition's replica holder: the runner-up (None on one server)."""
    ranked = ranked_owners(servers, queue_name, partition)
    return ranked[1] if len(ranked) > 1 else None


def next_in_chain(servers: Sequence[str], self_addr: str, queue_name: str,
                  partition: int) -> Optional[str]:
    """Where ``self_addr`` replicates ``(queue_name, partition)`` when it
    mounts it: the next server after itself in the ranking (None when it
    is last, or not in the list)."""
    ranked = ranked_owners(servers, queue_name, partition)
    try:
        i = ranked.index(self_addr)
    except ValueError:
        return None
    return ranked[i + 1] if i + 1 < len(ranked) else None


@dataclasses.dataclass(frozen=True)
class PartitionMap:
    """One immutable placement of a queue's partitions over a live server
    set: ``assignments[p]`` is the owner's ``host:port``. :meth:`compute`
    makes the first map, :meth:`recompute` the next one over a changed
    live set (``version`` + 1; only the partitions rendezvous forces move)."""

    queue_name: str
    n_partitions: int
    servers: Tuple[str, ...]
    version: int
    assignments: Dict[int, str]

    @classmethod
    def compute(cls, servers: Sequence[str], queue_name: str, n_partitions: int,
                version: int = 1) -> "PartitionMap":
        if n_partitions <= 0:
            raise ValueError("n_partitions must be positive")
        live = tuple(dict.fromkeys(servers))  # order-preserving dedup
        return cls(queue_name=queue_name, n_partitions=n_partitions, servers=live,
                   version=version,
                   assignments={p: partition_owner(live, queue_name, p)
                                for p in range(n_partitions)})

    def recompute(self, servers: Sequence[str]) -> "PartitionMap":
        return self.compute(servers, self.queue_name, self.n_partitions, self.version + 1)

    def partitions_on(self, server: str) -> Tuple[int, ...]:
        return tuple(p for p, s in sorted(self.assignments.items()) if s == server)

    def follower_of(self, partition: int) -> Optional[str]:
        """The partition's replica holder over this map's live set."""
        return partition_follower(self.servers, self.queue_name, partition)

    def moved_from(self, prev: "PartitionMap") -> Tuple[int, ...]:
        """The partitions whose owner differs from ``prev``'s."""
        return tuple(p for p in range(self.n_partitions)
                     if self.assignments.get(p) != prev.assignments.get(p))


def assign_group_partitions(members: Sequence[str], member_id: str,
                            n_partitions: int) -> Tuple[int, ...]:
    """A consumer group's assignment: partition ``p`` belongs to
    ``sorted(members)[p % len(members)]``. Disjoint and exhaustive, and the
    same on every member given the same membership, so a rebalance needs
    agreement only on who is in the group (the coordinator's answer)."""
    ordered = sorted(members)
    if member_id not in ordered:
        return ()
    i = ordered.index(member_id)
    return tuple(p for p in range(n_partitions) if p % len(ordered) == i)
