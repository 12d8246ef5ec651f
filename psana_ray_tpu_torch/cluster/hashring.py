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

The replication chain's ranking (``ranked_owners``, ``partition_follower``,
``next_in_chain``, ``PartitionMap.follower_of``) is not ported
(ROADMAP.md Queue 1 Item 8).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Sequence, Tuple


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
