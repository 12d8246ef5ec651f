"""Rendezvous (highest-random-weight) placement.

The port's copy of ``partition_owner`` and its score from
``psana_ray_tpu/cluster/hashring.py``: every member scores a key with a
keyed hash and the highest score owns it. The score is ``hashlib``'s,
not ``hash()``'s, so every process and run (and the JAX package) computes
the same owner.
"""

from __future__ import annotations

import hashlib
from typing import Sequence


def _score(server: str, queue_name: str, partition: int) -> int:
    key = f"{server}|{queue_name}|{partition}".encode()
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(), "little")


def partition_owner(servers: Sequence[str], queue_name: str, partition: int) -> str:
    """The member owning ``(queue_name, partition)``: the highest score,
    ties broken by the member's name."""
    if not servers:
        raise ValueError("no live servers to place partitions on")
    return max(servers, key=lambda s: (_score(s, queue_name, partition), s))
