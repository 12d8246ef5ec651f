"""The client half of consumer groups: one member's generation-fenced lease.

The port's copy of ``psana_ray_tpu/cluster/group.py``. A
:class:`GroupSession` holds a member's view of its group (generation,
members, drained partitions) and the partitions the assignment gives it,
and keeps it fresh through rate-limited heartbeats. It never touches a
socket: the owning :class:`~psana_ray_tpu_torch.cluster.client.
ClusterClient` injects ``rpc(payload) -> dict`` (the 'N' opcode on the
coordinator).

Every mutating request carries the generation the member last saw. A
``fenced`` answer means the group moved on without it: the session
rejoins at once, and the caller recomputes its assignment and releases
revoked partitions before it reads them again. Frames in flight on a
revoked partition go back to the head of its queue for the new owner, so
a fence costs duplicates at worst, never loss.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, Optional, Tuple

from psana_ray_tpu_torch.cluster.hashring import assign_group_partitions
from psana_ray_tpu_torch.cluster.telemetry import CLUSTER


class GroupSession:
    """One member's lease on a named consumer group. Thread-safe by
    itself: its lock guards the absorbed state and the rate limiter, and
    the wire exchange runs outside it, so the client's keepalive thread
    beats without the client's lock."""

    def __init__(self, rpc: Callable[[dict], dict], group: str,
                 member_id: Optional[str] = None, n_partitions: int = 0,
                 heartbeat_s: float = 1.0):
        self.rpc = rpc
        self.group = group
        self.member_id = member_id or f"member-{uuid.uuid4().hex[:12]}"
        self.n_partitions = n_partitions
        self.heartbeat_s = heartbeat_s
        self._slock = threading.Lock()
        self.generation = -1  # guarded-by: _slock
        self.members: Tuple[str, ...] = ()  # guarded-by: _slock
        self.drained: frozenset = frozenset()  # guarded-by: _slock
        self._last_beat = 0.0  # guarded-by: _slock

    def join_group(self) -> bool:
        """(Re)join; never fenced. True when the generation changed."""
        resp = self.rpc({"op": "join", "group": self.group, "member": self.member_id,
                         "n_partitions": self.n_partitions})
        if not resp.get("ok"):
            raise RuntimeError(f"group join refused: {resp}")
        with self._slock:
            self._last_beat = time.monotonic()
        return self._absorb(resp)

    def leave(self) -> None:
        try:
            self.rpc({"op": "leave", "group": self.group, "member": self.member_id})
        except Exception:  # noqa: BLE001 (best effort: the lease expires anyway)
            pass

    def maybe_heartbeat(self) -> bool:
        """A lease refresh at most every ``heartbeat_s``. True when the
        generation changed (the caller rebalances before its next read); a
        fenced answer rejoins at once."""
        with self._slock:
            now = time.monotonic()
            if now - self._last_beat < self.heartbeat_s:
                return False
            self._last_beat = now
            gen = self.generation
        resp = self.rpc({"op": "heartbeat", "group": self.group, "member": self.member_id,
                         "generation": gen})
        if resp.get("fenced") or resp.get("unknown_group"):
            CLUSTER.fenced_op()
            return self.join_group()
        return self._absorb(resp)

    def commit_drained(self, partition: int, offset: Optional[int] = None) -> bool:
        """Commit that ``partition`` completed its EOS tally, fenced by the
        generation. False, after a rejoin, when fenced: the caller must not
        take its own tally as the group's. ``offset`` (a durable partition's
        committed log offset) rides the commit into the coordinator's store."""
        with self._slock:
            gen = self.generation
        payload = {"op": "drained", "group": self.group, "member": self.member_id,
                   "generation": gen, "partition": partition}
        if offset is not None:
            payload["offset"] = int(offset)
        resp = self.rpc(payload)
        if resp.get("fenced") or resp.get("unknown_group"):
            CLUSTER.fenced_op()
            self.join_group()
            return False
        self._absorb(resp)
        return bool(resp.get("ok"))

    def assigned(self) -> Tuple[int, ...]:
        """This member's partitions under the current membership."""
        with self._slock:
            members = self.members
        if not members:
            return ()
        return assign_group_partitions(members, self.member_id, self.n_partitions)

    def all_drained(self) -> bool:
        """Every partition committed drained: the group's end of stream."""
        with self._slock:
            return self.n_partitions > 0 and len(self.drained) >= self.n_partitions

    def _absorb(self, resp: dict) -> bool:
        with self._slock:
            gen = int(resp.get("generation", self.generation))
            if gen < self.generation:
                return False  # a slow answer raced a newer one: never go back
            self.members = tuple(resp.get("members", self.members))
            self.drained = frozenset(int(p) for p in resp.get("drained", ()))
            if gen != self.generation:
                self.generation = gen
                return True
            return False
