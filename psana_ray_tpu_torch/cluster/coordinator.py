"""Consumer-group coordinator state: membership, generations, fencing.

The port's copy of ``psana_ray_tpu/cluster/coordinator.py``. The cluster's
one piece of shared control state lives on a queue server (the first
live address of the cluster list, :func:`coordinator_address`) behind the
group RPC ('N', :mod:`psana_ray_tpu_torch.transport.tcp`): members join,
heartbeat and leave a named group, and every answer carries the group's
``generation`` and sorted member list. Assignment is not negotiated here:
it is :func:`~psana_ray_tpu_torch.cluster.hashring.assign_group_partitions`
of the member list, so agreeing on membership is agreeing on assignment.

- **Fencing.** Every membership change bumps ``generation``; a request
  that carries an older one is answered ``fenced`` and not applied, so a
  member that missed a rebalance cannot commit drain progress against an
  assignment it no longer holds.
- **Liveness.** Members heartbeat within ``session_timeout_s``; each
  request sweeps the expired first (no timer thread).
- **Drain epochs.** A join into an empty group whose drain set is left
  from an earlier run starts a new epoch (drained set and offsets
  cleared), except a group just recovered from the store with a partial
  drain: its members are rejoining mid-stream.
- **Persistence.** With ``store_path`` (the queue server's
  ``--durable_dir``), every mutating request snapshots the control state
  (generation, partition count, drained partitions, their committed
  offsets) atomically, and a restarted coordinator recovers it. Leases are
  liveness and are not stored: members rejoin. The file is the JAX
  package's, byte for byte, so either package recovers the other's.

- **The leader lease** (replication, :mod:`psana_ray_tpu_torch.cluster.
  replication`). ``lease`` takes or renews the lease for a ``holder``
  (refused while another holder's lease is live); ``sync`` absorbs the
  holder's snapshot of the control state, group by group, never lowering
  a group's generation, so a stale snapshot cannot undo a fence. An
  absorbed sync is persisted but never fires ``on_mutate`` (relaying it
  would loop).

This module is stdlib-only: the server hands it decoded JSON and sends
back what it returns.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

# a member's lease: long against stop-the-world pauses (the client beats
# from a thread every second), short enough that a dead member's
# partitions move within seconds
DEFAULT_SESSION_TIMEOUT_S = 10.0
# the leader lease the acting coordinator holds on the registry it syncs
# into: a failed-over coordinator takes over once it lapses
DEFAULT_LEASE_TTL_S = 10.0


class _Group:
    __slots__ = ("generation", "members", "drained", "n_partitions", "offsets",
                 "recovered_pending")

    def __init__(self):
        self.generation = 0
        self.members: Dict[str, float] = {}  # member id -> last seen (monotonic)
        self.drained: set = set()  # partitions committed fully drained
        self.n_partitions = 0
        self.offsets: Dict[int, int] = {}  # partition -> committed log offset
        # True from a recovery to the first join: an empty member list then
        # means "rejoining", not "a finished run reusing the name"
        self.recovered_pending = False


class GroupRegistry:
    """Server-side consumer-group state behind the 'N' RPC. Requests and
    answers are JSON dicts:

    - ``{"op": "join", "group", "member", "n_partitions"}`` ->
      ``{"ok": true, "generation", "members", "drained", "n_partitions"}``
      (and ``"offsets"`` where a commit carried one);
    - ``{"op": "heartbeat", "group", "member", "generation"}`` -> the same,
      or ``{"ok": false, "fenced": true, ...}`` for a stale generation or an
      expired member;
    - ``{"op": "leave", "group", "member"}``;
    - ``{"op": "drained", "group", "member", "generation", "partition"[,
      "offset"]}``: a fenced commit that the partition saw its whole EOS
      tally, kept group-wide across rebalances;
    - ``{"op": "info", "group"}``: the state, no mutation;
    - ``{"op": "lease", "holder"[, "ttl"]}`` -> ``{"ok": true, "holder"}``,
      or ``{"ok": false, "fenced": true, "holder", "expires_in_s"}`` while
      another holder's lease is live;
    - ``{"op": "sync", "holder", "groups"}`` -> ``{"ok": true, "absorbed"}``
      under the same lease rule.
    """

    def __init__(self, session_timeout_s: float = DEFAULT_SESSION_TIMEOUT_S,
                 store_path: Optional[str] = None):
        self.session_timeout_s = session_timeout_s
        self._lock = threading.Lock()
        self._groups: Dict[str, _Group] = {}  # guarded-by: _lock
        self._store_path = store_path
        self._dirty = False  # guarded-by: _lock
        # the leader lease: (holder address, monotonic expiry)
        self._lease = ("", 0.0)  # guarded-by: _lock
        # called after a client's mutation is persisted, never after an
        # absorbed sync; it runs under the lock, so it must not block (the
        # replication manager sets an Event)
        self.on_mutate = None
        if store_path:
            self._load()

    # -- the store -----------------------------------------------------------
    def _load(self) -> None:
        try:
            with open(self._store_path, "r") as f:
                data = json.load(f)
        except (OSError, ValueError):
            return
        with self._lock:
            for name, st in data.get("groups", {}).items():
                g = _Group()
                g.generation = int(st.get("generation", 0))
                g.n_partitions = int(st.get("n_partitions", 0))
                g.drained = {int(p) for p in st.get("drained", ())}
                g.offsets = {int(p): int(o) for p, o in st.get("offsets", {}).items()}
                g.recovered_pending = True
                self._groups[name] = g

    def _persist(self) -> None:
        """One atomic snapshot after a mutating request (membership changes
        and drain commits, never a plain heartbeat)."""
        # guarded-by-caller: _lock
        if not self._store_path:
            return
        data = {"groups": self._snapshot()}
        tmp = self._store_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(data, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._store_path)
        except OSError:
            pass  # best effort: the RPC's answer must land

    def _snapshot(self) -> dict:
        # guarded-by-caller: _lock
        return {name: {"generation": g.generation, "n_partitions": g.n_partitions,
                       "drained": sorted(g.drained),
                       "offsets": {str(p): o for p, o in g.offsets.items()}}
                for name, g in self._groups.items()}

    def snapshot_groups(self) -> dict:
        """The control state, as the store holds it (leases are not state)."""
        with self._lock:
            return self._snapshot()

    # -- the RPC -------------------------------------------------------------
    def handle(self, req: dict) -> dict:
        op = req.get("op")
        if op in ("lease", "sync"):
            with self._lock:
                try:
                    return self._control(op, req)
                finally:
                    if self._dirty:
                        self._dirty = False
                        self._persist()
        group = req.get("group")
        if not isinstance(group, str) or not group:
            return {"ok": False, "error": "missing group"}
        with self._lock:
            try:
                return self._dispatch(op, group, req.get("member"), req)
            finally:
                if self._dirty:
                    self._dirty = False
                    self._persist()
                    if self.on_mutate is not None:
                        try:
                            self.on_mutate()
                        except Exception:  # a broken hook must not break the RPC
                            pass

    def _dispatch(self, op, group, member, req: dict) -> dict:
        # guarded-by-caller: _lock
        g = self._groups.get(group)
        if op == "join":
            if g is None:
                g = self._groups[group] = _Group()
            self._sweep(g)
            # refuse before enrolling: a refused join leaves no trace
            n_parts = int(req.get("n_partitions") or 0)
            if n_parts > 0 and g.n_partitions and g.n_partitions != n_parts:
                return {"ok": False, "error": f"group {group!r} was created with "
                                              f"n_partitions={g.n_partitions}, not {n_parts}"}
            drained_complete = g.n_partitions > 0 and len(g.drained) >= g.n_partitions
            if not g.members and g.drained and (not g.recovered_pending or drained_complete):
                # a new stream epoch under a reused name
                g.drained.clear()
                g.offsets.clear()
                g.generation += 1
            g.recovered_pending = False
            if member not in g.members:
                g.generation += 1
            g.members[member] = time.monotonic()
            if n_parts > 0:
                g.n_partitions = n_parts
            self._dirty = True
            return self._state(g, ok=True)
        if g is None:
            return {"ok": False, "unknown_group": True}
        self._sweep(g)
        if op == "heartbeat":
            return self._fenced_touch(g, member, req)
        if op == "leave":
            if member in g.members:
                del g.members[member]
                g.generation += 1
                self._dirty = True
            return self._state(g, ok=True)
        if op == "drained":
            out = self._fenced_touch(g, member, req)
            if not out.get("ok"):
                return out
            p = int(req.get("partition", -1))
            if 0 <= p and (not g.n_partitions or p < g.n_partitions):
                g.drained.add(p)
                off = req.get("offset")
                if off is not None:
                    g.offsets[p] = max(int(off), g.offsets.get(p, -1))
                self._dirty = True
            return self._state(g, ok=True)
        if op == "info":
            return self._state(g, ok=True)
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _control(self, op: str, req: dict) -> dict:
        """``lease`` and ``sync`` (see the class docstring)."""
        # guarded-by-caller: _lock
        holder = str(req.get("holder") or "")
        if not holder:
            return {"ok": False, "error": "missing holder"}
        now = time.monotonic()
        cur, expires = self._lease
        if cur and cur != holder and expires > now:
            return {"ok": False, "fenced": True, "holder": cur,
                    "expires_in_s": round(expires - now, 3)}
        if cur != holder:
            from psana_ray_tpu_torch.cluster.replication import REPL

            REPL.note("lease_transfer", prev=cur or None, holder=holder)
        self._lease = (holder, now + float(req.get("ttl") or DEFAULT_LEASE_TTL_S))
        if op == "lease":
            return {"ok": True, "holder": holder}
        absorbed = 0
        for name, st in (req.get("groups") or {}).items():
            try:
                gen = int(st.get("generation", 0))
            except (TypeError, ValueError, AttributeError):
                continue
            g = self._groups.get(name)
            if g is None:
                g = self._groups[name] = _Group()
            elif gen < g.generation:
                continue  # a stale snapshot never lowers the fence
            g.generation = gen
            g.n_partitions = int(st.get("n_partitions", g.n_partitions) or 0)
            g.drained = {int(p) for p in st.get("drained", ())}
            g.offsets = {int(p): int(o) for p, o in (st.get("offsets") or {}).items()}
            if not g.members and g.drained and not (
                    g.n_partitions and len(g.drained) >= g.n_partitions):
                # as after a recovery from the store: members will rejoin
                # mid-stream, so the new-epoch wipe must not fire
                g.recovered_pending = True
            absorbed += 1
        if absorbed:
            self._dirty = True
        return {"ok": True, "absorbed": absorbed}

    def _sweep(self, g: _Group) -> None:
        """Expire lapsed leases; each expiry bumps the generation."""
        # guarded-by-caller: _lock
        cutoff = time.monotonic() - self.session_timeout_s
        dead = [m for m, seen in g.members.items() if seen < cutoff]
        for m in dead:
            del g.members[m]
        if dead:
            g.generation += 1
            self._dirty = True

    def _fenced_touch(self, g: _Group, member, req: dict) -> dict:
        """Refresh ``member``'s lease if its generation is current and it is
        still a member; else answer fenced."""
        # guarded-by-caller: _lock
        if member not in g.members or req.get("generation") != g.generation:
            return self._state(g, ok=False, fenced=True)
        g.members[member] = time.monotonic()
        return self._state(g, ok=True)

    def _state(self, g: _Group, ok: bool, fenced: bool = False) -> dict:
        # guarded-by-caller: _lock
        out = {"ok": ok, "generation": g.generation, "members": sorted(g.members),
               "drained": sorted(g.drained), "n_partitions": g.n_partitions}
        if g.offsets:
            out["offsets"] = {str(p): o for p, o in sorted(g.offsets.items())}
        if fenced:
            out["fenced"] = True
        return out

    def stats(self) -> dict:
        with self._lock:
            return {group: {"generation": g.generation, "members": len(g.members),
                            "drained": len(g.drained), "n_partitions": g.n_partitions}
                    for group, g in self._groups.items()}


def coordinator_address(servers) -> str:
    """Where clients find the registry: the first address of the list
    (every party must give the list in the same order)."""
    servers = list(servers)
    if not servers:
        raise ValueError("empty cluster server list")
    return servers[0]
