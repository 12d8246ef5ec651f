"""Model: replication chain owner/follower ('H'/'V'/'Y').

Mirrors cluster/replication.py: the owner appends producer frames to its
log, ships them to the follower over a dedicated replica connection
('H' subscribe, then 'V' appends), and parks the producer's windowed-PUT
acks until the follower has acknowledged the offset (the replicated ack
floor).  Promote ('Y') turns the follower authoritative: it refuses
further appends as fenced, and the owner fences itself on seeing the
refusal.  An owner that restarts *behind* its replica (lost its log
tail) must self-fence during the 'H' handshake rather than re-serve
divergent offsets.

Invariants:

- ``ack-floor<=follower-tail``: the owner never treats an offset as
  replicated before the follower logged it.
- ``producer-ack<=floor``: the producer is never acked past the
  replicated floor (acked frames survive owner loss).
- ``owner-behind-replica-self-fences``: a live link where the owner's
  log is shorter than the follower's only exists fenced.

Seeded mutations: ``ack_after_logged=False`` (the floor advances at ship
time — the silent-follower ack-gate wedge inverted), and
``self_fence_behind=False`` (a truncated owner keeps serving).
"""

from __future__ import annotations

from .core import Model


class ReplicationChainModel(Model):
    name = "chain"
    title = "replication chain owner/follower ('H'/'V'/'Y')"
    WIRE_OPS = frozenset({"_OP_REPL_OPEN", "_OP_REPL_APPEND", "_OP_PROMOTE"})
    WIRE_STATUSES = frozenset({"_ST_OK", "_ST_NO"})
    MODE = "replica"
    MODE_LEGAL_OPS = frozenset({"_OP_REPL_APPEND", "_OP_BYE"})

    def __init__(self, ack_after_logged=True, self_fence_behind=True):
        self.ack_after_logged = ack_after_logged
        self.self_fence_behind = self_fence_behind

    def config(self, profile):
        if profile == "quick":
            return {"frames": 2, "crashes": 1}
        return {"frames": 3, "crashes": 2}

    def init_state(self, cfg):
        # (owner_tail, shipped, ship_wire, ack_wire, follower_tail, floor,
        #  prod_acked, link_up, promoted, owner_fenced, crashes_left)
        return (0, 0, (), (), 0, 0, 0, False, False, False, cfg["crashes"])

    def actions(self, state, cfg):
        (owner_tail, shipped, ship_wire, ack_wire, follower_tail, floor,
         prod_acked, link_up, promoted, fenced, crashes) = state

        # 'H' handshake: the follower reports its tail; an owner that
        # comes up behind it must fence itself on the spot.
        if not link_up and not fenced:
            fence_now = (self.self_fence_behind
                         and follower_tail > owner_tail)
            label = ("owner H subscribe -> self-fence (behind replica)"
                     if fence_now else "owner H subscribe -> link up")
            yield (label,
                   (owner_tail, owner_tail, (), (), follower_tail, floor,
                    prod_acked, True, promoted, fenced or fence_now,
                    crashes))

        # Producer append: parked 'W' ack, new owner log entry.
        if not fenced and owner_tail < cfg["frames"]:
            yield ("producer W put -> owner append off=%d (ack parked)"
                   % (owner_tail + 1),
                   (owner_tail + 1, shipped, ship_wire, ack_wire,
                    follower_tail, floor, prod_acked, link_up, promoted,
                    fenced, crashes))

        # Ship the next owner log entry down the replica connection.
        if link_up and not fenced and shipped < owner_tail:
            o = shipped + 1
            new_floor = max(floor, o) if not self.ack_after_logged else floor
            yield ("owner V append off=%d -> follower" % o,
                   (owner_tail, o, ship_wire + (o,), ack_wire,
                    follower_tail, new_floor, prod_acked, link_up,
                    promoted, fenced, crashes))

        # Follower consumes the head 'V': log-and-ack, or refuse if it
        # has been promoted.
        if ship_wire:
            o = ship_wire[0]
            if promoted:
                yield ("follower refuses V off=%d (promoted) -> fenced" % o,
                       (owner_tail, shipped, ship_wire[1:],
                        ack_wire + ("fenced",), follower_tail, floor,
                        prod_acked, link_up, promoted, fenced, crashes))
            else:
                new_tail = max(follower_tail, o)
                yield ("follower logs V off=%d -> ack" % o,
                       (owner_tail, shipped, ship_wire[1:],
                        ack_wire + (o,), new_tail, floor, prod_acked,
                        link_up, promoted, fenced, crashes))

        # Owner consumes the head ack: floor advance or self-fence.
        if ack_wire:
            a = ack_wire[0]
            if a == "fenced":
                yield ("owner sees fenced ack -> self-fence",
                       (owner_tail, shipped, ship_wire, ack_wire[1:],
                        follower_tail, floor, prod_acked, link_up,
                        promoted, True, crashes))
            else:
                new_floor = max(floor, a) if self.ack_after_logged else floor
                yield ("owner recv ack off=%d -> floor=%d" % (a, new_floor),
                       (owner_tail, shipped, ship_wire, ack_wire[1:],
                        follower_tail, new_floor, prod_acked, link_up,
                        promoted, fenced, crashes))

        # Release parked producer acks up to the replicated floor.
        if prod_acked < floor:
            yield ("owner answers parked W acks <= %d" % floor,
                   (owner_tail, shipped, ship_wire, ack_wire,
                    follower_tail, floor, floor, link_up, promoted,
                    fenced, crashes))

        # Promote the follower ('Y'): it becomes authoritative and
        # refuses the owner from here on.
        if not promoted:
            yield ("operator Y promote follower",
                   (owner_tail, shipped, ship_wire, ack_wire,
                    follower_tail, floor, prod_acked, link_up, True,
                    fenced, crashes))

        if crashes > 0:
            # Link drop: both wires die; the owner must re-handshake.
            yield ("crash: link drop",
                   (owner_tail, shipped, (), (), follower_tail, floor,
                    prod_acked, False, promoted, fenced, crashes - 1))
            # Owner restart with a truncated log: it lost everything past
            # the replicated floor, possibly ending up behind the replica.
            yield ("crash: owner restarts truncated to floor=%d" % floor,
                   (floor, floor, (), (), follower_tail, floor,
                    prod_acked, False, promoted, fenced, crashes - 1))

    def violations(self, state, cfg):
        (owner_tail, _shipped, _ship_wire, _ack_wire, follower_tail,
         floor, prod_acked, link_up, _promoted, fenced, _crashes) = state
        out = []
        if floor > follower_tail:
            out.append("ack-floor<=follower-tail")
        if prod_acked > floor:
            out.append("producer-ack<=floor")
        if link_up and not fenced and owner_tail < follower_tail:
            out.append("owner-behind-replica-self-fences")
        return out
