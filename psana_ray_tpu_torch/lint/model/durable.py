"""Model: durable log + committed floor (replay 'R' / commit 'J').

Mirrors the storage durable-queue contract as the wire exposes it: a
consumer opens a replay cursor at the committed floor, reads offsets
sequentially, *processes* them, and only then commits a new floor.  A
consumer crash discards whatever was read-but-unprocessed; the next
replay restarts at the floor, redelivering it (at-least-once).

Invariants:

- ``committed-implies-processed``: every offset at or below the
  committed floor has actually been processed by the consumer.  This is
  the fenced-drain-commit bug class: commit what you *processed*, never
  what you merely *read*.
- ``loss-never``: once the floor reaches the end of the log, every
  offset was processed.

Seeded mutation (``commit_processed_only=False``): commit advances the
floor to the read cursor — frames still in flight count as done, and a
crash right after loses them forever.
"""

from __future__ import annotations

from .core import Model


class DurableFloorModel(Model):
    name = "durable"
    title = "durable log + committed floor ('R'/'J')"
    WIRE_OPS = frozenset({"_OP_REPLAY", "_OP_COMMIT"})
    WIRE_STATUSES = frozenset({"_ST_OK", "_ST_NO"})

    def __init__(self, commit_processed_only=True):
        self.commit_processed_only = commit_processed_only

    def config(self, profile):
        if profile == "quick":
            return {"frames": 2, "crashes": 1}
        return {"frames": 3, "crashes": 2}

    def init_state(self, cfg):
        # (floor, cursor, inflight, processed, crashes_left)
        return (0, 0, (), frozenset(), cfg["crashes"])

    def actions(self, state, cfg):
        floor, cursor, inflight, processed, crashes = state

        # Replay read: the consumer pulls the next offset off its cursor.
        if cursor < cfg["frames"]:
            o = cursor + 1
            yield ("client R read off=%d" % o,
                   (floor, o, inflight + (o,), processed, crashes))

        # The consumer finishes processing the oldest in-flight offset.
        if inflight:
            o = inflight[0]
            yield ("consumer processed off=%d" % o,
                   (floor, cursor, inflight[1:], processed | {o}, crashes))

        # Commit: advance the floor to the processed prefix (or, mutated,
        # straight to the read cursor).
        new_floor = floor
        if self.commit_processed_only:
            while new_floor + 1 in processed:
                new_floor += 1
        else:
            new_floor = cursor
        if new_floor > floor:
            yield ("client J commit floor=%d" % new_floor,
                   (new_floor, cursor, inflight, processed, crashes))

        # Consumer crash: in-flight reads vanish; the next replay cursor
        # reopens at the committed floor.
        if crashes > 0:
            yield ("crash/replay-reopen at floor=%d" % floor,
                   (floor, floor, (), processed, crashes - 1))

    def violations(self, state, cfg):
        floor, _cursor, _inflight, processed, _crashes = state
        out = []
        if any(o not in processed for o in range(1, floor + 1)):
            out.append("committed-implies-processed")
        if floor == cfg["frames"] and processed != set(
                range(1, cfg["frames"] + 1)):
            out.append("loss-never")
        return out
