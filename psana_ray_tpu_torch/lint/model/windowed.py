"""Model: client windowed-PUT sender vs evloop '_OP_PUT_SEQ' handler.

Mirrors the tcp.py client machinery (``put_pipelined`` /
``_resend_put_window`` / ``_drain_put_acks``) talking to the evloop
``_op_put_seq`` path:

- the client appends (seq, item) to its unacked deque *before* sending,
- the connection is FIFO in both directions while it lives,
- a crash wipes both wires; on reconnect the client resends the WHOLE
  unacked tail in sequence order before anything new (that rule is what
  keeps the server's accepted-seq view hole-free),
- acks are cumulative: the client drops unacked entries <= acked seq.

Invariants:

- ``holes-never``: the server never accepts seq s with s > max_seen + 1.
  Duplicates (s <= max_seen, the at-least-once cost of resend) are fine.
- ``loss-never``: once the client is quiescent (everything sent, acked,
  wires empty) every frame reached the server.

Seeded mutation (``resend_full_tail=False``): reconnect resends only the
*newest* unacked frame — the classic "resend what bounced, not the
tail" bug.  holes-never fires within a handful of steps.
"""

from __future__ import annotations

from .core import Model


class WindowedPutModel(Model):
    name = "windowed"
    title = "client windowed-PUT sender ('W')"
    WIRE_OPS = frozenset({"_OP_PUT_SEQ"})
    WIRE_STATUSES = frozenset({"_ST_OK", "_ST_CLOSED", "_ST_ERR"})

    def __init__(self, resend_full_tail=True):
        self.resend_full_tail = resend_full_tail

    def config(self, profile):
        if profile == "quick":
            return {"frames": 2, "window": 2, "crashes": 1}
        return {"frames": 3, "window": 2, "crashes": 2}

    def init_state(self, cfg):
        # (next_seq, unacked, wire_req, wire_ack, server_max, hole, crashes_left)
        return (1, (), (), (), 0, False, cfg["crashes"])

    def actions(self, state, cfg):
        next_seq, unacked, wire_req, wire_ack, server_max, hole, crashes = state

        # Client sends a new frame while the window has room.
        if next_seq <= cfg["frames"] and len(unacked) < cfg["window"]:
            yield ("client W seq=%d" % next_seq,
                   (next_seq + 1, unacked + (next_seq,),
                    wire_req + (next_seq,), wire_ack, server_max, hole,
                    crashes))

        # Server consumes the head of the request wire, answers _ST_OK+seq.
        if wire_req:
            s = wire_req[0]
            new_hole = hole or s > server_max + 1
            label = ("server recv W seq=%d -> ack" % s if s > server_max
                     else "server recv W seq=%d (dup) -> ack" % s)
            yield (label,
                   (next_seq, unacked, wire_req[1:], wire_ack + (s,),
                    max(server_max, s), new_hole, crashes))

        # Client drains the head of the ack wire (cumulative).
        if wire_ack:
            a = wire_ack[0]
            kept = tuple(s for s in unacked if s > a)
            yield ("client drain ack<=%d" % a,
                   (next_seq, kept, wire_req, wire_ack[1:], server_max,
                    hole, crashes))

        # Crash/reconnect injection: both wires vanish, the client resends
        # its unacked tail (or, mutated, only the newest entry).
        if crashes > 0:
            resent = unacked if self.resend_full_tail else unacked[-1:]
            yield ("crash/reconnect -> resend %s" % (list(resent),),
                   (next_seq, unacked, resent, (), server_max, hole,
                    crashes - 1))

    def violations(self, state, cfg):
        next_seq, unacked, wire_req, wire_ack, server_max, hole, crashes = state
        out = []
        if hole:
            out.append("holes-never")
        if (next_seq > cfg["frames"] and not unacked and not wire_req
                and not wire_ack and server_max != cfg["frames"]):
            out.append("loss-never")
        return out
