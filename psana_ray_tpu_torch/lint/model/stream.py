"""Model: evloop queue/pump feeding a credit-window stream reader.

Mirrors ``_StreamState`` + ``push_stream_items`` + ``_on_stream_ack`` +
``_finish_stream`` in evloop.py against the tcp.py stream client:

- the pump pops the queue head only while (seq - acked) < window
  (credit-window flow control),
- every push lands in the per-connection unacked deque until the client
  acks it cumulatively,
- EOS is an ordinary sentinel item at the tail of the queue,
- on a dead connection ``_finish_stream`` requeues the unacked frames at
  the HEAD of the queue, in order — which is exactly why a redelivered
  frame can never be overtaken by the EOS sentinel still sitting in the
  queue behind it,
- the next subscriber starts a fresh stream epoch (seq/acked reset).

Invariants:

- ``credit-window-conservation``: seq - acked never exceeds the window.
- ``eos-never-overtakes``: the client never sees EOS while a data frame
  it has not received is still owed to it.
- ``loss-never``: every data frame is always in the queue, in the
  unacked deque, or already delivered.

Seeded mutations: ``requeue_at_head=False`` (lost frames appended behind
EOS -> eos-never-overtakes fires), ``enforce_window=False`` (pump
ignores credit -> conservation fires), ``requeue_lost=False`` (crash
discards unacked -> loss-never fires).
"""

from __future__ import annotations

from .core import Model

EOS = 0  # queue sentinel; data frames are 1..frames


class StreamModel(Model):
    name = "stream"
    title = "credit-window stream reader ('M'/'K')"
    WIRE_OPS = frozenset({"_OP_STREAM", "_OP_STREAM_ACK", "_OP_BYE"})
    WIRE_STATUSES = frozenset({"_ST_OK"})
    MODE = "stream"
    MODE_LEGAL_OPS = frozenset({"_OP_STREAM", "_OP_STREAM_ACK", "_OP_BYE"})

    def __init__(self, requeue_at_head=True, enforce_window=True,
                 requeue_lost=True):
        self.requeue_at_head = requeue_at_head
        self.enforce_window = enforce_window
        self.requeue_lost = requeue_lost

    def config(self, profile):
        if profile == "quick":
            return {"frames": 2, "window": 2, "crashes": 1}
        return {"frames": 3, "window": 2, "crashes": 2}

    def init_state(self, cfg):
        queue = tuple(range(1, cfg["frames"] + 1)) + (EOS,)
        # (queue, seq, acked, unacked, wire_push, got, eos_seen,
        #  last_recv, sent_ack, wire_ack, crashes_left)
        return (queue, 0, 0, (), (), frozenset(), False, 0, 0, (),
                cfg["crashes"])

    def actions(self, state, cfg):
        (queue, seq, acked, unacked, wire_push, got, eos_seen,
         last_recv, sent_ack, wire_ack, crashes) = state

        # Pump: pop the queue head into the stream while credit remains.
        if queue and (not self.enforce_window
                      or seq - acked < cfg["window"]):
            f = queue[0]
            s = seq + 1
            yield ("pump push seq=%d frame=%s" % (s, "EOS" if f == EOS else f),
                   (queue[1:], s, acked, unacked + ((s, f),),
                    wire_push + ((s, f),), got, eos_seen, last_recv,
                    sent_ack, wire_ack, crashes))

        # Client receives the head push.
        if wire_push:
            s, f = wire_push[0]
            new_got = got if f == EOS else got | {f}
            yield ("client recv seq=%d frame=%s" % (s, "EOS" if f == EOS else f),
                   (queue, seq, acked, unacked, wire_push[1:], new_got,
                    eos_seen or f == EOS, s, sent_ack, wire_ack, crashes))

        # Client acks cumulatively up to its last received seq.
        if last_recv > sent_ack:
            yield ("client K ack=%d" % last_recv,
                   (queue, seq, acked, unacked, wire_push, got, eos_seen,
                    last_recv, last_recv, wire_ack + (last_recv,), crashes))

        # Server consumes the head ack: prune the unacked deque.
        if wire_ack:
            a = wire_ack[0]
            kept = tuple((s, f) for (s, f) in unacked if s > a)
            yield ("server recv K ack=%d -> prune" % a,
                   (queue, seq, max(acked, a), kept, wire_push, got,
                    eos_seen, last_recv, sent_ack, wire_ack[1:], crashes))

        # Crash/reconnect: wires die, _finish_stream requeues the unacked
        # frames (at the head, in order), the next epoch starts fresh.
        if crashes > 0:
            lost = tuple(f for (_s, f) in unacked)
            if not self.requeue_lost:
                new_queue = queue
            elif self.requeue_at_head:
                new_queue = lost + queue
            else:
                new_queue = queue + lost
            yield ("crash/reconnect -> requeue %s" %
                   (["EOS" if f == EOS else f for f in lost],),
                   (new_queue, 0, 0, (), (), got, eos_seen, 0, 0, (),
                    crashes - 1))

    def violations(self, state, cfg):
        (queue, seq, acked, unacked, wire_push, got, eos_seen,
         _last_recv, _sent_ack, _wire_ack, _crashes) = state
        out = []
        if seq - acked > cfg["window"]:
            out.append("credit-window-conservation")
        frames = set(range(1, cfg["frames"] + 1))
        if eos_seen and got != frames:
            out.append("eos-never-overtakes")
        live = set(queue) | {f for (_s, f) in unacked} | got
        if not frames <= live:
            out.append("loss-never")
        return out
