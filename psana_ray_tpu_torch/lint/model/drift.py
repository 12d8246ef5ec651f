"""Drift gate: model declarations vs the extracted wire dialogue.

The models in this package are only trustworthy while they describe the
code that actually ships.  This module holds them against
``lint.flow.protocol.extract_dialogue``'s reconstruction of the scanned
tree, in both directions:

code -> model (any armed scan):
  every opcode the reconstruction finds (dispatch table + mode legal
  sets) must either be implemented by a model or carry a written
  justification in :data:`NON_MODELED`.  Adding an opcode to
  tcp.py/evloop.py without modeling it is a lint finding.

model -> code (only when the real transport is in scope):
  every opcode/status a model declares must exist in the
  reconstruction, and every mode-gated model's legal-op set must equal
  the server's dispatch guard exactly.  Removing or renaming part of
  the wire surface without updating the model is a lint finding.

The split matters for fixtures: a fixture defines a miniature protocol,
so holding the full model fleet against it would drown the scan in
ghost-op noise; holding the *fixture* against the fleet's coverage is
exactly the point.
"""

from __future__ import annotations

# Opcodes deliberately outside the model fleet.  Every entry is a
# standing claim reviewed when the op changes; an entry that names a
# modeled or nonexistent op is rot and flagged as such.
NON_MODELED = {
    "_OP_PUT": "single-shot RPC put; the windowed model covers the "
               "stateful pipelined variant",
    "_OP_PUT_WAIT": "blocking variant of the RPC put; same single "
                    "round-trip dialogue, no cross-message state",
    "_OP_PUT_BATCH": "batched framing over the RPC put dialogue; no "
                     "cross-message state",
    "_OP_GET": "single-shot RPC get; the durable model abstracts reads "
               "as replay-cursor pulls",
    "_OP_GET_BATCH": "batched framing over the RPC get dialogue",
    "_OP_GET_BATCH_WAIT": "blocking batched get; same dialogue with a "
                          "server-side wait, no cross-message state",
    "_OP_SIZE": "read-only introspection, no protocol state",
    "_OP_STATS": "read-only introspection, no protocol state",
    "_OP_CLOSE": "one-way close latch; its delivery consequence (EOS) "
                 "is the stream model's queue sentinel",
    "_OP_OPEN": "namespace handshake; stateless after the reply",
    "_OP_ANCHOR": "shared-memory anchor negotiation; data-plane "
                  "placement, no ordered-delivery state",
    "_OP_CODEC": "codec negotiation; single bounds-checked round-trip",
}


def extracted_op_surface(dialogue):
    """All opcode names the reconstruction knows about: the dispatch
    table plus mode legal sets (ops like _OP_STREAM_ACK/_OP_REPL_APPEND
    are handled inside their mode's read loop, not the table)."""

    ops = set(dialogue["ops"])
    for mode in dialogue["modes"].values():
        allowed = mode.get("server_allowed")
        if allowed:
            ops |= set(allowed)
    return ops


def check_drift(dialogue, models, full):
    """Yield (message, hint) drift findings.

    ``full`` switches on the model->code direction; pass True only when
    the scan includes the real transport (fixture scans would otherwise
    report every model op as a ghost).
    """

    surface = extracted_op_surface(dialogue)
    modeled = set()
    for m in models:
        modeled |= m.WIRE_OPS

    # -- code -> model ----------------------------------------------------
    for op in sorted(surface - modeled - set(NON_MODELED)):
        yield (
            "opcode %s is on the wire surface but no protocol model "
            "implements it and model.drift.NON_MODELED carries no "
            "justification — the model checker is blind to it" % op,
            "extend the closest model's op set (and its transitions) or "
            "add a NON_MODELED entry saying why it has no protocol state",
        )

    # -- NON_MODELED rot --------------------------------------------------
    for op in sorted(set(NON_MODELED) & modeled):
        yield (
            "NON_MODELED claims %s has no model, but a model declares it "
            "— stale justification" % op,
            "drop the NON_MODELED entry",
        )
    if full:
        for op in sorted(set(NON_MODELED) - surface):
            yield (
                "NON_MODELED lists %s but the reconstruction no longer "
                "finds that opcode — stale justification" % op,
                "drop the NON_MODELED entry",
            )

    if not full:
        return

    # -- model -> code ----------------------------------------------------
    emitted_by = {op: rec.get("emits", set())
                  for op, rec in dialogue["ops"].items()}
    for m in models:
        for op in sorted(m.WIRE_OPS - surface):
            yield (
                "model %r declares opcode %s but the reconstruction "
                "finds no such op on the wire — the model describes a "
                "protocol that no longer exists" % (m.name, op),
                "update the model's WIRE_OPS (and transitions) to match "
                "the dispatch table / mode legal sets",
            )
        table_ops = m.WIRE_OPS & set(emitted_by)
        emitted = set()
        for op in table_ops:
            emitted |= emitted_by[op]
        for st in sorted(m.WIRE_STATUSES - emitted):
            if not table_ops:
                break
            yield (
                "model %r declares reply status %s but none of its ops "
                "(%s) emit it in the reconstruction" % (
                    m.name, st, ", ".join(sorted(table_ops))),
                "update the model's WIRE_STATUSES to the statuses the "
                "handlers actually answer with",
            )
        if m.MODE:
            mode = dialogue["modes"].get(m.MODE)
            allowed = set(mode["server_allowed"] or ()) if mode else set()
            if mode is None or not mode.get("server_allowed"):
                yield (
                    "model %r rides connection mode %r but the "
                    "reconstruction finds no dispatch guard for it" % (
                        m.name, m.MODE),
                    "restore the mode's dispatch-guard gate in _on_op or "
                    "update the model's MODE",
                )
            elif allowed != set(m.MODE_LEGAL_OPS):
                yield (
                    "mode %r legal-op drift: model %r declares {%s} but "
                    "the server dispatch guard allows {%s}" % (
                        m.MODE, m.name,
                        ", ".join(sorted(m.MODE_LEGAL_OPS)),
                        ", ".join(sorted(allowed))),
                    "update the model's MODE_LEGAL_OPS and its "
                    "transitions to match the guard (or fix the guard)",
                )
