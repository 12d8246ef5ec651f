"""BFS explorer for the bounded protocol models.

A :class:`Model` is a deterministic transition system over hashable
states (plain tuples).  The explorer walks it breadth-first, so the
first invariant violation it reports is a *shortest* counterexample —
the "minimized trace" the CLI prints is minimal by construction, no
post-hoc shrinking pass needed.

Bounds are explicit and enforced three ways:

- the model's own configuration (frames, crash budget, window size)
  makes the reachable state space finite,
- ``max_states`` / ``max_depth`` caps stop a runaway model and mark the
  run ``truncated`` instead of hanging the lint budget,
- ``budget_s`` is a wall-clock cap checked between expansions.

A run that exhausts the state space with no violation sets
``exhausted=True`` — that is the claim ``--model`` prints: "all interleavings
of this bounded configuration, zero counterexamples".
"""

from __future__ import annotations

import time
from collections import deque

# Hard backstops; individual models stay far below these.  A model that
# trips them is a bug in the model, and the result says so (truncated).
DEFAULT_MAX_STATES = 2_000_000
DEFAULT_MAX_DEPTH = 10_000
DEFAULT_BUDGET_S = 60.0


class Model:
    """Base class for protocol models.

    Subclasses declare the slice of the wire surface they implement
    (``WIRE_OPS`` / ``WIRE_STATUSES``, as ``_OP_*`` / ``_ST_*`` constant
    names from transport/tcp.py) and, optionally, the connection mode
    they ride on (``MODE`` + ``MODE_LEGAL_OPS``) so the drift gate can
    hold them against the extracted dialogue.

    The transition relation is ``actions(state, cfg)``: yield
    ``(label, next_state)`` pairs for every enabled action.  Labels are
    human-readable opcode-timeline entries ("client W seq=2",
    "crash! wipe wires, resend tail") — they become the counterexample
    trace verbatim.
    """

    name = ""
    title = ""
    #: _OP_* constant names this model implements.
    WIRE_OPS = frozenset()
    #: _ST_* constant names this model's dialogue can answer with.
    WIRE_STATUSES = frozenset()
    #: Connection-mode attribute (e.g. "_stream") if this model's ops are
    #: mode-gated server-side, else None.
    MODE = None
    #: Exact server-side legal op set for MODE, as _OP_* names.
    MODE_LEGAL_OPS = frozenset()

    def config(self, profile):
        """Bounded configuration dict for ``profile`` ("full"/"quick")."""

        raise NotImplementedError

    def init_state(self, cfg):
        raise NotImplementedError

    def actions(self, state, cfg):
        raise NotImplementedError

    def violations(self, state, cfg):
        """Names of invariants ``state`` violates (empty when healthy)."""

        raise NotImplementedError


class ExploreResult:
    """Outcome of one bounded exploration."""

    __slots__ = (
        "model",
        "states",
        "transitions",
        "max_depth",
        "duration_s",
        "exhausted",
        "truncated_by",
        "violation",
        "trace",
    )

    def __init__(self, model, states, transitions, max_depth, duration_s,
                 exhausted, truncated_by, violation, trace):
        self.model = model
        self.states = states
        self.transitions = transitions
        self.max_depth = max_depth
        self.duration_s = duration_s
        self.exhausted = exhausted
        self.truncated_by = truncated_by
        self.violation = violation
        self.trace = trace

    @property
    def ok(self):
        return self.violation is None

    def as_dict(self):
        return {
            "model": self.model.name,
            "states": self.states,
            "transitions": self.transitions,
            "max_depth": self.max_depth,
            "duration_s": round(self.duration_s, 4),
            "exhausted": self.exhausted,
            "truncated_by": self.truncated_by,
            "violation": self.violation,
            "trace": list(self.trace) if self.trace else None,
        }


def explore(model, profile="full", max_states=None, max_depth=None,
            budget_s=None):
    """Breadth-first exploration of ``model`` under ``profile``.

    Returns an :class:`ExploreResult`.  The predecessor map doubles as
    the visited set; on a violation the trace is rebuilt by walking the
    map back to the initial state, giving a shortest path.
    """

    max_states = DEFAULT_MAX_STATES if max_states is None else max_states
    max_depth = DEFAULT_MAX_DEPTH if max_depth is None else max_depth
    budget_s = DEFAULT_BUDGET_S if budget_s is None else budget_s

    cfg = model.config(profile)
    t0 = time.monotonic()
    init = model.init_state(cfg)
    # state -> (prev_state, action_label); the root maps to None.
    pred = {init: None}
    frontier = deque([(init, 0)])
    transitions = 0
    deepest = 0
    truncated_by = None

    bad = model.violations(init, cfg)
    if bad:
        return ExploreResult(model, 1, 0, 0, time.monotonic() - t0,
                             False, None, bad[0], ())

    while frontier:
        if time.monotonic() - t0 > budget_s:
            truncated_by = "budget_s"
            break
        state, depth = frontier.popleft()
        if depth >= max_depth:
            truncated_by = "max_depth"
            continue
        for label, nxt in model.actions(state, cfg):
            transitions += 1
            if nxt in pred:
                continue
            pred[nxt] = (state, label)
            bad = model.violations(nxt, cfg)
            if bad:
                trace = _rebuild_trace(pred, nxt)
                return ExploreResult(model, len(pred), transitions,
                                     max(deepest, depth + 1),
                                     time.monotonic() - t0,
                                     False, None, bad[0], trace)
            deepest = max(deepest, depth + 1)
            if len(pred) >= max_states:
                truncated_by = "max_states"
                frontier.clear()
                break
            frontier.append((nxt, depth + 1))

    return ExploreResult(model, len(pred), transitions, deepest,
                         time.monotonic() - t0, truncated_by is None,
                         truncated_by, None, ())


def _rebuild_trace(pred, state):
    steps = []
    cur = state
    while pred[cur] is not None:
        prev, label = pred[cur]
        steps.append(label)
        cur = prev
    steps.reverse()
    return tuple(steps)


def render_trace(result):
    """Render a counterexample as an opcode timeline, one step per line."""

    if result.violation is None:
        return ""
    lines = [
        "counterexample: model=%s invariant=%s (%d steps)" % (
            result.model.name, result.violation, len(result.trace)),
    ]
    for i, label in enumerate(result.trace, 1):
        lines.append("  %2d. %s" % (i, label))
    lines.append("  -> violates: %s" % result.violation)
    return "\n".join(lines)


def render_report(results):
    """Human-readable report for a fleet of ExploreResults."""

    lines = []
    worst = 0
    for r in results:
        status = "ok, exhausted" if r.ok and r.exhausted else (
            "ok, TRUNCATED by %s" % r.truncated_by if r.ok else "VIOLATION")
        lines.append(
            "model %-12s %-22s states=%-7d transitions=%-8d depth=%-4d %.3fs"
            % (r.model.name, status, r.states, r.transitions, r.max_depth,
               r.duration_s))
        if not r.ok:
            worst = max(worst, 2)
            lines.append(render_trace(r))
        elif not r.exhausted:
            worst = max(worst, 1)
    return "\n".join(lines), worst
