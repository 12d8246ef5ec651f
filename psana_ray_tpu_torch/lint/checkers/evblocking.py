"""event-loop-blocking: nothing reachable from the event-loop dispatch
may block.

The event-loop queue server (``transport/evloop.py``) serves
EVERY connection from one thread: a single blocking call anywhere under
``EventLoop.run`` stalls every consumer and producer at once — strictly
worse than the threaded server it replaced, where a stall cost one
connection. The stall detector would catch this probabilistically at
runtime; this checker catches the idioms statically, extending the
blocking-hot-path call-graph machinery (same function table, same
name-based BFS) to root at the loop dispatch instead of the consumer
drain loop.

Banned inside the reachable set — a superset of the drain-loop bans,
because the loop cannot even afford a *bounded* sleep:

- ``time.sleep`` in any form (a bounded pause still freezes every
  connection for its duration);
- the module's own BLOCKING I/O helpers by name (``_sendmsg_all``,
  ``_recv_exact``, ``_recv_into``, ``_recv_payload``) and blocking
  ``.sendall(`` — loop code must use the non-blocking write queue and
  incremental ``recv_into`` state machine instead;
- bare ``.acquire()`` (lock wait with no timeout; ``with lock:``
  micro-sections are NOT flagged), ``.join()`` without a timeout, and
  unbounded ``Condition.wait()`` — the idioms the threaded server used
  to park serve threads, which the loop must hold as timer/deferred
  state.

Scope cuts mirror blocking-hot-path: ``TcpQueueClient.*`` and
``TcpStreamReader.*`` are excluded (client-side code the loop never
runs; their ``put``/``get`` method NAMES would otherwise alias into the
graph through ``queue.put(...)`` edges and drag the reconnect backoff's
deliberate sleeps in). Deliberate bounded polls reached through queue
backings (the shm ring's deadline-checked micro-sleeps, dead when the
loop passes ``timeout=0.0``) carry allowlist entries naming the bound.
"""

from __future__ import annotations

import ast
from typing import Dict, List

from psana_ray_tpu_torch.lint.core import Checker, Finding, register
from psana_ray_tpu_torch.lint.checkers.blocking import (
    _banned_calls,
    _callees,
    _function_table,
    _sleep_names,
    EDGE_STOP,
)

ROOTS = {
    "EventLoop.run",
    # the kernel pass-through pump runs inside the
    # loop's flush path (os.sendfile must return short / raise
    # BlockingIOError, never park the loop), and the worker fleet's
    # reap-and-respawn loop must stay deadline-bounded so SIGTERM always
    # lands within a wait slice — both audited from their own roots so
    # a refactor that detaches them from EventLoop.run keeps coverage
    "_EvConn._pump_span",
    "WorkerSupervisor._supervise",
}

EXCLUDE_PREFIXES = ("TcpQueueClient.", "TcpStreamReader.")

# container/socket primitive attr names that must not create edges:
# `srv._conns.append(sock)` would otherwise alias into any project
# method NAMED append (e.g. CxiWriter.append) and drag unrelated code
# into the loop graph. Queue verbs (put/get/get_batch/...) deliberately
# stay edges — those aliases are the real loop->backing calls.
EDGE_STOP_EV = EDGE_STOP | {
    "append", "appendleft", "extend", "add", "discard", "remove",
    "clear", "pop", "popleft", "update", "send", "flush",
}

# blocking helpers and primitives banned AT THE CALL SITE in loop-
# reachable code, beyond what _banned_calls (sleep/acquire/join/recv)
# already flags
_BLOCKING_CALL_NAMES = {
    "_sendmsg_all": "blocking scatter-gather send helper",
    "_recv_exact": "blocking exact-read helper",
    "_recv_into": "blocking fill-exactly helper",
    "_recv_payload": "blocking payload-receive helper",
}
_BLOCKING_ATTRS = {
    "sendall": "blocking .sendall() — use the non-blocking write queue",
}


def _loop_banned(node: ast.AST) -> List[tuple]:
    """Call sites of the loop-specific blocking helpers."""
    out = []
    for n in ast.walk(node):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        if isinstance(f, ast.Name) and f.id in _BLOCKING_CALL_NAMES:
            out.append((n.lineno, f"{_BLOCKING_CALL_NAMES[f.id]} ({f.id})"))
        elif isinstance(f, ast.Attribute):
            if f.attr in _BLOCKING_ATTRS:
                out.append((n.lineno, _BLOCKING_ATTRS[f.attr]))
            elif f.attr == "wait" and not (
                n.args or any(kw.arg == "timeout" for kw in n.keywords)
            ):
                out.append(
                    (n.lineno, "unbounded .wait() — Condition wait with no timeout")
                )
    return out


@register
class EventLoopBlockingChecker(Checker):
    name = "event-loop-blocking"
    description = (
        "no time.sleep / blocking send-recv helpers / bare acquire / "
        "unbounded join or Condition.wait reachable from the event-loop "
        "dispatch (EventLoop.run)"
    )

    def run(self, index):
        table = _function_table(index)
        # roots-rot guard (same rationale as blocking-hot-path): on a
        # real-tree scan a vanished root means the checker silently
        # covers nothing — surface that instead
        if len(index.files) > 10:
            for root in sorted(ROOTS - set(table)):
                fi = index.find("lint/checkers/evblocking.py")
                yield Finding(
                    checker=self.name,
                    path=fi.rel if fi else "psana_ray_tpu_torch/lint/checkers/evblocking.py",
                    line=0,
                    message=f"event-loop root {root!r} resolves to no "
                    f"function in the scanned tree — the checker is "
                    f"silently covering less than it claims",
                    hint="the loop entry point was renamed or removed: "
                    "update ROOTS in this module to match",
                )
        by_bare: Dict[str, List[str]] = {}
        for qual in table:
            by_bare.setdefault(qual.rsplit(".", 1)[-1], []).append(qual)

        via: Dict[str, str] = {}
        frontier = [q for q in table if q in ROOTS]
        for q in frontier:
            via[q] = q
        while frontier:
            nxt = []
            for qual in frontier:
                fi, node = table[qual]
                names = _callees(node) - EDGE_STOP_EV
                for bare in names:
                    for callee in by_bare.get(bare, ()):
                        if callee in via or callee.startswith(EXCLUDE_PREFIXES):
                            continue
                        via[callee] = f"{via[qual]} -> {callee}"
                        nxt.append(callee)
            frontier = nxt

        for qual, path in sorted(via.items()):
            fi, node = table[qual]
            time_aliases, bare_sleeps = _sleep_names(fi)
            hits = _banned_calls(node, time_aliases, bare_sleeps)
            hits.extend(_loop_banned(node))
            for lineno, what in sorted(hits):
                yield Finding(
                    checker=self.name, path=fi.rel, line=lineno,
                    message=f"{what} inside {qual} — blocks the ENTIRE "
                    f"event loop (reachable: {path})",
                    hint="make it deferred state: park the connection as "
                    "a queue waiter / timer-heap entry, use the "
                    "non-blocking write queue and incremental recv_into "
                    "reads; a provably-dead branch (e.g. a poll sleep "
                    "behind timeout=0.0) needs an allowlist entry naming "
                    "the bound",
                )
