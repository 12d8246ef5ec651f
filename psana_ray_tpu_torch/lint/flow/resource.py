"""resource-flow: every acquire must reach a release on EVERY path.

The syntactic lease/segment checkers ask "does SOME release
exist in this function" — cheap, and they stay as the fast first pass.
The bug class they structurally cannot see is per-path: the
corrupt-head decode acquired a decompress lease, then a parse failure
raised BETWEEN the acquire and the hand-off, leaving the lease to the
GC backstop (pool churn returns; on the shm ring a slot looks wedged).
This checker walks the :mod:`cfg` exception edges to find exactly that:
a path from an acquire to the function's exceptional (or fall-through)
exit that never mentions the resource again.

Tracked acquires (assignment of a single name from):

- ``*.lease(n)`` / ``*.get_view()`` / ``*.get_batch_view(...)`` /
  ``_SlotLease(...)`` — pooled buffers and ring-slot leases;
- ``Segment.allocate/open_existing``, ``*._new_segment``,
  ``mmap.mmap`` — mapped segments;
- ``socket.create_connection`` / ``socket.socket`` — sockets.

A node RESOLVES the obligation when its statement mentions the name in
any owning position: ``x.release()/close()/materialize()/retire()/
reset()/shutdown()``, ``with x``, ``return <...x...>``, passing ``x``
(or ``x.attr``) to any call (hand-off — the callee's own body is
checked at ITS site; the syntactic checkers gate which callees count
as owners), or storing ``x`` anywhere (attribute, container, tuple —
object-lifetime hand-off). Deliberately broad: the finding this
checker exists for is the path where the resource is never mentioned
AGAIN, which is also why it composes with (not replaces) the
stricter-but-pathless syntactic pass.

Exception edges come from the CFG with the resolved call graph's
totality oracle plugged in, so a call to a provably total helper
between acquire and hand-off does not fabricate a leak path.

Opt-outs: ``# resource-flow: owner-transfers`` on the acquire line
(ownership moves somewhere the graph cannot see — must say where in
the allowlist instead), and the standard reviewed allowlist.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from psana_ray_tpu_torch.lint.core import Checker, Finding, register
from psana_ray_tpu_torch.lint.flow import cfg as cfgmod
from psana_ray_tpu_torch.lint.flow.callgraph import get_callgraph

LEASE_METHODS = {"lease", "get_view", "get_batch_view"}
LEASE_CTORS = {"_SlotLease"}
SEGMENT_ATTRS = {"open_existing", "_new_segment", "allocate"}
RELEASE_ATTRS = {
    "release", "close", "materialize", "retire", "reset", "shutdown",
}


def _acquire_kind(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute):
        if f.attr in LEASE_METHODS:
            return "lease"
        if f.attr in SEGMENT_ATTRS:
            return "segment"
        if isinstance(f.value, ast.Name):
            if f.value.id == "mmap" and f.attr == "mmap":
                return "segment"
            if f.value.id == "socket" and f.attr in ("create_connection", "socket"):
                return "socket"
    if isinstance(f, ast.Name) and f.id in LEASE_CTORS:
        return "lease"
    return None


def _mentions(node: ast.AST, name: str) -> bool:
    return any(
        isinstance(n, ast.Name) and n.id == name for n in ast.walk(node)
    )


def _is_bare(node, name: str) -> bool:
    if isinstance(node, ast.Starred):
        node = node.value
    return isinstance(node, ast.Name) and node.id == name


def _escapes_outside_calls(node: ast.AST, name: str) -> bool:
    """``name`` appears as a bare reference NOT inside a call's argument
    list — a tuple/list/attribute-store escape. ``cached = (c, p, x)``
    escapes; ``hdr = parse(x.mv)`` does not (deriving a value from a
    view transfers nothing)."""
    if isinstance(node, ast.Name):
        return node.id == name
    if isinstance(node, ast.Call):
        return False  # call-argument uses are judged by the hand-off rule
    if isinstance(node, ast.Attribute):
        return False  # x.attr derives a view; the obligation stays on x
    return any(
        _escapes_outside_calls(c, name) for c in ast.iter_child_nodes(node)
    )


def _is_liveness_test(test: ast.AST, name: str) -> bool:
    """``if x:`` / ``if x is not None:`` / ``if x is None:`` — a branch
    on the resource's OWN liveness. The skip branch of the release
    idiom (``if x is not None: x.release()``) runs exactly when ``x``
    was never acquired; the CFG cannot see that correlation, so the
    test itself is accepted as discharging the obligation. A guard on
    anything else (``if flag: x.release()``) stays a leak path."""
    if isinstance(test, ast.Name) and test.id == name:
        return True
    return (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.ops[0], (ast.Is, ast.IsNot))
        and isinstance(test.left, ast.Name)
        and test.left.id == name
        and isinstance(test.comparators[0], ast.Constant)
        and test.comparators[0].value is None
    )


def _stmt_resolves(stmt: ast.stmt, name: str) -> bool:
    """Does executing ``stmt`` discharge the obligation on ``name``?
    Only the statement's OWN expressions count (nested function bodies
    run later; their uses are invisible here by design — storing into a
    closure is not a hand-off). Ownership moves only with the BARE
    name: ``f(x)`` / ``f(lease=x)`` / ``coll.append(x)`` / ``y = (.., x)``
    hand off; ``f(x.mv)`` derives a view and keeps the obligation."""
    for root in cfgmod._header_exprs(stmt):
        for n in ast.walk(root):
            if (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in RELEASE_ATTRS
                and _mentions(n.func.value, name)
            ):
                return True
            if isinstance(n, ast.Call) and (
                any(_is_bare(a, name) for a in n.args)
                or any(
                    kw.value is not None and _is_bare(kw.value, name)
                    for kw in n.keywords
                )
            ):
                return True  # hand-off to a callee
    if isinstance(stmt, ast.If):
        return _is_liveness_test(stmt.test, name)
    if isinstance(stmt, ast.Return):
        return stmt.value is not None and _mentions(stmt.value, name)
    if isinstance(stmt, ast.Raise):
        return stmt.exc is not None and _mentions(stmt.exc, name)
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return any(_mentions(item.context_expr, name) for item in stmt.items)
    if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
        value = stmt.value
        if value is not None and _escapes_outside_calls(value, name):
            return True  # escapes into another binding / attribute / container
        targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
        for t in targets:
            if isinstance(t, ast.Name) and t.id == name:
                return True  # rebound: the old obligation is out of scope here
            if _mentions(t, name):
                return True  # x.attr = ... / container[x] = ...: still owned, alive
    if isinstance(stmt, ast.Delete):
        return any(_mentions(t, name) for t in stmt.targets)
    return False


def _acquire_stmts(func):
    """(stmt, name, kind, lineno) per tracked acquire — CFG-independent,
    so the (vast) acquire-free majority of functions never pays for a
    graph build."""
    out = []
    for stmt in cfgmod.statements_of(func):
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            continue
        target = stmt.targets[0]
        if not isinstance(target, ast.Name):
            continue
        kind = None
        for n in ast.walk(stmt.value):
            if isinstance(n, ast.Call):
                kind = _acquire_kind(n)
                if kind is not None:
                    break
        if kind is None:
            continue
        out.append((stmt, target.id, kind, stmt.lineno))
    return out


def _leak_path(
    graph: cfgmod.CFG, start: int, name: str
) -> Optional[Tuple[str, int]]:
    """BFS from the acquire node: a path that reaches EXIT/RAISE without
    a resolving statement is a leak. Returns (path kind, witness line)
    — the line of the last real statement before the leaking exit —
    preferring an exceptional leak (the class this checker exists for).
    """
    seen: Set[int] = set()
    # frontier entries: (node id, last real stmt line)
    frontier: List[Tuple[int, int]] = []
    for succ, kind in graph.successors(start):
        if kind == cfgmod.EXCEPTION:
            continue  # the acquire call itself failing acquires nothing
        frontier.append((succ, graph.nodes[start].lineno))
    leaks: List[Tuple[str, int]] = []
    while frontier:
        nid, line = frontier.pop()
        if nid in seen:
            continue
        seen.add(nid)
        node = graph.nodes[nid]
        if node.kind == "raise":
            leaks.append(("exception", line))
            continue
        if node.kind == "exit":
            leaks.append(("fall-through", line))
            continue
        if node.stmt is not None and _stmt_resolves(node.stmt, name):
            continue
        here = node.lineno or line
        for succ, _kind in graph.successors(nid):
            frontier.append((succ, here))
    for leak in leaks:
        if leak[0] == "exception":
            return leak
    return leaks[0] if leaks else None


OPT_OUT = "# resource-flow: owner-transfers"


@register
class ResourceFlowChecker(Checker):
    name = "resource-flow"
    description = (
        "CFG + exception-edge tracking: an acquired lease/segment/socket "
        "must be released, handed off, or returned on EVERY path — "
        "including the raise between acquire and hand-off the syntactic "
        "lifecycle checkers cannot see"
    )

    def run(self, index):
        graph = get_callgraph(index)
        for fi in index.files:
            for func in cfgmod.functions_in(fi.tree):
                acquires = _acquire_stmts(func)
                if not acquires:
                    continue
                info = graph.func_for_node(func)

                def oracle(call, _fi=fi, _info=info):
                    return graph.call_may_raise(_fi, call, _info)

                flow = cfgmod.build_cfg(func, call_oracle=oracle)
                reported: Set[Tuple[str, int]] = set()
                for stmt, name, kind, lineno in acquires:
                    if (name, lineno) in reported:
                        continue
                    if OPT_OUT in fi.line(lineno):
                        continue
                    leak = None
                    for nid in flow.nodes_for(stmt):
                        leak = _leak_path(flow, nid, name)
                        if leak is not None:
                            break
                    if leak is None:
                        continue
                    reported.add((name, lineno))
                    pkind, witness = leak
                    where = (
                        f"a statement near line {witness} can raise"
                        if pkind == "exception"
                        else f"control falls out of {func.name} near line {witness}"
                    )
                    yield Finding(
                        checker=self.name, path=fi.rel, line=lineno,
                        message=(
                            f"{kind} {name!r} acquired in {func.name} can "
                            f"leak on a {pkind} path: {where} with no "
                            f"release/hand-off for {name!r} between the "
                            f"acquire and that exit"
                        ),
                        hint=(
                            "release in a try/finally (or except+raise) "
                            "covering the window, hand the resource off "
                            "before the first raising call, or mark the "
                            f"acquire line `{OPT_OUT}` and allowlist it "
                            "with a written justification"
                        ),
                    )
