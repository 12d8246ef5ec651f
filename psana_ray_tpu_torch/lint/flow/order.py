"""``lock-order``: static lock-acquisition-order graph over the call graph.

Builds a directed graph whose nodes are lock *identities* (``self._mu``
in class C, a module-level lock, a ``Condition`` canonicalized to the
lock it wraps) and whose edges mean "acquired while holding":

- a nested ``with`` scope (``with self._a:`` containing ``with
  self._b:``, or ``with self._a, self._b:``) adds a -> b;
- a call made while holding a lock adds an edge to every lock the
  callee may transitively acquire (the call-graph closure — this is the
  SIGUSR2-dump class: the dump path held the registry lock
  and called into per-connection dumps that take the connection lock,
  while the connection path nests the other way);
- a ``# lock-order: A -> B`` comment is a checked assertion: it adds
  the declared edge, and any observed B-before-A nesting is a finding
  even before it closes a cycle.

A cycle in the graph is a deadlock finding (two threads can take the
participating locks in opposite orders).  Consistently-ordered nesting
passes silently; an annotation naming a lock that no longer exists is
rot and flagged, like stale allowlist entries.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from typing import Dict, List, Optional, Set, Tuple

from ..core import Checker, Finding, register
from ..checkers.locks import _self_attr
from .callgraph import get_callgraph

ORDER_RE = re.compile(r"#\s*lock-order:\s*([A-Za-z_][\w.]*)\s*->\s*([A-Za-z_][\w.]*)")

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}

# A lock identity: ("cls", ClassName, attr) or ("mod", file_rel, name).
LockId = Tuple[str, str, str]


def _display(lock: LockId) -> str:
    kind, owner, name = lock
    if kind == "cls":
        return f"{owner}.{name}"
    return f"{owner}:{name}"


def _lock_ctor_name(value) -> Optional[str]:
    """'Lock'/'RLock'/... when ``value`` constructs one, else None."""
    if not isinstance(value, ast.Call):
        return None
    f = value.func
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None)
    return name if name in _LOCK_CTORS else None


class _Locks:
    """Discovered lock identities for one ProjectIndex."""

    def __init__(self, index):
        self.kinds: Dict[LockId, str] = {}  # id -> ctor name
        self.aliases: Dict[LockId, LockId] = {}  # Condition(lock) -> lock
        self.by_attr: Dict[str, List[LockId]] = {}
        for fi in index.files:
            for node in ast.walk(fi.tree):
                if isinstance(node, ast.ClassDef):
                    self._collect_class(fi, node)
            for stmt in fi.tree.body:
                if isinstance(stmt, ast.Assign):
                    ctor = _lock_ctor_name(stmt.value)
                    if ctor:
                        for t in stmt.targets:
                            if isinstance(t, ast.Name):
                                self._add(("mod", fi.rel, t.id), ctor)

    def _collect_class(self, fi, cls):
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign):
                targets, value = [node.target], node.value
            else:
                continue
            ctor = _lock_ctor_name(value)
            if not ctor:
                continue
            for t in targets:
                a = _self_attr(t)
                if a is None and isinstance(t, ast.Name) \
                        and fi.parents.get(node) is cls:
                    a = t.id
                if a is None:
                    continue
                lock = ("cls", cls.name, a)
                self._add(lock, ctor)
                # Condition(self._mu): holding the condition IS holding
                # the wrapped lock — one node, not a false edge.
                if ctor == "Condition" and value.args:
                    src = _self_attr(value.args[0])
                    if src is not None:
                        self.aliases[lock] = ("cls", cls.name, src)

    def _add(self, lock: LockId, ctor: str):
        self.kinds[lock] = ctor
        self.by_attr.setdefault(lock[2], []).append(lock)

    def canon(self, lock: LockId) -> LockId:
        seen = set()
        while lock in self.aliases and lock not in seen:
            seen.add(lock)
            lock = self.aliases[lock]
        return lock

    def resolve_expr(self, fi, expr, cls_name: Optional[str]) -> Optional[LockId]:
        """The lock identity a with-item / acquire target denotes."""
        a = _self_attr(expr)
        if a is not None:
            if cls_name is not None and ("cls", cls_name, a) in self.kinds:
                return self.canon(("cls", cls_name, a))
            return self._unique_attr(a)
        if isinstance(expr, ast.Attribute):
            # other._lock / self.registry._lock: cross-object acquire;
            # attr-unique match only (a shared attr name across classes
            # is ambiguous and must not invent edges)
            return self._unique_attr(expr.attr)
        if isinstance(expr, ast.Name):
            lock = ("mod", fi.rel, expr.id)
            if lock in self.kinds:
                return self.canon(lock)
        return None

    def _unique_attr(self, attr: str) -> Optional[LockId]:
        cands = {self.canon(l) for l in self.by_attr.get(attr, ())}
        if len(cands) == 1:
            return next(iter(cands))
        return None

    def resolve_name(self, label: str) -> Optional[LockId]:
        """A '# lock-order:' operand: 'Class.attr', 'attr' (unique) or a
        module-level lock name (unique)."""
        if "." in label:
            cls_name, attr = label.rsplit(".", 1)
            lock = ("cls", cls_name, attr)
            return self.canon(lock) if lock in self.kinds else None
        got = self._unique_attr(label)
        if got is not None:
            return got
        mods = {self.canon(l) for l in self.kinds
                if l[0] == "mod" and l[2] == label}
        if len(mods) == 1:
            return next(iter(mods))
        return None


def _annotations(fi):
    """(line, left, right) for every ``# lock-order:`` COMMENT in the
    file — tokenize keeps the regex out of string literals (this module
    quotes the syntax in its own docstrings)."""
    try:
        for tok in tokenize.generate_tokens(io.StringIO(fi.source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = ORDER_RE.search(tok.string)
            if m:
                yield tok.start[0], m.group(1), m.group(2)
    except (tokenize.TokenError, IndentationError):
        return


def _acquire_expr(call: ast.Call):
    """The lock expression of ``<expr>.acquire()``, else None."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "acquire":
        return f.value
    return None


class _OrderGraph:
    def __init__(self):
        # (a, b) -> first observed site (rel, line, how)
        self.edges: Dict[Tuple[LockId, LockId], Tuple[str, int, str]] = {}

    def add(self, a: LockId, b: LockId, rel: str, line: int, how: str):
        if a == b:
            return  # reentrancy is the lock-discipline checker's beat
        self.edges.setdefault((a, b), (rel, line, how))

    def succ(self) -> Dict[LockId, Set[LockId]]:
        out: Dict[LockId, Set[LockId]] = {}
        for a, b in self.edges:
            out.setdefault(a, set()).add(b)
            out.setdefault(b, set())
        return out

    def cycles(self) -> List[List[LockId]]:
        """One representative cycle per non-trivial SCC (iterative
        Tarjan, then a shortest closed walk inside the component)."""
        succ = self.succ()
        idx: Dict[LockId, int] = {}
        low: Dict[LockId, int] = {}
        on: Set[LockId] = set()
        stack: List[LockId] = []
        sccs: List[List[LockId]] = []
        counter = [0]
        for root in sorted(succ):
            if root in idx:
                continue
            work = [(root, iter(sorted(succ[root])))]
            idx[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on.add(root)
            while work:
                node, it = work[-1]
                advanced = False
                for nxt in it:
                    if nxt not in idx:
                        idx[nxt] = low[nxt] = counter[0]
                        counter[0] += 1
                        stack.append(nxt)
                        on.add(nxt)
                        work.append((nxt, iter(sorted(succ[nxt]))))
                        advanced = True
                        break
                    if nxt in on:
                        low[node] = min(low[node], idx[nxt])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == idx[node]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    if len(comp) > 1:
                        sccs.append(comp)
        out = []
        for comp in sccs:
            members = set(comp)
            start = sorted(comp)[0]
            # BFS for the shortest walk start -> ... -> start inside the SCC
            parent: Dict[LockId, LockId] = {}
            frontier = [start]
            found = None
            while frontier and found is None:
                nxt_frontier = []
                for n in frontier:
                    for m in sorted(succ.get(n, ())):
                        if m == start:
                            found = n
                            break
                        if m in members and m not in parent:
                            parent[m] = n
                            nxt_frontier.append(m)
                    if found is not None:
                        break
                frontier = nxt_frontier
            path = [start]
            if found is not None and found != start:
                chain = [found]
                while chain[-1] != start:
                    chain.append(parent[chain[-1]])
                path = list(reversed(chain))
            out.append(path)
        return out


@register
class LockOrderChecker(Checker):
    name = "lock-order"
    description = (
        "static lock-acquisition-order graph over the call graph: nested "
        "with/acquire scopes and calls-while-holding form edges, "
        "'# lock-order: A -> B' comments are checked assertions, cycles "
        "are deadlock findings"
    )

    def run(self, index):
        locks = _Locks(index)
        if not locks.kinds:
            return
        graph = get_callgraph(index)
        order = _OrderGraph()

        # -- per-function direct acquires + nesting edges ------------------
        direct: Dict[Tuple[str, str], Set[LockId]] = {}
        # calls made while holding: (caller_key, callee_key, held, site)
        held_calls = []
        for key, info in graph.functions.items():
            cls_name = info.cls.name if info.cls is not None else None
            fi = info.fi
            acquired: Set[LockId] = set()

            def walk(node, held: Tuple[LockId, ...], own: bool):
                # ``own``: node belongs to this def, not a nested one
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.Lambda)):
                        continue  # nested defs analyzed as their own funcs
                    new_held = held
                    if isinstance(child, (ast.With, ast.AsyncWith)):
                        for item in child.items:
                            lock = locks.resolve_expr(
                                fi, item.context_expr, cls_name)
                            if lock is None:
                                continue
                            acquired.add(lock)
                            for h in new_held:
                                order.add(h, lock, fi.rel,
                                          item.context_expr.lineno,
                                          "nested with")
                            new_held = new_held + (lock,)
                    elif isinstance(child, ast.Call):
                        tgt = _acquire_expr(child)
                        if tgt is not None:
                            lock = locks.resolve_expr(fi, tgt, cls_name)
                            if lock is not None:
                                acquired.add(lock)
                                for h in new_held:
                                    order.add(h, lock, fi.rel,
                                              child.lineno, "acquire()")
                        elif new_held:
                            callee = graph.resolve(fi, child.func, info)
                            if callee is not None:
                                held_calls.append(
                                    (callee.key, new_held,
                                     (fi.rel, child.lineno,
                                      callee.qualname)))
                    walk(child, new_held, own)

            walk(info.node, (), True)
            direct[key] = acquired

        # -- may-acquire closure over the call graph -----------------------
        may: Dict[Tuple[str, str], Set[LockId]] = {
            k: set(v) for k, v in direct.items()}
        changed = True
        while changed:
            changed = False
            for key, info in graph.functions.items():
                cur = may[key]
                before = len(cur)
                for callee in graph.callees(info):
                    cur |= may.get(callee.key, set())
                if len(cur) != before:
                    changed = True

        for callee_key, held, (rel, line, qualname) in held_calls:
            for lock in may.get(callee_key, ()):
                for h in held:
                    order.add(h, lock, rel, line,
                              "call to %s may acquire" % qualname)

        # -- '# lock-order:' annotations -----------------------------------
        declared: Dict[Tuple[LockId, LockId], Tuple[str, int]] = {}
        for fi in index.files:
            for i, left, right in _annotations(fi):
                a, b = locks.resolve_name(left), locks.resolve_name(right)
                for label, got in ((left, a), (right, b)):
                    if got is None:
                        yield Finding(
                            checker=self.name, path=fi.rel, line=i,
                            message=(
                                "lock-order annotation names %r but no "
                                "such lock exists in the scanned tree — "
                                "stale assertion" % label),
                            hint=(
                                "use ClassName.attr (or a unique attr / "
                                "module-level name) of a real "
                                "threading.Lock/RLock/Condition"),
                        )
                if a is None or b is None or a == b:
                    continue
                declared[(a, b)] = (fi.rel, i)

        for (a, b), (rel, line) in sorted(declared.items()):
            site = order.edges.get((b, a))
            if site is not None:
                yield Finding(
                    checker=self.name, path=site[0], line=site[1],
                    message=(
                        "acquires %s while holding %s (%s), contradicting "
                        "'# lock-order: %s -> %s' declared at %s:%d" % (
                            _display(a), _display(b), site[2],
                            _display(a), _display(b), rel, line)),
                    hint="take the locks in the declared order, or fix "
                         "the annotation if the order really changed",
                )
            order.add(a, b, rel, line, "declared")

        # -- cycles ----------------------------------------------------------
        for cycle in order.cycles():
            hops = []
            first_site = None
            for i, a in enumerate(cycle):
                b = cycle[(i + 1) % len(cycle)]
                site = order.edges.get((a, b))
                if site is None:
                    continue
                if first_site is None:
                    first_site = site
                hops.append("%s -> %s (%s:%d, %s)" % (
                    _display(a), _display(b), site[0], site[1], site[2]))
            rel, line = (first_site[0], first_site[1]) if first_site \
                else ("", 0)
            yield Finding(
                checker=self.name, path=rel, line=line,
                message=(
                    "lock-order cycle: %s — two threads taking these "
                    "locks in opposite orders deadlock" % "; ".join(hops)),
                hint=(
                    "pick one global order for these locks (document it "
                    "with '# lock-order: A -> B'), or drop one side to a "
                    "snapshot-then-act pattern so the nesting disappears"),
            )
