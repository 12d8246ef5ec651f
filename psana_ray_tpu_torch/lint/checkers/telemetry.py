"""telemetry-discipline: obs sources snapshot consistently and cheaply.

The observability plane makes every ``snapshot()``/``stats()`` dict a
FEDERATED series: the history sampler flattens it once per second in
every process, the collector pulls it across hosts, and the autotune
controller acts on it. Two invariants keep that safe:

1. **Consistent snapshots** — in a lock-owning source class (one that
   builds a ``threading.Lock``/``RLock``/``Condition`` and exposes
   ``snapshot``/``stats``), every MUTABLE instance attribute the
   snapshot method reads must be read under one of the class's locks or
   carry a ``# guarded-by:`` annotation (then the ``lock-discipline``
   checker owns the proof). A bare read is a torn scrape: the
   scrape-vs-teardown class, now multiplied by a 1 Hz sampler in every
   process. Attributes assigned ONLY in ``__init__`` are set-once
   configuration and exempt (the lockset checker's init-phase rule).
   ``# guarded-by-caller: <lock>`` on the method waives it, as usual.

2. **Zero-alloc sample path** — a function marked with the exact
   comment ``# lint: sample-path`` (the time-series ring's append) must
   stay counter arithmetic: no list/dict/set/tuple displays or
   comprehensions, no f-strings, no calls to the allocating builtins.
   The ring append runs once per key per sweep in EVERY process
   forever; an allocation there is a per-sample GC tax the
   zero-alloc-on-sample contract (obs/timeseries.py) explicitly
   promises away. (The wire-idiom screen stays with ``hot-alloc``;
   this rule is about general allocation in a marked sampler.)
"""

from __future__ import annotations

import ast
from typing import Dict, Set

from psana_ray_tpu_torch.lint.checkers.locks import (
    CALLER_RE,
    GUARDED_RE,
    _collect_class,
    _held_locks,
    _self_attr,
)
from psana_ray_tpu_torch.lint.core import Checker, Finding, register

SNAPSHOT_METHODS = ("snapshot", "stats")

SAMPLE_MARKER = "# lint: sample-path"

_LOCK_CTORS = {"Lock", "RLock", "Condition"}

_ALLOC_BUILTINS = {
    "list", "dict", "set", "tuple", "frozenset", "bytearray", "bytes",
    "str", "sorted", "format",
}


def _class_locks(cls: ast.ClassDef) -> Set[str]:
    """Attrs assigned a ``threading.Lock()/RLock()/Condition()`` call
    anywhere in the class (usually ``__init__``)."""
    locks: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        if not (
            isinstance(value, ast.Call)
            and isinstance(value.func, (ast.Attribute, ast.Name))
        ):
            continue
        ctor = (
            value.func.attr
            if isinstance(value.func, ast.Attribute)
            else value.func.id
        )
        if ctor not in _LOCK_CTORS:
            continue
        for t in node.targets:
            a = _self_attr(t)
            if a is not None:
                locks.add(a)
    return locks


def _assigned_attrs(cls: ast.ClassDef) -> Dict[str, Set[str]]:
    """attr -> set of method names that ASSIGN it (``self.X = ...``,
    augmented or annotated assignments included)."""
    out: Dict[str, Set[str]] = {}
    for method in cls.body:
        if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(method):
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets = [node.target]
            else:
                continue
            for t in targets:
                for el in (t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]):
                    a = _self_attr(el)
                    if a is not None:
                        out.setdefault(a, set()).add(method.name)
    return out


def _is_nested(fi, node, method) -> bool:
    for anc in fi.ancestors(node):
        if anc is method:
            return False
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return True
    return False


@register
class TelemetryDisciplineChecker(Checker):
    name = "telemetry-discipline"
    description = (
        "obs-source snapshot()/stats() must read mutable state under a "
        "class lock (or `# guarded-by` it); `# lint: sample-path` "
        "functions must not allocate"
    )

    def run(self, index):
        for fi in index.files:
            for cls in [n for n in ast.walk(fi.tree) if isinstance(n, ast.ClassDef)]:
                yield from self._check_snapshots(fi, cls)
            yield from self._check_sample_paths(fi)

    # -- rule 1: consistent snapshots ----------------------------------
    def _check_snapshots(self, fi, cls: ast.ClassDef):
        method_names = {
            m.name
            for m in cls.body
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        if not method_names.intersection(SNAPSHOT_METHODS):
            return
        locks = _class_locks(cls)
        if not locks:
            return  # documented lock-free sources are their own contract
        guarded, aliases, _ = _collect_class(fi, cls)
        assigned = _assigned_attrs(cls)
        class_consts = {
            t.id
            for stmt in cls.body
            if isinstance(stmt, (ast.Assign, ast.AnnAssign))
            for t in (stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target])
            if isinstance(t, ast.Name)
        }
        lock_names = locks | {a for a, src in aliases.items() if src in locks}
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if method.name not in SNAPSHOT_METHODS:
                continue
            # an obs-source snapshot/stats takes ONLY self: a stats(...)
            # with parameters is a probe/RPC surface (TcpQueueClient.
            # stats(deadline)), not a registry source
            args = method.args
            if (
                len(args.args) != 1
                or args.vararg or args.kwarg
                or args.kwonlyargs or args.posonlyargs
            ):
                continue
            end = getattr(method, "end_lineno", method.lineno) or method.lineno
            waived = any(
                CALLER_RE.search(fi.line(ln))
                for ln in range(method.lineno, end + 1)
            )
            if waived:
                continue
            for node in ast.walk(method):
                attr = _self_attr(node)
                if attr is None or not isinstance(node.ctx, ast.Load):
                    continue
                if attr in method_names or attr in lock_names:
                    continue
                if attr in class_consts:
                    continue
                if attr in guarded:
                    continue  # lock-discipline owns annotated attrs
                writers = assigned.get(attr)
                if not writers or writers == {"__init__"}:
                    continue  # set-once config / not this class's state
                if _is_nested(fi, node, method):
                    continue
                held = _held_locks(fi, node, method, aliases)
                if held & locks:
                    continue
                yield Finding(
                    checker=self.name, path=fi.rel, line=node.lineno,
                    message=(
                        f"obs source {cls.name}.{method.name} reads mutable "
                        f"self.{attr} (written by "
                        f"{', '.join(sorted(writers - {'__init__'}))}) outside "
                        f"any class lock — a 1 Hz federated sampler scrapes "
                        f"this; torn reads become recorded history"
                    ),
                    hint=(
                        f"read it inside `with self.{sorted(locks)[0]}:`, "
                        f"annotate the attribute `# guarded-by: <lock>` (the "
                        f"lock-discipline checker then proves every access), "
                        f"or waive the method with `# guarded-by-caller: "
                        f"<lock>` when callers provably hold it"
                    ),
                )

    # -- rule 2: sample-path allocation ban ----------------------------
    def _check_sample_paths(self, fi):
        marked = []
        for node in ast.walk(fi.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            end = getattr(node, "end_lineno", node.lineno) or node.lineno
            for ln in range(node.lineno, end + 1):
                # TRAILING-comment match only (rstrip + endswith), so
                # the marker string inside a message/docstring — this
                # checker's own — cannot self-mark a function
                if fi.line(ln).rstrip().endswith(SAMPLE_MARKER):
                    marked.append((node, end))
                    break
        for method, end in marked:
            for node in ast.walk(method):
                bad = None
                if isinstance(
                    node,
                    (ast.List, ast.Dict, ast.Set, ast.Tuple, ast.ListComp,
                     ast.SetComp, ast.DictComp, ast.GeneratorExp,
                     ast.JoinedStr),
                ):
                    # an empty-display return is still a per-call alloc
                    bad = type(node).__name__
                elif (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in _ALLOC_BUILTINS
                ):
                    bad = f"{node.func.id}()"
                if bad is None:
                    continue
                yield Finding(
                    checker=self.name, path=fi.rel,
                    line=getattr(node, "lineno", method.lineno),
                    message=(
                        f"[{bad}] allocation inside `# lint: sample-path` "
                        f"function {method.name} — the sample path runs per "
                        f"key per sweep in every process; it must stay "
                        f"counter arithmetic (zero-alloc-on-sample contract, "
                        f"obs/timeseries.py)"
                    ),
                    hint=(
                        "move the allocation to configure/first-sight time "
                        "(preallocated ring columns) or to the read-time "
                        "view; if a bounded allocation is genuinely "
                        "required, add a reviewed allowlist entry with the "
                        "bound in the justification"
                    ),
                )
