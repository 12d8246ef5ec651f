"""lockset-inference: Eraser-style lockset computation, no annotations.

``lock-discipline`` enforces the locks you DECLARED
(``# guarded-by:``). The recurring review class is the
field nobody declared: shared state accessed under ``self._lock`` in
five methods and bare in the sixth — correct until a teardown or a
scrape thread hits the sixth. This checker computes, per class that
owns a lock, the set of locks lexically held at every ``self.<attr>``
access (Eraser's lockset algorithm, static flavor), and reports fields
whose accesses have NO common lock while at least one access holds one
— inconsistency, not mere lock-freedom, is the signal.

Scope rules (each kills a documented noise class):

- only classes that own a lock (``self.X = threading.Lock/RLock/
  Condition``) are analyzed: a lock-free class has no lockset story;
- ``__init__`` accesses are ignored (construction races with nobody —
  Eraser's init phase), and attributes never STORED outside
  ``__init__`` are skipped entirely (set-once config fields are safely
  read bare);
- accesses inside nested defs/lambdas are skipped (they run under the
  caller's locks — e.g. ``wait_for`` predicates), matching
  lock-discipline;
- ``# guarded-by-caller: <lock>`` methods count the named lock as held
  (the declared-contract waiver, same as lock-discipline);
- attributes annotated ``# guarded-by:`` are lock-discipline's job;
  here the annotation is checked AGAINST the inferred sets instead: an
  annotation naming a lock that no access ever holds (and that no
  waiver covers) is reported as a wrong-lock annotation.

One finding per (class, field), anchored at the field's first
assignment line so an allowlist entry pins to the declaration, not to
a drifting access site. The witnesses (one locked, one bare) ride in
the message.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from psana_ray_tpu_torch.lint.core import Checker, Finding, register
from psana_ray_tpu_torch.lint.checkers.locks import (
    CALLER_RE,
    GUARDED_RE,
    _held_locks,
    _self_attr,
)

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}


def _lock_attrs(cls: ast.ClassDef) -> Tuple[Set[str], Dict[str, str]]:
    """(lock-attr names, Condition aliases lockattr->canonical)."""
    locks: Set[str] = set()
    aliases: Dict[str, str] = {}
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        attr = _self_attr(node.targets[0])
        if attr is None or not isinstance(node.value, ast.Call):
            continue
        f = node.value.func
        ctor = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None
        )
        if ctor in _LOCK_CTORS:
            locks.add(attr)
            if ctor == "Condition" and node.value.args:
                src = _self_attr(node.value.args[0])
                if src is not None:
                    aliases[attr] = src
    return locks, aliases


def _annotated_attrs(fi, cls: ast.ClassDef) -> Dict[str, str]:
    """attr -> declared lock, for `# guarded-by:` annotated assignments
    (the same attachment rule lock-discipline uses)."""
    out: Dict[str, str] = {}
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        else:
            continue
        attrs = []
        for t in targets:
            for leaf in t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]:
                a = _self_attr(leaf)
                if a is not None:
                    attrs.append(a)
        if not attrs:
            continue
        end = getattr(node, "end_lineno", node.lineno) or node.lineno
        for ln in range(node.lineno, end + 1):
            m = GUARDED_RE.search(fi.line(ln))
            if m:
                for a in attrs:
                    out[a] = m.group(1)
                break
    return out


class _Access:
    __slots__ = ("method", "line", "held", "store")

    def __init__(self, method, line, held, store):
        self.method = method
        self.line = line
        self.held = held
        self.store = store


def _class_accesses(fi, cls, locks, aliases):
    """attr -> [_Access, ...] over every method except __init__,
    nested-def bodies excluded. First-assignment anchor lines ride
    along: attr -> line."""
    accesses: Dict[str, List[_Access]] = {}
    anchor: Dict[str, int] = {}
    outer_stores: Set[str] = set()
    for method in cls.body:
        if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        end = getattr(method, "end_lineno", method.lineno) or method.lineno
        waived = {
            aliases.get(w, w)
            for ln in range(method.lineno, end + 1)
            for w in CALLER_RE.findall(fi.line(ln))
        }
        for node in ast.walk(method):
            attr = _self_attr(node)
            if attr is None or attr in locks or attr in aliases:
                continue
            nested = False
            for anc in fi.ancestors(node):
                if anc is method:
                    break
                if isinstance(
                    anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    nested = True
                    break
            if nested:
                continue
            store = isinstance(node.ctx, (ast.Store, ast.Del))
            if store and attr not in anchor:
                anchor[attr] = node.lineno
            if method.name == "__init__":
                continue  # construction races with nobody
            if store:
                outer_stores.add(attr)
            held = frozenset(
                _held_locks(fi, node, method, aliases) | waived
            )
            accesses.setdefault(attr, []).append(
                _Access(method.name, node.lineno, held, store)
            )
    return accesses, anchor, outer_stores


@register
class LocksetInferenceChecker(Checker):
    name = "lockset-inference"
    description = (
        "Eraser-style static locksets: in a lock-owning class, a field "
        "accessed under a lock in one method and bare in another is "
        "reported without needing a `# guarded-by` annotation"
    )

    def run(self, index):
        for fi in index.files:
            for cls in [n for n in ast.walk(fi.tree) if isinstance(n, ast.ClassDef)]:
                locks, aliases = _lock_attrs(cls)
                if not locks:
                    continue
                annotated = _annotated_attrs(fi, cls)
                accesses, anchor, outer_stores = _class_accesses(
                    fi, cls, locks, aliases
                )
                for attr in sorted(accesses):
                    accs = accesses[attr]
                    if attr not in outer_stores:
                        continue  # set-once in __init__, read-only after
                    if attr in annotated:
                        # the annotation is the contract; lock-discipline
                        # enforces it. Here: assert it against inference —
                        # a lock NO access ever holds is a wrong-lock
                        # annotation hiding behind green lint.
                        lock = aliases.get(annotated[attr], annotated[attr])
                        if accs and not any(lock in a.held for a in accs):
                            line = anchor.get(attr, accs[0].line)
                            yield Finding(
                                checker=self.name, path=fi.rel, line=line,
                                message=(
                                    f"{cls.name}.{attr} is annotated "
                                    f"guarded-by: {annotated[attr]} but no "
                                    f"access in any method holds it — the "
                                    f"annotation names the wrong lock"
                                ),
                                hint="fix the annotation (or the code) so "
                                "the declared lock matches the one actually "
                                "held at the accesses",
                            )
                        continue
                    locked = [a for a in accs if a.held]
                    bare = [a for a in accs if not a.held]
                    if not locked or not bare:
                        continue  # consistent (always locked or never)
                    line = anchor.get(attr, accs[0].line)
                    w_lock = locked[0]
                    w_bare = bare[0]
                    lockname = sorted(w_lock.held)[0]
                    yield Finding(
                        checker=self.name, path=fi.rel, line=line,
                        message=(
                            f"{cls.name}.{attr} has inconsistent inferred "
                            f"locksets: {w_lock.method}:{w_lock.line} holds "
                            f"{{{', '.join(sorted(w_lock.held))}}} but "
                            f"{w_bare.method}:{w_bare.line} holds no lock "
                            f"({len(locked)} locked / {len(bare)} bare "
                            f"accesses total)"
                        ),
                        hint=(
                            f"if the field is shared, hold self.{lockname} "
                            f"at every access and declare it `# guarded-by: "
                            f"{lockname}`; if the bare access is provably "
                            f"single-threaded (init/teardown-only), "
                            f"allowlist it with that justification"
                        ),
                    )
