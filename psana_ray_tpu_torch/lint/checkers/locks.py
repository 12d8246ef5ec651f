"""lock-discipline: annotated attributes must be touched under their lock.

An early shm ring shipped a scrape-vs-teardown use-after-free: ``ShmRingBuffer``
metrics scrapes read ``self._h`` while ``disconnect()`` freed it — a
check-then-use that segfaulted (NULL/freed pointer into C) under a
late ``/metrics`` hit. The fix was a handle lock; THIS checker makes
"every touch of that attribute holds that lock" a static invariant
instead of a review hope.

Convention (parsed from source comments, so the declaration sits right
on the data it protects):

- ``self._h = handle  # guarded-by: _handle_lock`` — every access to
  ``self._h`` outside ``__init__`` must be lexically inside
  ``with self._handle_lock:`` (aliases via
  ``self._cv = threading.Condition(self._lock)`` count as holding
  ``_lock``);
- ``# guarded-by-caller: _handle_lock`` anywhere in a method body —
  the method documents (and the checker trusts) that its CALLERS hold
  the lock; use for private helpers like ``RingBuffer._note_put``;
- class-level declarations (``_default: ... = None  # guarded-by:
  _default_lock``) guard ``cls.X`` / ``self.X`` access the same way.

Known limits (by design, to stay fast and false-positive-free): only
``self.``/``cls.``-qualified access in the declaring class is checked
(another object's attributes are that class's contract); accesses
inside nested ``def``/``lambda`` are skipped (they run later, usually
under the caller's lock — e.g. ``wait_for`` predicates); ``with``
detection is lexical AST containment, so a lock taken by a helper the
method calls needs ``# guarded-by-caller``.
"""

from __future__ import annotations

import ast
import re

from psana_ray_tpu_torch.lint.core import Checker, Finding, register

GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
CALLER_RE = re.compile(r"#\s*guarded-by-caller:\s*([A-Za-z_]\w*)")


def _self_attr(node):
    """'attr' for ``self.attr`` / ``cls.attr`` nodes, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id in ("self", "cls")
    ):
        return node.attr
    return None


def _collect_class(fi, cls):
    """(guarded: attr->lock, aliases: lockattr->canonical lock,
    annotated_lines: line numbers whose guarded-by comment attached)."""
    guarded, aliases, annotated_lines = {}, {}, set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign):
            targets, value = [node.target], node.value
        else:
            continue
        attrs = []
        flat_targets = []
        for t in targets:
            # tuple/list unpacking: `self._a, self._b = 0, 0` must not
            # silently drop the annotation on the line
            flat_targets.extend(t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t])
        for t in flat_targets:
            a = _self_attr(t)
            if a is not None:
                attrs.append(a)
            elif isinstance(t, ast.Name) and fi.parents.get(node) is cls:
                attrs.append(t.id)  # class-body declaration
        if not attrs:
            continue
        end = getattr(node, "end_lineno", node.lineno) or node.lineno
        m = None
        for ln in range(node.lineno, end + 1):
            m = GUARDED_RE.search(fi.line(ln))
            if m:
                break
        for a in attrs:
            if m:
                guarded[a] = m.group(1)
                annotated_lines.update(range(node.lineno, end + 1))
            # alias: self._cv = threading.Condition(self._lock) means
            # `with self._cv:` holds `_lock`
            if (
                isinstance(value, ast.Call)
                and isinstance(value.func, (ast.Attribute, ast.Name))
                and (
                    value.func.attr if isinstance(value.func, ast.Attribute)
                    else value.func.id
                )
                == "Condition"
                and value.args
            ):
                src = _self_attr(value.args[0])
                if src is not None:
                    aliases[a] = src
    return guarded, aliases, annotated_lines


def _held_locks(fi, node, method, aliases):
    """Lock attrs lexically held at ``node`` (canonicalized), walking
    ``with self.X:`` ancestors up to (and including) ``method``."""
    held = set()
    for anc in fi.ancestors(node):
        if isinstance(anc, (ast.With, ast.AsyncWith)):
            for item in anc.items:
                a = _self_attr(item.context_expr)
                if a is not None:
                    held.add(aliases.get(a, a))
        if anc is method:
            break
    return held


@register
class LockDisciplineChecker(Checker):
    name = "lock-discipline"
    description = (
        "attributes declared `# guarded-by: <lock>` must only be touched "
        "inside `with self.<lock>:` (or in `# guarded-by-caller` helpers)"
    )

    def run(self, index):
        for fi in index.files:
            for cls in [n for n in ast.walk(fi.tree) if isinstance(n, ast.ClassDef)]:
                guarded, aliases, annotated = _collect_class(fi, cls)
                # an annotation that attached to NO attribute is its own
                # finding (same rot class the allowlist guards against:
                # the comment looks accepted but enforces nothing)
                end_cls = getattr(cls, "end_lineno", cls.lineno) or cls.lineno
                for ln in range(cls.lineno, end_cls + 1):
                    if ln not in annotated and GUARDED_RE.search(fi.line(ln)):
                        yield Finding(
                            checker=self.name, path=fi.rel, line=ln,
                            message=f"`# guarded-by:` annotation in class "
                            f"{cls.name} attached to no attribute — the "
                            f"invariant it declares is NOT being enforced",
                            hint="put the comment on the line(s) of a "
                            "self.<attr> = ... assignment (tuple targets "
                            "are supported)",
                        )
                if not guarded:
                    continue
                for method in cls.body:
                    if not isinstance(
                        method, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        continue
                    if method.name == "__init__":
                        continue  # construction: no peer can hold a reference yet
                    end = getattr(method, "end_lineno", method.lineno)
                    waived = {
                        aliases.get(w, w)
                        for ln in range(method.lineno, (end or method.lineno) + 1)
                        for w in CALLER_RE.findall(fi.line(ln))
                    }
                    for node in ast.walk(method):
                        attr = _self_attr(node)
                        if attr is None or attr not in guarded:
                            continue
                        # skip accesses inside nested defs/lambdas: they
                        # execute later, under whatever lock their caller
                        # holds (e.g. Condition.wait_for predicates)
                        nested = False
                        for anc in fi.ancestors(node):
                            if anc is method:
                                break
                            if isinstance(
                                anc,
                                (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
                            ):
                                nested = True
                                break
                        if nested:
                            continue
                        lock = aliases.get(guarded[attr], guarded[attr])
                        if lock in waived:
                            continue
                        if lock in _held_locks(fi, node, method, aliases):
                            continue
                        yield Finding(
                            checker=self.name, path=fi.rel, line=node.lineno,
                            message=f"{cls.name}.{method.name} touches "
                            f"self.{attr} (guarded-by: {lock}) without "
                            f"holding self.{lock}",
                            hint=f"wrap the access in `with self.{lock}:`, "
                            f"or mark the method `# guarded-by-caller: "
                            f"{lock}` if every caller provably holds it",
                        )
