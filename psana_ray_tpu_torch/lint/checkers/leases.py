"""lease-lifecycle: leased buffers must provably reach release().

The zero-copy datapath runs on leases: pooled recv buffers
(``BufferPool.lease``) and consumed-but-unreleased ring slots
(``get_view``/``get_batch_view``/``_SlotLease``). Every lease carries a
GC ``__del__`` backstop — but the backstop is a FALLBACK, not the
contract: a lease that only GC frees delays pool reuse by a collection
cycle (allocation churn returns) and, on the shm ring, keeps a SLOT
away from producers until finalization (a full ring then looks like a
wedged peer). This checker makes the contract structural: a
lease-producing call must hand its result to a known owner on every
path.

Accepted consumption patterns (anything else is a finding):

- ``return pool.lease(n)`` / the lease appears in a return expression —
  ownership transfers to the caller, whose own body is checked at ITS
  call site;
- ``with pool.lease(n) as l:`` / a later ``with l:`` — ``Lease`` is a
  context manager; ``__exit__`` releases;
- passed to a known owner: ``decode_payload``/``decode``/``_decode``
  (attach the lease to the record they build), ``push_view``
  (copies then releases), ``materialize`` (detaches), or any call
  taking it as an explicit ``lease=`` keyword;
- ``x = ...lease...`` where the enclosing function has a ``try`` whose
  ``finally``/``except`` body calls ``x.release()`` — the
  exception-path release that keeps a decode failure from stranding
  the buffer;
- batch variants (``get_batch_view``): the result list is iterated and
  the loop body routes items through an owner call or ``release``/
  ``materialize``.

Heuristic by declared scope: the checker verifies that SOME owning
path exists and that the failure path releases; it does not prove
per-branch coverage (that is what the fixture tests pin down for the
patterns we actually use).
"""

from __future__ import annotations

import ast

from psana_ray_tpu_torch.lint.core import Checker, Finding, register

LEASE_METHODS = {"lease", "get_view", "get_batch_view"}
LEASE_CTORS = {"_SlotLease"}
OWNER_FUNCS = {"decode_payload", "decode", "_decode", "push_view", "materialize"}
RELEASE_ATTRS = {"release", "materialize"}


def _call_name(call: ast.Call):
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _is_lease_call(node) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in LEASE_METHODS:
        return True
    return isinstance(f, ast.Name) and f.id in LEASE_CTORS


def _uses_name(node, name: str) -> bool:
    return any(
        isinstance(n, ast.Name) and n.id == name for n in ast.walk(node)
    )


def _releases_name(body, name: str) -> bool:
    """True when ``body`` (a list of statements) contains
    ``<name>.release()``."""
    for stmt in body:
        for n in ast.walk(stmt):
            if (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "release"
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id == name
            ):
                return True
    return False


def _name_protected(func, name: str) -> bool:
    for node in ast.walk(func):
        if isinstance(node, ast.Try):
            if _releases_name(node.finalbody, name):
                return True
            for handler in node.handlers:
                if _releases_name(handler.body, name):
                    return True
        elif isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == "lease" and _uses_name(kw.value, name):
                    return True
            if _call_name(node) in OWNER_FUNCS and any(
                _uses_name(a, name) for a in node.args
            ):
                return True
        elif isinstance(node, ast.Return):
            if node.value is not None and _uses_name(node.value, name):
                return True  # ownership to the caller
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if isinstance(item.context_expr, ast.Name) and item.context_expr.id == name:
                    return True  # Lease is a context manager
        elif isinstance(node, ast.For):
            # batch variant: `for rec in <name>:` with the loop body
            # routing items through an owner / release / materialize
            if _uses_name(node.iter, name):
                for n in ast.walk(node):
                    if isinstance(n, ast.Call) and (
                        _call_name(n) in OWNER_FUNCS
                        or _call_name(n) in RELEASE_ATTRS
                    ):
                        return True
    return False


@register
class LeaseLifecycleChecker(Checker):
    name = "lease-lifecycle"
    description = (
        "BufferPool.lease / get_view / get_batch_view / _SlotLease results "
        "must reach release()/materialize() or a known owner on all paths "
        "(the GC __del__ backstop is a fallback, not the contract)"
    )

    def run(self, index):
        for fi in index.files:
            for node in ast.walk(fi.tree):
                if not _is_lease_call(node):
                    continue
                parent = fi.parents.get(node)
                if isinstance(parent, (ast.Return, ast.withitem)):
                    continue
                if isinstance(parent, ast.Call):
                    handed = _call_name(parent) in OWNER_FUNCS or any(
                        kw.arg == "lease" and kw.value is node
                        for kw in parent.keywords
                    )
                    if handed:
                        continue
                    yield self._finding(
                        fi, node,
                        "lease-producing call passed to a function the "
                        "checker does not know as an owner",
                    )
                    continue
                if (
                    isinstance(parent, ast.Assign)
                    and len(parent.targets) == 1
                    and isinstance(parent.targets[0], ast.Name)
                ):
                    name = parent.targets[0].id
                    func = next(
                        (
                            a
                            for a in fi.ancestors(node)
                            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))
                        ),
                        None,
                    )
                    if func is not None and _name_protected(func, name):
                        continue
                    yield self._finding(
                        fi, node,
                        f"lease assigned to {name!r} never provably reaches "
                        f"release()/materialize() or a known owner",
                    )
                    continue
                yield self._finding(
                    fi, node,
                    "lease-producing call result is dropped or untracked",
                )

    def _finding(self, fi, node, msg) -> Finding:
        return Finding(
            checker=self.name, path=fi.rel, line=node.lineno,
            message=msg,
            hint="release in a try/finally (or except + raise), pass the "
            "lease to decode_payload(..., lease=)/push_view/materialize, "
            "use `with`, or return it so the caller owns it",
        )
