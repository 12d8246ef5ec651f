"""segment-lifecycle: every segment lease/mmap must reach close/recycle.

The durability layer holds kernel resources the GC cannot be
trusted to return promptly: an mmap'd segment pins its mapping (and, on
the free list, a scrubbed file) until ``close()``; a segment that
escapes the ring without reaching ``close``/``retire``/``reset`` or the
ring's tracked collections leaks a mapping per rollover — the on-disk
sibling of the lease-lifecycle bug class, enforced with the same
machinery (:mod:`psana_ray_tpu_torch.lint.checkers.leases`).

Acquisition sites (anything else is out of scope):

- ``Segment.allocate(...)`` / ``Segment.open_existing(...)`` — a mapped
  segment is born;
- ``mmap.mmap(...)`` — the raw mapping itself;
- ``self._new_segment(...)`` — the log's create-or-recycle entry point.

Accepted consumption patterns (anything else is a finding):

- the acquisition appears in a ``return`` expression — ownership
  transfers to the caller, checked at ITS site;
- assigned to a name that provably reaches ``close()``/``retire()``/
  ``reset()`` on some path, with a ``try``/``finally``-or-``except``
  release for the failure path, is handed to a tracked collection
  (``.append(seg)`` — the ring/free list, closed by ``close()``), is
  passed to a constructor/call that takes ownership, or is returned;
- a ``with`` statement (context-managed mmaps).
"""

from __future__ import annotations

import ast

from psana_ray_tpu_torch.lint.core import Checker, Finding, register

# call shapes that mint a segment/mapping
ACQUIRE_ATTRS = {"open_existing", "_new_segment"}  # <x>.open_existing(...)
ACQUIRE_MMAP = "mmap"  # mmap.mmap(...)
SEGMENT_BASE = "Segment"  # Segment.allocate / Segment.open_existing
SEGMENT_MINTERS = {"allocate", "create"}  # create kept: the obvious rename
# consumption that discharges the obligation
RELEASE_ATTRS = {"close", "retire", "reset"}
OWNER_ATTRS = {"append"}  # handed to the ring / free list


def _is_acquire(node) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr in ACQUIRE_ATTRS:
            return True
        if isinstance(f.value, ast.Name):
            if f.value.id == SEGMENT_BASE and f.attr in SEGMENT_MINTERS:
                return True
            if f.value.id == ACQUIRE_MMAP and f.attr == ACQUIRE_MMAP:
                return True
    return False


def _uses_name(node, name: str) -> bool:
    return any(
        isinstance(n, ast.Name) and n.id == name for n in ast.walk(node)
    )


def _releases_name(body, name: str) -> bool:
    for stmt in body:
        for n in ast.walk(stmt):
            if (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in RELEASE_ATTRS
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id == name
            ):
                return True
    return False


def _name_discharged(func, name: str) -> bool:
    for node in ast.walk(func):
        if isinstance(node, ast.Try):
            if _releases_name(node.finalbody, name):
                return True
            for handler in node.handlers:
                if _releases_name(handler.body, name):
                    return True
        elif isinstance(node, ast.Call):
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr in (RELEASE_ATTRS | OWNER_ATTRS)
                and any(_uses_name(a, name) for a in node.args)
            ):
                return True
            # handed to a constructor/call that takes ownership of the
            # mapping (e.g. cls(path, f, mm, ...) in Segment.allocate)
            if any(
                isinstance(a, ast.Name) and a.id == name for a in node.args
            ) and isinstance(f, ast.Name):
                return True
        elif isinstance(node, ast.Return):
            if node.value is not None and _uses_name(node.value, name):
                return True  # ownership to the caller
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ce = item.context_expr
                if isinstance(ce, ast.Name) and ce.id == name:
                    return True
    return False


@register
class SegmentLifecycleChecker(Checker):
    name = "segment-lifecycle"
    description = (
        "Segment.allocate / Segment.open_existing / mmap.mmap / _new_segment "
        "results must reach close()/retire()/reset(), a tracked collection, "
        "or a returning owner on all paths (a leaked segment pins an mmap "
        "per rollover)"
    )

    def run(self, index):
        for fi in index.files:
            for node in ast.walk(fi.tree):
                if not _is_acquire(node):
                    continue
                parent = fi.parents.get(node)
                if isinstance(parent, (ast.Return, ast.withitem)):
                    continue
                if isinstance(parent, ast.Call):
                    f = parent.func
                    handed = isinstance(f, ast.Attribute) and f.attr in (
                        RELEASE_ATTRS | OWNER_ATTRS
                    )
                    if handed:
                        continue
                    yield self._finding(
                        fi, node,
                        "segment/mmap acquisition passed to a call the "
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
                            if isinstance(
                                a, (ast.FunctionDef, ast.AsyncFunctionDef)
                            )
                        ),
                        None,
                    )
                    if func is not None and _name_discharged(func, name):
                        continue
                    yield self._finding(
                        fi, node,
                        f"segment/mmap assigned to {name!r} never provably "
                        f"reaches close()/retire()/reset() or a tracked "
                        f"owner",
                    )
                    continue
                yield self._finding(
                    fi, node,
                    "segment/mmap acquisition result is dropped or untracked",
                )

    def _finding(self, fi, node, msg) -> Finding:
        return Finding(
            checker=self.name, path=fi.rel, line=node.lineno,
            message=msg,
            hint="close/retire/reset in a try/finally (or except + raise), "
            "append to the segment ring / free list, hand to an owning "
            "constructor, use `with`, or return it so the caller owns it",
        )
