"""windowed-resend: a pipelined-put window must resend and prune its tail.

The windowed PUT path (``transport/tcp.py``) keeps up to W
sequence-numbered puts in flight before blocking on their acks. The
crash-safety of that pipeline rests on exactly two idioms, and losing
either is silent data corruption, not an error:

- **resend**: every reconnect resends the entire unacknowledged tail,
  in order, before any new request touches the fresh connection — a
  drop mid-window otherwise leaves HOLES in the stream (the server
  acked 1..k, the client forgets k+1..k+w, and nothing ever notices);
- **prune**: acknowledgements remove entries from the tail — without
  it the window structure grows without bound and every reconnect
  re-duplicates the whole session.

The checker is structural, not name-bound to tcp.py: any class that
APPENDS to a ``*unacked*`` attribute and also reconnects (a method, or
a call to a function, whose name contains ``reconnect``) gets the rule:

- some method must iterate the unacked attribute and perform a send
  (a call whose bare name contains ``send``) inside that loop — the
  resend path;
- some method must remove entries (``popleft``/``pop``/``clear``/
  ``remove``, or a ``del`` statement naming the attribute) — the
  ack-driven window advance.

Classes that track an unacked window but never reconnect (e.g. a
server-side per-connection stream, whose tail dies with the socket) are
out of scope — the invariant is specifically about surviving a
reconnect with the window intact.
"""

from __future__ import annotations

import ast
from typing import Dict, Set

from psana_ray_tpu_torch.lint.core import Checker, Finding, register

_PRUNE_METHODS = {"popleft", "pop", "clear", "remove"}


def _self_unacked_attr(node: ast.AST):
    """``self.<attr>`` where <attr> contains 'unacked', else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
        and "unacked" in node.attr.lower()
    ):
        return node.attr
    return None


def _subtree_mentions_attr(node: ast.AST, attr: str) -> bool:
    return any(_self_unacked_attr(n) == attr for n in ast.walk(node))


def _call_bare_name(call: ast.Call) -> str:
    if isinstance(call.func, ast.Name):
        return call.func.id
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return ""


@register
class WindowedResendChecker(Checker):
    name = "windowed-resend"
    description = (
        "a class that appends to a *unacked* window and reconnects must "
        "both resend the tail (iterate + send) and prune it on ack"
    )

    def run(self, index):
        for fi in index.files:
            for cls in fi.tree.body:
                if not isinstance(cls, ast.ClassDef):
                    continue
                yield from self._check_class(fi, cls)

    def _check_class(self, fi, cls: ast.ClassDef):
        # pass 1: tracked tails, prunes, and whether the class reconnects
        appends: Dict[str, int] = {}  # attr -> first append line
        pruned: Set[str] = set()
        reconnects = False
        for node in ast.walk(cls):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if "reconnect" in node.name.lower():
                    reconnects = True
            elif isinstance(node, ast.Call):
                if "reconnect" in _call_bare_name(node).lower():
                    reconnects = True
                if isinstance(node.func, ast.Attribute):
                    attr = _self_unacked_attr(node.func.value)
                    if attr is not None:
                        if node.func.attr == "append":
                            appends.setdefault(attr, node.lineno)
                        elif node.func.attr in _PRUNE_METHODS:
                            pruned.add(attr)
            elif isinstance(node, ast.Delete):
                for tgt in node.targets:
                    for n in ast.walk(tgt):
                        attr = _self_unacked_attr(n)
                        if attr is not None:
                            pruned.add(attr)
        if not reconnects or not appends:
            return
        # pass 2: resend loops — iterate the tail, send inside the body
        resent: Set[str] = set()
        for node in ast.walk(cls):
            if not isinstance(node, (ast.For, ast.AsyncFor)):
                continue
            for attr in appends:
                if attr in resent or not _subtree_mentions_attr(node.iter, attr):
                    continue
                for inner in ast.walk(node):
                    if isinstance(inner, ast.Call) and "send" in _call_bare_name(
                        inner
                    ).lower():
                        resent.add(attr)
                        break
        for attr, lineno in sorted(appends.items()):
            if attr not in resent:
                yield Finding(
                    checker=self.name,
                    path=fi.rel,
                    line=lineno,
                    message=f"windowed put tail self.{attr} is appended to and "
                    f"the class reconnects, but no method iterates the tail "
                    f"and re-sends it — a drop mid-window leaves holes the "
                    f"at-least-once contract forbids",
                    hint="add a resend loop (for seq, item in self."
                    f"{attr}: ...send...) on the reconnect path, before any "
                    "new request uses the fresh connection",
                )
            if attr not in pruned:
                yield Finding(
                    checker=self.name,
                    path=fi.rel,
                    line=lineno,
                    message=f"windowed put tail self.{attr} is appended to but "
                    f"never pruned — the in-flight window can only grow, and "
                    f"every reconnect re-duplicates the whole session",
                    hint=f"drop acknowledged entries (popleft/pop/clear) from "
                    f"self.{attr} as acks arrive",
                )
