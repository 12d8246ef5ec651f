"""thread-hygiene: no thread that can outlive the process's intent.

A post-mortem: a leftover non-daemon thread (a starved competing
consumer whose 30 s join was missed) kept the whole pytest process
alive after the last test finished — the suite "hung" with zero tests
running. The rule this checker enforces is the one that fix landed on:
every ``threading.Thread`` must either be ``daemon=True`` (the process
may exit without it) or live in a module that demonstrably joins its
threads WITH A DEADLINE (a ``.join(timeout=...)`` / ``.join(t)`` call —
an unbounded ``join()`` just moves the hang from interpreter exit to
the join site).

Resolution is module-granular by design: statically tracking a Thread
object through lists, loops, and attributes ("which join joins which
thread") is alias analysis this 300-line framework should not attempt.
A module that creates non-daemon threads and contains no bounded join
anywhere has no deadline story at all — that is precisely the hang
class, and the deliberate exceptions (the producer's foreground shard
pumps, which the CLI blocks on by contract) carry allowlist entries
with written justifications.
"""

from __future__ import annotations

import ast

from psana_ray_tpu_torch.lint.core import Checker, Finding, register


def _is_thread_ctor(node: ast.Call) -> bool:
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr == "Thread":
        return isinstance(f.value, ast.Name) and f.value.id == "threading"
    return isinstance(f, ast.Name) and f.id == "Thread"


def _daemon_true(node: ast.Call) -> bool:
    for kw in node.keywords:
        if kw.arg == "daemon":
            return isinstance(kw.value, ast.Constant) and kw.value.value is True
    return False


def _has_bounded_join(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "join"
            and (node.args or any(kw.arg == "timeout" for kw in node.keywords))
        ):
            return True
    return False


@register
class ThreadHygieneChecker(Checker):
    name = "thread-hygiene"
    description = (
        "threading.Thread must be daemon=True, or its module must join "
        "threads with a deadline (the pytest-exit-hang class)"
    )

    def run(self, index):
        for fi in index.files:
            bounded_join = None  # computed lazily: most files make no threads
            for node in ast.walk(fi.tree):
                if not (isinstance(node, ast.Call) and _is_thread_ctor(node)):
                    continue
                if _daemon_true(node):
                    continue
                if bounded_join is None:
                    bounded_join = _has_bounded_join(fi.tree)
                if bounded_join:
                    continue
                yield Finding(
                    checker=self.name, path=fi.rel, line=node.lineno,
                    message="threading.Thread without daemon=True in a "
                    "module with no deadline-bounded join — if the target "
                    "wedges, interpreter exit (and pytest) hangs forever",
                    hint="pass daemon=True, or join the thread with a "
                    "timeout on every shutdown path; a deliberate "
                    "foreground thread needs an allowlist entry saying "
                    "what bounds its lifetime",
                )
