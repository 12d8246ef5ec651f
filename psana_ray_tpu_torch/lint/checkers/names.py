"""undefined-name: loads of names never bound anywhere in the module.

Migrated from the original NameError screen of the test suite. The
first version shipped ``List[float]`` with ``List``
never imported — invisible to the suite because ``from __future__
import annotations`` defers evaluation, but a latent NameError for any
consumer that introspects annotations; the screen also caught a real
py3.10 ``ExceptionGroup`` NameError in infeed/multihost.py on day one.

Two implementations, richest available wins:

- **pyflakes** when importable (install the ``[dev]`` extra): real
  scope-aware analysis; only NameError-class messages fail (style
  findings like unused imports stay advisory);
- **stdlib AST fallback** otherwise: flags loads of names never bound in
  ANY scope of the file. Conservative by construction — a binding
  anywhere whitelists the name — so it cannot false-positive on
  cross-scope uses, at the cost of missing shadowing bugs.
"""

from __future__ import annotations

import ast
import builtins
import re

from psana_ray_tpu_torch.lint.core import Checker, Finding, register

# Module-level / implicit names that are defined without an AST binding.
_IMPLICIT = {
    "__file__", "__name__", "__doc__", "__package__", "__spec__",
    "__loader__", "__builtins__", "__debug__", "__annotations__",
    "__class__", "__path__", "__qualname__", "__module__", "__dict__",
}
_ALLOWED = set(dir(builtins)) | _IMPLICIT


class _Binder(ast.NodeVisitor):
    """Collect every name the module binds, in ANY scope (conservative:
    scope-blind union, so cross-scope uses never false-positive)."""

    def __init__(self):
        self.bound = set()

    def visit_Name(self, node):
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self.bound.add(node.id)
        self.generic_visit(node)

    def _bind_args(self, args: ast.arguments):
        for a in (
            *args.posonlyargs, *args.args, *args.kwonlyargs,
            *filter(None, (args.vararg, args.kwarg)),
        ):
            self.bound.add(a.arg)

    def visit_FunctionDef(self, node):
        self.bound.add(node.name)
        self._bind_args(node.args)
        self.generic_visit(node)

    def visit_AsyncFunctionDef(self, node):
        self.bound.add(node.name)
        self._bind_args(node.args)
        self.generic_visit(node)

    def visit_Lambda(self, node):
        self._bind_args(node.args)
        self.generic_visit(node)

    def visit_ClassDef(self, node):
        self.bound.add(node.name)
        self.generic_visit(node)

    def visit_Import(self, node):
        for alias in node.names:
            self.bound.add(alias.asname or alias.name.split(".")[0])

    def visit_ImportFrom(self, node):
        for alias in node.names:
            if alias.name != "*":
                self.bound.add(alias.asname or alias.name)

    def visit_ExceptHandler(self, node):
        if node.name:
            self.bound.add(node.name)
        self.generic_visit(node)

    def visit_Global(self, node):
        self.bound.update(node.names)

    def visit_Nonlocal(self, node):
        self.bound.update(node.names)

    def visit_MatchAs(self, node):
        if node.name:
            self.bound.add(node.name)
        self.generic_visit(node)

    def visit_MatchStar(self, node):
        if node.name:
            self.bound.add(node.name)
        self.generic_visit(node)

    def visit_MatchMapping(self, node):
        if node.rest:
            self.bound.add(node.rest)
        self.generic_visit(node)


def undefined_names(tree: ast.AST):
    """``[(lineno, name), ...]`` loads of names never bound in the file."""
    binder = _Binder()
    binder.visit(tree)
    known = binder.bound | _ALLOWED
    out = []
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Name)
            and isinstance(node.ctx, ast.Load)
            and node.id not in known
        ):
            out.append((node.lineno, node.id))
    return out


_PYFLAKES_LOC = re.compile(r"^(?:.*?):(\d+):")


def _pyflakes_messages(fi):
    """NameError-class pyflakes messages for an indexed file as
    ``[(lineno, text), ...]``, or None when pyflakes is unavailable.
    Checks the IN-MEMORY source the index already read — no second
    disk read, no read/parse skew if the file changes mid-run."""
    try:
        from pyflakes import api as pyflakes_api
        from pyflakes import reporter as pyflakes_reporter
    except ImportError:
        return None
    import io

    buf = io.StringIO()
    rep = pyflakes_reporter.Reporter(buf, buf)
    pyflakes_api.check(fi.source, str(fi.path), rep)
    out = []
    for line in buf.getvalue().splitlines():
        # fail only on NameError-class findings; style findings (unused
        # import, redefinition) stay out of the gate
        if "undefined name" in line or (
            "local variable" in line and "referenced before" in line
        ):
            m = _PYFLAKES_LOC.match(line)
            out.append((int(m.group(1)) if m else 0, line))
    return out


@register
class UndefinedNameChecker(Checker):
    name = "undefined-name"
    description = (
        "loads of names never bound in the module (latent NameError); "
        "pyflakes when available, conservative AST fallback otherwise"
    )

    def run(self, index):
        for fi in index.files:
            flakes = _pyflakes_messages(fi)
            if flakes is not None:
                for lineno, text in flakes:
                    yield Finding(
                        checker=self.name, path=fi.rel, line=lineno,
                        message=f"pyflakes: {text}",
                        hint="bind or import the name before it is loaded",
                    )
                continue
            for lineno, nm in undefined_names(fi.tree):
                yield Finding(
                    checker=self.name, path=fi.rel, line=lineno,
                    message=f"name {nm!r} is used but never bound anywhere "
                    f"in this file (latent NameError)",
                    hint="bind or import the name; install the [dev] extra "
                    "(pyflakes) for scope-aware analysis",
                )
