"""Checker modules — importing this package registers every checker.

One module per invariant; each names the bug (from this repo's own PR
history) it exists to prevent. Add a new checker by dropping a module
here that subclasses :class:`psana_ray_tpu_torch.lint.core.Checker` and
decorates it with ``@register``, then giving it a bad/good fixture pair
under ``tests/lint_fixtures/`` (``tests/test_torch_lint.py`` enforces
that every registered checker has one).
"""

from psana_ray_tpu_torch.lint.checkers import (  # noqa: F401  (import = register)
    blocking,
    evblocking,
    hotalloc,
    leases,
    locks,
    names,
    resend,
    segments,
    telemetry,
    threads,
    wire,
    wiretaint,
)
# the flow layer registers through the same import contract
import psana_ray_tpu_torch.lint.flow  # noqa: F401,E402  (import = register)
# the model layer likewise: drift gate + bounded exploration
import psana_ray_tpu_torch.lint.model.checker  # noqa: F401,E402  (import = register)
