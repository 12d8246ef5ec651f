"""Project-invariant static analysis for psana_ray_tpu_torch.

The registry encodes invariants this codebase has already paid for in
bugs — lock discipline on teardown-racing handles, lease lifecycles on
the zero-copy datapath, thread hygiene, wire-protocol exhaustiveness,
blocking calls on the drain path, plus the two original screens
(undefined names, hot-path allocation idioms). tf.data (Murray et al.,
VLDB 2021) makes the general argument: pipeline invariants
the runtime can only probabilistically catch (races, leaks, stalls) are
cheapest to enforce statically over program structure.

Entry points:

- ``python -m psana_ray_tpu_torch.lint [--json]`` — the CLI; exits non-zero
  on findings (CI gate);
- :func:`run_lint` — the library call ``tests/test_torch_lint.py``
  and ``chip_smoke.py``'s lint phase use;
- ``REGISTRY`` — name -> checker, populated by importing
  :mod:`psana_ray_tpu_torch.lint.checkers`.

Stdlib-only, importing neither torch nor jax: linting must work (fast) on ingest-only hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence

from psana_ray_tpu_torch.lint.core import (  # noqa: F401  (public API re-exports)
    Checker,
    Finding,
    LintResult,
    ProjectIndex,
    REGISTRY,
    default_target_files,
    register,
    run_checkers,
)
import psana_ray_tpu_torch.lint.checkers  # noqa: F401  (import = register all)
from psana_ray_tpu_torch.lint.allowlist import ALLOWLIST, Allow  # noqa: F401


def run_lint(
    paths: Optional[Sequence] = None,
    checkers: Optional[Sequence[str]] = None,
    use_allowlist: bool = True,
    allowlist: Optional[Sequence[Allow]] = None,
    use_cache: bool = False,
) -> LintResult:
    """Run the registry (or a named subset) over ``paths`` (default: the
    package + chip_smoke.py). Allowlist rot is reported only on full-registry,
    full-tree runs — a partial run legitimately leaves other checkers'
    entries unused. ``duration_s`` covers the WHOLE run — file reading
    and parsing included — so the budget in the tests and the card's
    lint phase measure what an operator actually waits for.
    ``use_cache=True`` reuses parses across runs via the content-keyed
    (sha256) cache in ``.lint_cache/`` (the CLI default; library
    callers opt in)."""
    import time

    t0 = time.perf_counter()
    cache = None
    if use_cache:
        from psana_ray_tpu_torch.lint.cache import ParseCache

        cache = ParseCache()
    index = ProjectIndex(
        paths if paths is not None else default_target_files(), cache=cache
    )
    if checkers is None:
        selected = [REGISTRY[name] for name in sorted(REGISTRY)]
    else:
        unknown = [c for c in checkers if c not in REGISTRY]
        if unknown:
            raise KeyError(
                f"unknown checker(s) {unknown}; have {sorted(REGISTRY)}"
            )
        selected = [REGISTRY[c] for c in checkers]
    entries = (allowlist if allowlist is not None else ALLOWLIST) if use_allowlist else ()
    full_run = checkers is None and paths is None
    result = run_checkers(
        index, selected, allowlist=entries, check_rot=use_allowlist and full_run
    )
    result.duration_s = time.perf_counter() - t0
    return result
