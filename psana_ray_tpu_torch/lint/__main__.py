"""CLI: ``python -m psana_ray_tpu_torch.lint [--json|--sarif] [--changed REF] [paths...]``.

Exit status is the CI contract: 0 = clean, 1 = findings (including
allowlist rot), 2 = usage error. Runs the full registry over the
package + chip_smoke.py by default, a subset with ``--checker`` (repeatable),
explicit files/directories given as positional paths, or — the
pre-commit path — only the files touched since a git ref with
``--changed REF`` (the wire-protocol pair rides along so the
cross-file checkers keep both sides in scope; see
``core.PROTOCOL_COMPANIONS``).

``--json`` emits the shape ``chip_smoke.py``'s lint phase reads
(``counts_by_checker`` includes zeros for every checker that ran, so
"ran clean" and "did not run" stay distinguishable); ``--sarif`` emits
SARIF 2.1.0 for CI PR annotation. Parses are cached across runs in
``.lint_cache/`` (``--no-cache`` for a cold run).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from psana_ray_tpu_torch.lint import REGISTRY, run_lint
from psana_ray_tpu_torch.lint.core import changed_target_files


def _expand(paths):
    out = []
    for p in paths:
        path = pathlib.Path(p)
        if path.is_dir():
            out.extend(sorted(path.rglob("*.py")))
        else:
            out.append(path)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m psana_ray_tpu_torch.lint",
        description="project-invariant static analysis (see README: "
        "'Static analysis' runbook)",
    )
    ap.add_argument(
        "paths", nargs="*",
        help="files/directories to scan (default: the package + chip_smoke.py)",
    )
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument(
        "--sarif", action="store_true",
        help="SARIF 2.1.0 output (CI PR annotation)",
    )
    ap.add_argument(
        "--changed", metavar="GIT_REF",
        help="scan only default-target files touched since GIT_REF "
        "(plus the wire-protocol pair); the incremental pre-commit mode",
    )
    ap.add_argument(
        "--model", action="store_true",
        help="run the bounded protocol model checker (full profile) + "
        "drift gate instead of the checker registry",
    )
    ap.add_argument(
        "--checker", action="append", metavar="NAME",
        help="run only this checker (repeatable; see --list)",
    )
    ap.add_argument(
        "--no-allowlist", action="store_true",
        help="ignore the reviewed allowlist (show every raw finding)",
    )
    ap.add_argument(
        "--no-cache", action="store_true",
        help="skip the .lint_cache parse cache (cold run)",
    )
    ap.add_argument("--list", action="store_true", help="list registered checkers")
    args = ap.parse_args(argv)

    if args.list:
        for name in sorted(REGISTRY):
            print(f"{name}: {REGISTRY[name].description}")
        return 0
    if args.changed and args.paths:
        print("error: --changed and explicit paths are exclusive", file=sys.stderr)
        return 2
    if args.json and args.sarif:
        print("error: --json and --sarif are exclusive", file=sys.stderr)
        return 2
    if args.model:
        if args.paths or args.changed or args.checker or args.sarif:
            print(
                "error: --model runs the model layer alone (no paths/"
                "--changed/--checker/--sarif)", file=sys.stderr,
            )
            return 2
        from psana_ray_tpu_torch.lint.model.checker import main_model

        return main_model(json_mode=args.json)
    # a typo'd explicit path is a USAGE error (exit 2), never exit 1 —
    # CI reads 1 as "findings present" and must not misread a typo as one
    missing = [p for p in args.paths if not pathlib.Path(p).exists()]
    if missing:
        print(f"error: no such file or directory: {missing}", file=sys.stderr)
        return 2
    paths = _expand(args.paths) if args.paths else None
    if args.changed:
        # a bad ref is a usage error, not findings — and never a silent
        # full-tree run
        try:
            paths = changed_target_files(args.changed)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    try:
        result = run_lint(
            paths=paths,
            checkers=args.checker,
            use_allowlist=not args.no_allowlist,
            use_cache=not args.no_cache,
        )
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2

    if args.sarif:
        from psana_ray_tpu_torch.lint.sarif import to_sarif

        print(json.dumps(to_sarif(result), indent=2))
    elif args.json:
        print(json.dumps(result.to_json(), indent=2))
    else:
        for f in result.findings:
            print(f.render())
        status = "clean" if result.ok else f"{len(result.findings)} finding(s)"
        print(
            f"lint: {status} — {result.files_scanned} files, "
            f"{len(result.checkers_run)} checkers, {result.duration_s:.2f}s"
        )
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
