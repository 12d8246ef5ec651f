"""Framework core for the project-invariant static analysis.

The two ad-hoc screens of the old test suite (NameError scan, hot-path
allocation-idiom regex) each paid for themselves at once; this module is the shared machinery that lets every new
invariant this codebase has paid for in bugs (lock discipline, lease
lifecycle, thread hygiene, wire-protocol exhaustiveness, blocking calls
on the drain path) ship as a first-class, individually testable
checker:

- :class:`Finding` — one diagnostic with ``file:line``, a message, and a
  fix hint;
- :class:`Checker` + :func:`register` — the checker registry the CLI and
  the tests both run;
- :class:`FileIndex` / :class:`ProjectIndex` — each target file is read
  and ``ast``-parsed exactly ONCE per run and shared across checkers
  (with a lazily built parent map for lexical-containment questions),
  which is what keeps the full registry under the 5 s budget;
- :func:`run_checkers` — drives a checker selection over an index,
  applies the allowlist (reviewed exceptions with written
  justifications, see :mod:`psana_ray_tpu_torch.lint.allowlist`) and turns
  allowlist rot (an entry that suppressed nothing) into findings of its
  own.

Everything here is stdlib-only and import-light on purpose: the CLI
(``python -m psana_ray_tpu_torch.lint``) must work in environments that cannot
import jax or torch, and must finish in seconds.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import time
from typing import Dict, Iterable, List, Optional, Sequence

# repo root = parent of the package dir (lint/ -> psana_ray_tpu_torch/ -> root)
PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
REPO_ROOT = PACKAGE_DIR.parent


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: where, what, and how to fix it."""

    checker: str
    path: str  # repo-relative posix path
    line: int
    message: str
    hint: str = ""

    def render(self) -> str:
        out = f"{self.path}:{self.line}: [{self.checker}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def sort_key(self):
        return (self.path, self.line, self.checker, self.message)


class Checker:
    """One invariant. Subclasses set ``name``/``description`` and yield
    :class:`Finding` objects from :meth:`run`. Checkers must be pure
    functions of the index: no filesystem writes, no imports of the
    scanned code (everything is AST-level, so a file with a latent
    import-time crash can still be linted)."""

    name: str = ""
    description: str = ""

    def run(self, index: "ProjectIndex") -> Iterable[Finding]:
        raise NotImplementedError


REGISTRY: Dict[str, Checker] = {}


def register(cls):
    """Class decorator: instantiate and add to the registry by name."""
    inst = cls()
    if not inst.name:
        raise ValueError(f"checker {cls.__name__} has no name")
    if inst.name in REGISTRY:
        raise ValueError(f"duplicate checker name {inst.name!r}")
    REGISTRY[inst.name] = inst
    return cls


class FileIndex:
    """One parsed target file, shared by every checker in a run.
    ``cache`` (a :class:`psana_ray_tpu_torch.lint.cache.ParseCache`) carries
    the parse across RUNS; within a run this object is already the
    parse-once guarantee."""

    def __init__(self, path, cache=None):
        self.path = pathlib.Path(path)
        try:
            self.rel = self.path.resolve().relative_to(REPO_ROOT).as_posix()
        except ValueError:  # outside the repo (explicit CLI path)
            self.rel = self.path.as_posix()
        self.source = self.path.read_text()
        self.lines = self.source.splitlines()
        tree = cache.get(self.path, self.rel, self.source) if cache else None
        if tree is None:
            tree = ast.parse(self.source, filename=str(self.path))
            if cache is not None:
                cache.put(self.path, self.rel, self.source, tree)
        self.tree = tree
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None

    def line(self, lineno: int) -> str:
        if 0 < lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    @property
    def parents(self) -> Dict[ast.AST, ast.AST]:
        """child node -> parent node, built on first use."""
        if self._parents is None:
            p: Dict[ast.AST, ast.AST] = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    p[child] = node
            self._parents = p
        return self._parents

    def ancestors(self, node: ast.AST):
        """Yield parents from the immediate one up to the module."""
        parents = self.parents
        cur = parents.get(node)
        while cur is not None:
            yield cur
            cur = parents.get(cur)


def default_target_files() -> List[pathlib.Path]:
    """The tree the project invariants cover: the package + chip_smoke.py
    (the port's smoke run on the card, which drives every path the
    package has)."""
    files = sorted(PACKAGE_DIR.rglob("*.py"))
    smoke = REPO_ROOT / "chip_smoke.py"
    if smoke.exists():
        files.append(smoke)
    return files


# files the CROSS-FILE checkers anchor at; an incremental run always
# carries them so a subset scan cannot fabricate findings:
# - transport/tcp.py + transport/evloop.py + cluster/replication.py:
#   wire-protocol and protocol-dialogue need every side of the protocol
#   or a sent opcode looks undispatched (the replication link's
#   'H'/'V' senders live in cluster/replication.py);
# - infeed/batcher.py + infeed/fanin.py: blocking-hot-path's drain-loop
#   roots live there, and its root-resolution rot guard (rightly)
#   refuses to run silently uncovered on a >10-file scan
# - transport/workers.py: the worker-adoption handshake
#   replays opcodes ('M'/tenant/codec ctx over SCM_RIGHTS) into _on_op;
#   a scan that sees the dispatch table without the adoption plane (or
#   vice versa) reads adopted ops as dead dispatch
PROTOCOL_COMPANIONS = (
    "psana_ray_tpu_torch/transport/tcp.py",
    "psana_ray_tpu_torch/transport/evloop.py",
    "psana_ray_tpu_torch/transport/workers.py",
    "psana_ray_tpu_torch/cluster/replication.py",
)
INCREMENTAL_COMPANIONS = PROTOCOL_COMPANIONS + (
    "psana_ray_tpu_torch/infeed/batcher.py",
    "psana_ray_tpu_torch/infeed/fanin.py",
)


def changed_target_files(ref: str) -> List[pathlib.Path]:
    """The default-target files touched since ``ref`` — the diff runs
    from ``merge-base(ref, HEAD)`` to the working tree (so a branch
    merely BEHIND ``ref`` does not drag upstream-only changes into the
    incremental run), plus untracked files, ALWAYS including the
    protocol companion pair when anything is selected. Raises
    RuntimeError when git cannot answer (bad ref, not a checkout) —
    the CLI turns that into a usage error, never a silent full run."""
    import subprocess

    def _git(cmd: List[str]) -> str:
        try:
            proc = subprocess.run(
                cmd, cwd=REPO_ROOT, capture_output=True, text=True, timeout=30
            )
        except (OSError, subprocess.TimeoutExpired) as e:
            # no git binary / hung git must stay a usage error, not a
            # traceback out of the CLI
            raise RuntimeError(f"{' '.join(cmd)} failed: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd)} failed: {proc.stderr.strip() or proc.returncode}"
            )
        return proc.stdout

    base = _git(["git", "merge-base", ref, "HEAD"]).strip()
    names: set = set()
    for cmd in (
        ["git", "diff", "--name-only", "-z", base, "--"],
        ["git", "ls-files", "--others", "--exclude-standard", "-z"],
    ):
        names.update(n for n in _git(cmd).split("\0") if n)
    targets = {f.resolve(): f for f in default_target_files()}
    selected = []
    for name in sorted(names):
        resolved = (REPO_ROOT / name).resolve()
        if resolved in targets:
            selected.append(targets[resolved])
    if selected:
        chosen = {p.resolve() for p in selected}
        for rel in INCREMENTAL_COMPANIONS:
            companion = REPO_ROOT / rel
            if companion.exists() and companion.resolve() not in chosen:
                selected.append(companion)
    return selected


class ProjectIndex:
    """Parse-once view of the target files. A file that fails to parse
    becomes a ``parse`` finding (syntax errors are the most static bug
    of all) instead of aborting the run."""

    def __init__(self, paths: Sequence, cache=None):
        self.files: List[FileIndex] = []
        self.parse_findings: List[Finding] = []
        for p in paths:
            try:
                self.files.append(FileIndex(p, cache=cache))
            except SyntaxError as e:
                self.parse_findings.append(
                    Finding(
                        checker="parse",
                        path=self._rel(p),
                        line=int(e.lineno or 0),
                        message=f"syntax error: {e.msg}",
                        hint="the file does not parse; nothing else can be checked",
                    )
                )
            except (OSError, UnicodeDecodeError, ValueError) as e:
                # one unreadable file must not abort the whole run (a
                # full-tree scan can hit a transiently-unreadable file);
                # the CLI validates EXPLICIT paths up front instead, so a
                # typo'd argument is a usage error, not a finding
                self.parse_findings.append(
                    Finding(
                        checker="parse",
                        path=self._rel(p),
                        line=0,
                        message=f"unreadable: {e}",
                        hint="the file cannot be read; nothing can be checked",
                    )
                )
        self.by_rel: Dict[str, FileIndex] = {fi.rel: fi for fi in self.files}

    @staticmethod
    def _rel(p) -> str:
        rel = pathlib.Path(p)
        try:
            rel = rel.resolve().relative_to(REPO_ROOT)
        except ValueError:
            pass
        return rel.as_posix()

    def find(self, suffix: str) -> Optional[FileIndex]:
        for fi in self.files:
            if fi.rel.endswith(suffix):
                return fi
        return None


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]
    files_scanned: int
    checkers_run: List[str]
    duration_s: float

    @property
    def ok(self) -> bool:
        return not self.findings

    def counts_by_checker(self) -> Dict[str, int]:
        """Finding counts keyed by checker, INCLUDING zeros for every
        checker that ran — the card's lint phase records static-cleanliness
        per invariant, and an absent key must mean "did not run", never
        "ran clean"."""
        counts = {name: 0 for name in self.checkers_run}
        for f in self.findings:
            counts[f.checker] = counts.get(f.checker, 0) + 1
        return counts

    def to_json(self) -> dict:
        return {
            "findings": [dataclasses.asdict(f) for f in self.findings],
            "counts_by_checker": self.counts_by_checker(),
            "files_scanned": self.files_scanned,
            "checkers_run": self.checkers_run,
            "duration_s": round(self.duration_s, 3),
            "clean": self.ok,
        }


def run_checkers(
    index: ProjectIndex,
    checkers: Sequence[Checker],
    allowlist: Sequence = (),
    check_rot: bool = False,
) -> LintResult:
    """Run ``checkers`` over ``index``; suppress allowlisted findings;
    report stale allowlist entries when ``check_rot`` (only meaningful
    for full-registry, full-tree runs — a partial run legitimately
    leaves other checkers' entries unused)."""
    t0 = time.perf_counter()
    findings: List[Finding] = list(index.parse_findings)
    used: set = set()
    for checker in checkers:
        for f in checker.run(index):
            entry = _match_allow(allowlist, f, index)
            if entry is not None:
                used.add(id(entry))
            else:
                findings.append(f)
    if check_rot:
        for entry in allowlist:
            if id(entry) not in used:
                findings.append(
                    Finding(
                        checker="allowlist-rot",
                        path="psana_ray_tpu_torch/lint/allowlist.py",
                        line=0,
                        message=(
                            f"allowlist entry suppresses nothing: "
                            f"checker={entry.checker!r} file={entry.file!r} "
                            f"contains={entry.contains!r}"
                        ),
                        hint=(
                            "the code it excused changed or was removed — "
                            "delete the entry (allowlist rot hides the next "
                            "real finding on that line)"
                        ),
                    )
                )
    findings.sort(key=Finding.sort_key)
    return LintResult(
        findings=findings,
        files_scanned=len(index.files),
        checkers_run=[c.name for c in checkers],
        duration_s=time.perf_counter() - t0,
    )


def _match_allow(allowlist: Sequence, finding: Finding, index: ProjectIndex):
    """The entry excusing ``finding``, or None. An entry matches when the
    checker name matches, the finding's file path ends with the entry's
    ``file``, and the FLAGGED SOURCE LINE contains the entry's substring
    — the same (file suffix, line substring) contract the original
    ``_HOT_ALLOWLIST`` used, so entries stay pinned to the code they
    excuse rather than to drifting line numbers."""
    fi = index.by_rel.get(finding.path)
    if fi is None:
        return None
    text = fi.line(finding.line)
    for entry in allowlist:
        if (
            entry.checker == finding.checker
            and finding.path.endswith(entry.file)
            and entry.contains in text
        ):
            return entry
    return None
