"""Content-keyed parse cache for the lint CLI.

The ProjectIndex already parses each file exactly once per RUN; this
cache carries the parse across runs, keyed by the sha256 of the source
the caller ALREADY read. Content addressing is the whole design: an
earlier two-tier scheme kept a ``(size, mtime_ns)`` fast path to skip
the hash, and review found two distinct stat-vs-read races that could
pin a stale AST against newer source — for a saving of ~0.1 ms/file.
Hashing what was actually read cannot be wrong, so that is all we do.

A miss re-parses and rewrites the entry (atomic ``os.replace`` so a
crashed run never leaves a torn pickle). Entries self-invalidate on
interpreter minor-version or cache-format changes — an AST pickled by
a different grammar must never be trusted.

A warm cache loads a full tree's ASTs in about the time a cold parse
takes, so the cache exists for the INCREMENTAL path: ``--changed`` scans a handful of files, and
the warm common case (nothing changed since the last pre-commit run)
keeps the whole parse phase flat as the tree grows. It will never make
the checkers themselves faster.

The cache lives in ``<repo>/.lint_cache/`` (gitignored). Corruption is
handled by deletion: any unpickling error is a miss, never a crash.
"""

from __future__ import annotations

import ast
import hashlib
import os
import pathlib
import pickle
import sys
from typing import Optional

from psana_ray_tpu_torch.lint.core import REPO_ROOT

CACHE_VERSION = 2  # v1 carried a stat fast path; never trust its entries
DEFAULT_CACHE_DIR = REPO_ROOT / ".lint_cache"


class ParseCache:
    """get/put of parsed ASTs, keyed by repo-relative path + content."""

    def __init__(self, root: Optional[pathlib.Path] = None):
        self.root = pathlib.Path(root) if root is not None else DEFAULT_CACHE_DIR
        self.hits = 0
        self.misses = 0
        self._ready = False

    def _entry_path(self, rel: str) -> pathlib.Path:
        digest = hashlib.sha256(rel.encode()).hexdigest()[:24]
        return self.root / f"{digest}.pkl"

    @staticmethod
    def _src_sha(source: str) -> str:
        return hashlib.sha256(source.encode()).hexdigest()

    def get(self, path, rel: str, source: str) -> Optional[ast.AST]:
        """The cached tree for ``rel`` if it was parsed from exactly
        ``source`` (the bytes the caller read — no stat indirection)."""
        entry = self._entry_path(rel)
        try:
            with open(entry, "rb") as f:
                payload = pickle.load(f)
        except (OSError, pickle.UnpicklingError, EOFError, AttributeError,
                ImportError, IndexError, ValueError, TypeError):
            # ValueError/TypeError: pickle raises these too for damage
            # outside the atomic-write path (bad protocol byte, foreign
            # writer) — a corrupt entry must be a miss, never a crash
            self.misses += 1
            return None
        if (
            not isinstance(payload, dict)
            or payload.get("v") != CACHE_VERSION
            or payload.get("py") != sys.version_info[:2]
            or payload.get("src_sha") != self._src_sha(source)
        ):
            self.misses += 1
            return None
        self.hits += 1
        return payload["tree"]

    def put(self, path, rel: str, source: str, tree: ast.AST) -> None:
        """Best-effort store — a read-only checkout must not fail lint."""
        try:
            if not self._ready:
                self.root.mkdir(parents=True, exist_ok=True)
                self._ready = True
            payload = {
                "v": CACHE_VERSION,
                "py": sys.version_info[:2],
                "src_sha": self._src_sha(source),
                "tree": tree,
            }
            entry = self._entry_path(rel)
            tmp = entry.with_suffix(f".tmp{os.getpid()}")
            with open(tmp, "wb") as f:
                pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, entry)
        except OSError:
            pass
