"""blocking-hot-path: no unbounded waits reachable from the drain loop.

The consumer drain loop (``batches_from_queue`` -> batcher push ->
fan-in merge) is the stage the whole pipeline backpressures through: a
call that can block without a deadline anywhere under it stalls every
leg behind it, and — over the shm ring — a stalled consumer holding
slot leases eventually trips the wedge detector and misdiagnoses
itself as a crashed peer. The stall detector (obs/stall.py) catches
these PROBABILISTICALLY at runtime; this checker catches the idioms
statically, over a small name-based call graph.

Graph construction: module-level functions and class methods across the
scanned files, edges by bare callee name (``x.put(...)`` edges to every
indexed ``put``). That over-approximates — a false edge into clean code
costs nothing, while a missed edge would hide a real stall — with two
deliberate scope cuts:

- ``TcpQueueClient.*`` is excluded: every client wait threads an
  explicit ``deadline`` through ``_retrying``/``_reconnect`` (its own
  latency contract), which a name-based graph cannot
  see past — but ``TcpStreamReader`` (the server-push drain the
  batcher prefers) is NOT excluded: its reads must stay timeout-bounded
  socket waits with no sleeps, and the checker audits that;
- the ``pop = getattr(queue, "get_batch_stream"/"get_batch_view", ...)``
  indirection in ``batches_from_queue`` is restored with explicit seed
  edges to the transports' batch getters (stream, view, and plain).

Banned inside the reachable set: ``time.sleep`` (scheduler hold with no
transport deadline), bare ``.acquire()`` (lock wait with no timeout —
``with lock:`` micro-sections are NOT flagged; flag the explicit-wait
form where a timeout is expressible), ``.join()`` without a timeout,
and raw ``.recv(`` (an unbounded socket read; also a hot-alloc
violation). Deliberate bounded polls carry allowlist entries whose
justification names the bound the checker cannot prove.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from psana_ray_tpu_torch.lint.core import Checker, Finding, register

# root -> the file that defines it. The rot guard fires only when a
# root's HOME FILE is in the scanned set but the root no longer
# resolves there (a rename inside the file) — an incremental --changed
# scan that happens not to include serving/ or infeed/ must not read
# as rot (a >10-file diff without gateway.py false-fired the
# old whole-tree heuristic). A deleted/renamed home file still trips
# the guard on full-tree scans (the >50-file branch below).
ROOT_HOME = {
    "batches_from_queue": "infeed/batcher.py",
    "FrameBatcher.push": "infeed/batcher.py",
    "FrameBatcher.push_view": "infeed/batcher.py",
    "FrameBatcher.flush": "infeed/batcher.py",
    "FrameBatcher._emit": "infeed/batcher.py",
    "FanInPipeline._pump": "infeed/fanin.py",
    "FanInPipeline._put": "infeed/fanin.py",
    "FanInPipeline.__iter__": "infeed/fanin.py",
    "FanInPipeline.close": "infeed/fanin.py",
    # the serving gateway's dispatch loop: admission,
    # WDRR dispatch, and the transport pump sit directly on the
    # latency SLO — a sleep here IS a missed deadline
    "ServingGateway.offer": "serving/gateway.py",
    "ServingGateway.dispatch_once": "serving/gateway.py",
    "ServingGateway.run": "serving/gateway.py",
    "ServingGateway.serve_queue": "serving/gateway.py",
    # the autotune controller's actuation path: every knob
    # setter runs on the controller tick — a setter that sleeps or
    # waits unboundedly stalls tuning AND (for client-side knobs under
    # the client lock) the data path sharing that lock
    "HillClimber.tick": "autotune/controller.py",
    "KnobRegistry.apply": "autotune/knobs.py",
    # the continuous profiler's sampling loop: it runs ~97
    # times a second in EVERY pipeline process — a sleep or unbounded
    # wait here freezes the profile AND holds the GIL budget hostage
    "FlameSampler._run": "obs/profiling/sampler.py",
    "FlameSampler._sample_once": "obs/profiling/sampler.py",
}
ROOTS = set(ROOT_HOME)

# bare-name edges the getattr() transport-preference indirection hides.
# NOTE: because edges resolve by BARE callee name, the get_batch_stream
# seed reaches every indexed implementation — TcpStreamReader AND the
# cluster client's partition-merge drain (ClusterClient.get_batch_stream
# -> _merge_drain -> _pop/_sift), which is exactly the audited
# surface we want: a sleep pacing the partition sweep stalls the whole
# infeed. Pinned by the lint tests' cluster_merge_drain fixture pair.
# ServingGateway.serve_queue uses the same getattr drain-preference
# idiom as batches_from_queue, so it carries the same seeds (pinned by
# the gateway_dispatch fixture pair).
SEED_EDGES = {
    "batches_from_queue": ("get_batch", "get_batch_view", "get_batch_stream"),
    "serve_queue": ("get_batch", "get_batch_view", "get_batch_stream"),
}

EXCLUDE_PREFIXES = ("TcpQueueClient.",)

# Calls to these attrs are (nearly) always the threading/socket
# primitives themselves, not project functions — letting them create
# edges makes `t.join(timeout=5.0)` pull in any project method that
# happens to be NAMED join (a false edge straight into foreground
# blocking APIs). The primitives are what _banned_calls inspects at the
# call site instead.
EDGE_STOP = {"join", "acquire", "sleep", "recv", "recv_into"}


def _function_table(index) -> Dict[str, Tuple[object, ast.AST]]:
    """qualname -> (FileIndex, node) for module functions + class methods."""
    table = {}
    for fi in index.files:
        for node in fi.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                table.setdefault(node.name, (fi, node))
            elif isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        table.setdefault(f"{node.name}.{m.name}", (fi, m))
    return table


def _callees(node: ast.AST) -> Set[str]:
    out = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            if isinstance(n.func, ast.Name):
                out.add(n.func.id)
            elif isinstance(n.func, ast.Attribute):
                out.add(n.func.attr)
    return out


def _sleep_names(fi) -> Tuple[Set[str], Set[str]]:
    """(module aliases for `time`, bare names bound to `time.sleep`) —
    `from time import sleep` / `import time as t` must not make the
    stall idiom invisible. Memoized per FileIndex: this walks the whole
    file and is asked once per REACHABLE function (measured
    dominating the checker on the big transport modules)."""
    cached = getattr(fi, "_sleep_names_memo", None)
    if cached is not None:
        return cached
    time_aliases, bare = {"time"}, set()
    for node in ast.walk(fi.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "time":
                    time_aliases.add(alias.asname or "time")
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                if alias.name == "sleep":
                    bare.add(alias.asname or "sleep")
    fi._sleep_names_memo = (time_aliases, bare)
    return time_aliases, bare


def _banned_calls(node: ast.AST, time_aliases: Set[str], bare_sleeps: Set[str]) -> List[Tuple[int, str]]:
    out = []
    for n in ast.walk(node):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        if isinstance(f, ast.Name) and f.id in bare_sleeps:
            out.append((n.lineno, "sleep() holds the drain loop with no transport deadline"))
            continue
        if not isinstance(f, ast.Attribute):
            continue
        # for join(), the first positional IS the timeout; for acquire(),
        # it is `blocking` — acquire(True) is the unbounded wait itself,
        # so only a 2nd positional / timeout= kwarg bounds it
        has_timeout = bool(n.args) or any(
            kw.arg == "timeout" for kw in n.keywords
        )
        if f.attr == "sleep" and isinstance(f.value, ast.Name) and f.value.id in time_aliases:
            out.append((n.lineno, "time.sleep() holds the drain loop with no transport deadline"))
        elif f.attr == "acquire":
            nonblocking = (
                n.args
                and isinstance(n.args[0], ast.Constant)
                and n.args[0].value is False
            ) or any(
                kw.arg == "blocking"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is False
                for kw in n.keywords
            )
            bounded = len(n.args) >= 2 or any(
                kw.arg == "timeout" for kw in n.keywords
            )
            if not nonblocking and not bounded:
                out.append((n.lineno, "blocking .acquire() — lock wait with no timeout"))
        elif f.attr == "join" and not has_timeout:
            out.append((n.lineno, ".join() without a timeout"))
        elif f.attr == "recv":
            out.append((n.lineno, "raw .recv() — unbounded socket read"))
    return out


@register
class BlockingHotPathChecker(Checker):
    name = "blocking-hot-path"
    description = (
        "no time.sleep / bare .acquire() / unbounded join / raw recv in "
        "functions reachable from the batcher / fan-in drain loop"
    )

    def run(self, index):
        table = _function_table(index)
        # roots rot: a hard-coded root that no longer resolves silently
        # degrades the checker to a no-op — the exact rot class the
        # allowlist machinery guards against. Surface it — but only
        # when the root's HOME FILE is in the scanned set (a rename
        # inside it), or on a full-tree scan where the home file itself
        # vanished; an incremental scan that merely excludes the file
        # is not rot.
        scanned = {fi.rel for fi in index.files}
        for root in sorted(ROOTS - set(table)):
            home = ROOT_HOME[root]
            home_scanned = any(rel.endswith(home) for rel in scanned)
            if not home_scanned and len(index.files) <= 50:
                continue  # incremental scan without the home file
            fi = index.find("lint/checkers/blocking.py")
            yield Finding(
                checker=self.name,
                path=fi.rel if fi else "psana_ray_tpu_torch/lint/checkers/blocking.py",
                line=0,
                message=f"drain-loop root {root!r} resolves to no "
                f"function in the scanned tree — the checker is "
                f"silently covering less than it claims",
                hint="the root was renamed or removed: update ROOT_HOME "
                "(and SEED_EDGES) in this module to match",
            )
        by_bare: Dict[str, List[str]] = {}
        for qual in table:
            by_bare.setdefault(qual.rsplit(".", 1)[-1], []).append(qual)

        # BFS from the roots, remembering one call path for the message
        via: Dict[str, str] = {}
        frontier = [q for q in table if q in ROOTS]
        for q in frontier:
            via[q] = q
        while frontier:
            nxt = []
            for qual in frontier:
                fi, node = table[qual]
                names = _callees(node) - EDGE_STOP
                names |= set(SEED_EDGES.get(qual.rsplit(".", 1)[-1], ()))
                for bare in names:
                    for callee in by_bare.get(bare, ()):
                        if callee in via or callee.startswith(EXCLUDE_PREFIXES):
                            continue
                        via[callee] = f"{via[qual]} -> {callee}"
                        nxt.append(callee)
            frontier = nxt

        for qual, path in sorted(via.items()):
            fi, node = table[qual]
            time_aliases, bare_sleeps = _sleep_names(fi)
            for lineno, what in _banned_calls(node, time_aliases, bare_sleeps):
                yield Finding(
                    checker=self.name, path=fi.rel, line=lineno,
                    message=f"{what} inside {qual} (reachable: {path})",
                    hint="use the timeout-bearing variant (get_wait/put_wait"
                    "/Queue ops with timeout=, acquire(timeout=), join(t)); "
                    "a deliberate bounded poll needs an allowlist entry "
                    "naming the bound",
                )
