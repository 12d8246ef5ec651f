"""The port's linter, ``psana_ray_tpu_torch.lint``, held to the JAX
package's ``psana_ray_tpu.lint`` and run over the port's own tree.

- Registry parity: the same seventeen rules, with the reference's
  descriptions.
- Fixture parity: every file of ``tests/lint_fixtures/`` through every
  rule of both linters gives the same findings, and each rule flags its
  bad fixture and passes its good one.
- The port's tree (``psana_ray_tpu_torch/`` plus ``chip_smoke.py``) is
  clean under the full registry inside the 25 s budget, with no
  allowlist rot; stale entries rot; every raw finding is one that an
  entry of the port's allowlist excuses with a written bound.
- CLI parity with ``python -m psana_ray_tpu.lint`` on the same inputs:
  exit codes 0, 1 and 2, ``--json`` keys, ``--sarif`` rule ids,
  ``--list``, ``--model`` and ``--changed``; the CLI runs with torch made
  unimportable.
- The cross-file rules on the port's real files: the wire opcodes both
  ways over tcp, evloop, workers and replication, the drain-loop and
  event-loop roots resolving and clean, the dialogue's modes, the drift
  gate anchored to the port's transport, and the protocol models equal
  to the reference's.
- The findings the linter first reported on the port stay settled, file
  by file.
"""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from psana_ray_tpu import lint as ref_lint  # noqa: E402
from psana_ray_tpu.lint.model import all_models as ref_models  # noqa: E402
from psana_ray_tpu.lint.model import explore as ref_explore  # noqa: E402
from psana_ray_tpu_torch.lint import (  # noqa: E402
    ALLOWLIST,
    Allow,
    Finding,
    ProjectIndex,
    REGISTRY,
    default_target_files,
    run_lint,
)
from psana_ray_tpu_torch.lint.core import (  # noqa: E402
    INCREMENTAL_COMPANIONS,
    PROTOCOL_COMPANIONS,
    REPO_ROOT,
    _match_allow,
    changed_target_files,
)
from psana_ray_tpu_torch.lint.flow.protocol import extract_dialogue  # noqa: E402
from psana_ray_tpu_torch.lint.model import all_models, explore  # noqa: E402
from psana_ray_tpu_torch.lint.model.checker import run_model_report  # noqa: E402
from psana_ray_tpu_torch.lint.model.drift import check_drift  # noqa: E402

PORT = REPO_ROOT / "psana_ray_tpu_torch"
FIXTURES = REPO_ROOT / "tests" / "lint_fixtures"
BUDGET_S = 25.0  # the full registry's budget, as tests/test_lint.py holds it
CHANGED_BUDGET_S = 4.0  # an incremental run's budget, as tests/test_lint.py holds it
STALE = (
    Allow("hot-alloc", "transport/tcp.py", "this line does not exist anywhere",
          why="fixture: deliberately stale"),
    Allow("lockset-inference", "transport/tcp.py", "nor does this one",
          why="fixture: deliberately stale"),
)
# the reference's one description that cites its project history (" from
# <change> <number>" before its closing parenthesis); the port's drops the
# citation and keeps the rule's text
HISTORY = re.compile(r" from [A-Za-z]+ \d+(?=\))")
CITING = {"thread-hygiene"}
# checker name -> fixture stem (rule names are kebab-case)
STEM = {name: name.replace("-", "_") for name in REGISTRY}


def _norm(text: str) -> str:
    return text.replace("psana_ray_tpu_torch", "psana_ray_tpu")


def _key(result):
    return sorted((f.checker, f.path, f.line, _norm(f.message), _norm(f.hint))
                  for f in result.findings)


def _cli(package, *args, timeout=120):
    return subprocess.run([sys.executable, "-m", f"{package}.lint", *args],
                          capture_output=True, text=True, cwd=REPO_ROOT, timeout=timeout)


@pytest.fixture(scope="module")
def full():
    """One full-registry run over the port's tree with the port's
    allowlist plus two stale entries: every module test reads it."""
    return run_lint(allowlist=(*ALLOWLIST, *STALE))


@pytest.fixture(scope="module")
def dialogue():
    d = extract_dialogue(ProjectIndex([REPO_ROOT / rel for rel in PROTOCOL_COMPANIONS]))
    assert d is not None, "the protocol companions no longer arm the dialogue"
    return d


# -- the registry ------------------------------------------------------------


def test_registry_names_equal_the_references():
    assert sorted(REGISTRY) == sorted(ref_lint.REGISTRY)
    assert len(REGISTRY) == 17


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_rule_description_is_the_references(name):
    ref = _norm(ref_lint.REGISTRY[name].description)
    want, cited = HISTORY.subn("", ref)
    assert cited == (name in CITING), ref
    assert _norm(REGISTRY[name].description) == want


# -- the fixtures --------------------------------------------------------------


@pytest.mark.parametrize("path", sorted(FIXTURES.glob("*.py")), ids=lambda p: p.name)
def test_fixture_findings_equal_the_references(path):
    ours = run_lint(paths=[path], use_allowlist=False)
    theirs = ref_lint.run_lint(paths=[path], use_allowlist=False)
    assert _key(ours) == _key(theirs)
    assert ours.checkers_run == theirs.checkers_run


def test_every_fixture_is_compared():
    assert len(list(FIXTURES.glob("*.py"))) == 50


@pytest.mark.parametrize("kind", ["bad", "good"])
@pytest.mark.parametrize("checker", sorted(REGISTRY))
def test_rule_flags_its_bad_fixture_and_passes_its_good(checker, kind):
    path = FIXTURES / f"{STEM[checker]}_{kind}.py"
    assert path.exists(), f"every rule needs a {kind} fixture: {path}"
    result = run_lint(paths=[path], checkers=[checker], use_allowlist=False)
    mine = [f for f in result.findings if f.checker == checker]
    if kind == "bad":
        assert mine, f"{checker} did not flag {path.name}"
        assert all(f.line > 0 and f.path.endswith(path.name) and f.hint for f in mine)
    else:
        assert not mine, "\n".join(f.render() for f in mine)


# -- the port's tree -------------------------------------------------------------


def test_port_tree_is_clean_under_the_full_registry(full):
    real = [f for f in full.findings
            if not (f.checker == "allowlist-rot"
                    and any(s.contains in f.message for s in STALE))]
    assert real == [], "\n".join(f.render() for f in real)
    assert set(full.checkers_run) == set(REGISTRY)
    files = sorted(PORT.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"]
    assert full.files_scanned == len(default_target_files()) == len(files)
    assert {p.resolve() for p in default_target_files()} == {p.resolve() for p in files}
    assert full.duration_s < BUDGET_S, (
        f"the full registry took {full.duration_s:.2f}s over the port's tree")


@pytest.mark.parametrize("stale", STALE, ids=[s.checker for s in STALE])
def test_a_stale_allowlist_entry_is_a_finding(full, stale):
    rot = [f for f in full.findings if f.checker == "allowlist-rot"]
    assert len(rot) == len(STALE)
    mine = [f for f in rot if stale.contains in f.message]
    assert len(mine) == 1 and stale.checker in mine[0].message


def test_every_allowlist_entry_names_its_bound():
    for entry in ALLOWLIST:
        assert entry.why.strip(), entry
        assert "bench.py" not in entry.file, entry
    with pytest.raises(ValueError, match="justification"):
        Allow("hot-alloc", "x.py", "bytes(", why="  ")


def test_duration_covers_parsing(full):
    sub = run_lint(paths=[FIXTURES / "wire_protocol_good.py"])
    assert 0 < sub.duration_s < full.duration_s


# -- the CLI ---------------------------------------------------------------------

NO_TORCH = (
    "import runpy, sys\n"
    "for name in ('torch', 'jax', 'jaxlib', 'psana_ray_tpu'):\n"
    "    sys.modules[name] = None\n"
    "sys.argv = ['lint', *sys.argv[1:]]\n"
    "try:\n"
    "    runpy.run_module('psana_ray_tpu_torch.lint', run_name='__main__')\n"
    "finally:\n"
    "    assert not [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')\n"
    "                and sys.modules[m] is not None]\n"
)


@pytest.mark.parametrize("args,rc", [
    (["--model", "--json"], 0),
    (["--json", "--checker", "undefined-name", "--checker", "hot-alloc"], 0),
    (["--sarif", "--checker", "wire-protocol", "tests/lint_fixtures/wire_protocol_good.py"], 0),
    (["--json", "--no-allowlist", "--no-cache"], 1),
], ids=["model", "subset", "sarif", "no-allowlist"])
def test_cli_runs_with_torch_unimportable(args, rc):
    out = subprocess.run([sys.executable, "-c", NO_TORCH, *args], capture_output=True,
                         text=True, cwd=REPO_ROOT, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO_ROOT)})
    assert out.returncode == rc, out.stdout[-3000:] + out.stderr[-3000:]
    payload = json.loads(out.stdout)
    if "runs" in payload:
        assert payload["runs"][0]["results"] == []
        return
    if "models" in payload:
        assert len(payload["models"]) == 5 and not payload["drift"]
        assert all(m["exhausted"] and m["violation"] is None for m in payload["models"])
        return
    if rc == 0:
        assert payload["clean"] and all(v == 0 for v in payload["counts_by_checker"].values())
        return
    # --no-allowlist: every raw finding is one an entry excuses, and every
    # entry excuses one (the run without the list is the list's whole reason)
    assert len(payload["checkers_run"]) == 17 and payload["findings"]
    index = ProjectIndex(sorted({REPO_ROOT / f["path"] for f in payload["findings"]}))
    used = set()
    for f in payload["findings"]:
        finding = Finding(**f)
        entry = _match_allow(ALLOWLIST, finding, index)
        assert entry is not None, f"raw finding no entry excuses: {finding.render()}"
        used.add(id(entry))
    assert used == {id(e) for e in ALLOWLIST}


@pytest.mark.parametrize("args,rc", [
    (["--no-allowlist", "tests/lint_fixtures/wire_protocol_bad.py"], 1),
    (["--checker", "wire-protocol", "tests/lint_fixtures/wire_protocol_good.py"], 0),
    (["--checker", "no-such-checker"], 2),
    (["no/such/file.py"], 2),
    (["--json", "--sarif", "tests/lint_fixtures/wire_protocol_good.py"], 2),
    (["--changed", "HEAD", "tests/lint_fixtures/wire_protocol_good.py"], 2),
    (["--model", "--changed", "HEAD"], 2),
    (["--changed", "no-such-ref-xyzzy"], 2),
], ids=["findings", "clean", "unknown-checker", "missing-path", "json-and-sarif",
        "changed-and-paths", "model-and-changed", "bad-ref"])
def test_cli_exit_codes_equal_the_references(args, rc):
    ours, theirs = _cli("psana_ray_tpu_torch", *args), _cli("psana_ray_tpu", *args)
    assert ours.returncode == theirs.returncode == rc, ours.stdout + ours.stderr
    if rc == 1:  # file:line renderings, the summary's timing aside
        assert _norm(ours.stdout).splitlines()[:-1] == theirs.stdout.splitlines()[:-1]
        assert "wire_protocol_bad.py:" in ours.stdout and "[wire-protocol]" in ours.stdout
    if args == ["no/such/file.py"]:
        assert "no such file" in ours.stderr


@pytest.mark.parametrize("fixture", ["wire_protocol_bad.py", "protocol_dialogue_bad.py",
                                     "hot_alloc_good.py"])
def test_cli_json_equals_the_references(fixture):
    path = f"tests/lint_fixtures/{fixture}"
    ours = json.loads(_cli("psana_ray_tpu_torch", "--json", "--no-allowlist", path).stdout)
    theirs = json.loads(_cli("psana_ray_tpu", "--json", "--no-allowlist", path).stdout)
    assert set(ours) == set(theirs) == {"findings", "counts_by_checker", "files_scanned",
                                        "checkers_run", "duration_s", "clean"}
    for key in ("counts_by_checker", "files_scanned", "checkers_run", "clean"):
        assert ours[key] == theirs[key], key
    assert json.loads(_norm(json.dumps(ours["findings"]))) == theirs["findings"]
    assert set(ours["counts_by_checker"]) == set(REGISTRY)


def test_cli_sarif_equals_the_references():
    path = "tests/lint_fixtures/wire_protocol_bad.py"
    ours = _cli("psana_ray_tpu_torch", "--sarif", "--no-allowlist", path)
    theirs = _cli("psana_ray_tpu", "--sarif", "--no-allowlist", path)
    assert ours.returncode == theirs.returncode == 1
    a, b = json.loads(ours.stdout), json.loads(theirs.stdout)
    assert a["version"] == b["version"] == "2.1.0" and a["$schema"] == b["$schema"]
    ids = [{r["id"] for r in d["runs"][0]["tool"]["driver"]["rules"]} for d in (a, b)]
    assert ids[0] == ids[1] and "wire-protocol" in ids[0]
    assert json.loads(_norm(json.dumps(a["runs"][0]["results"]))) == b["runs"][0]["results"]


def test_sarif_round_trips_findings():
    from psana_ray_tpu_torch.lint.sarif import SARIF_VERSION, findings_from_sarif, to_sarif

    result = run_lint(paths=[FIXTURES / "wire_protocol_bad.py"], checkers=["wire-protocol"],
                      use_allowlist=False)
    doc = to_sarif(result)
    assert doc["version"] == SARIF_VERSION and result.findings
    back = findings_from_sarif(doc)
    assert [(f.checker, f.path, f.line, f.message, f.hint) for f in back] == [
        (f.checker, f.path, f.line, f.message, f.hint) for f in result.findings]
    clean = run_lint(paths=[FIXTURES / "wire_protocol_good.py"], checkers=["wire-protocol"],
                     use_allowlist=False)
    assert to_sarif(clean)["runs"][0]["results"] == []


def test_cli_list_equals_the_references():
    ours, theirs = _cli("psana_ray_tpu_torch", "--list"), _cli("psana_ray_tpu", "--list")
    assert ours.returncode == theirs.returncode == 0
    assert _norm(ours.stdout) == HISTORY.sub("", theirs.stdout)
    assert len(ours.stdout.splitlines()) == 17


def test_cli_model_equals_the_references():
    ours = _cli("psana_ray_tpu_torch", "--model", "--json")
    theirs = _cli("psana_ray_tpu", "--model", "--json")
    assert ours.returncode == theirs.returncode == 0, ours.stdout + ours.stderr
    a, b = json.loads(ours.stdout), json.loads(theirs.stdout)
    assert a["drift"] == b["drift"] == []

    def shape(doc):
        return [{k: v for k, v in m.items() if k != "duration_s"} for m in doc["models"]]

    assert shape(a) == shape(b)
    assert sum(m["states"] for m in a["models"]) == 1917
    text = _cli("psana_ray_tpu_torch", "--model")
    assert text.returncode == 0 and "model: clean" in text.stdout
    assert text.stdout.count("ok, exhausted") == 5


def test_changed_mode_is_fast_and_clean():
    touched = PORT / "utils" / "metrics.py"
    result = run_lint(paths=[touched, *(REPO_ROOT / rel for rel in INCREMENTAL_COMPANIONS)],
                      use_cache=True)
    assert not result.findings, result.findings
    assert result.duration_s < CHANGED_BUDGET_S, (
        f"a changed-files run took {result.duration_s:.2f}s")


def test_changed_cli_selects_companions_and_exits_clean():
    try:
        paths = changed_target_files("HEAD")
    except RuntimeError as e:
        pytest.skip(f"no git history here: {e}")
    rels = {p.resolve().relative_to(REPO_ROOT).as_posix() for p in paths}
    assert all(r.startswith("psana_ray_tpu_torch/") or r == "chip_smoke.py" for r in rels), rels
    if rels:  # the companions ride along whenever anything is selected
        assert {"psana_ray_tpu_torch/transport/tcp.py",
                "psana_ray_tpu_torch/transport/evloop.py"} <= rels
    proc = _cli("psana_ray_tpu_torch", "--changed", "HEAD")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_parse_cache_hits_and_invalidates_on_edit(tmp_path):
    from psana_ray_tpu_torch.lint.cache import ParseCache

    target = tmp_path / "mod.py"
    target.write_text("def f():\n    return 1\n")
    cache = ParseCache(root=tmp_path / ".cache")
    src = target.read_text()
    assert cache.get(target, "mod.py", src) is None
    tree = ast.parse(src)
    cache.put(target, "mod.py", src, tree)
    hit = cache.get(target, "mod.py", src)
    assert hit is not None and ast.dump(hit) == ast.dump(tree)
    target.write_text("def f():\n    return 2\n")
    assert cache.get(target, "mod.py", target.read_text()) is None
    # the two linters key by repo-relative path: the port's files and the
    # JAX package's never share an entry
    assert cache._entry_path("psana_ray_tpu_torch/records.py") != cache._entry_path(
        "psana_ray_tpu/records.py")


# -- the cross-file rules on the port's real files ------------------------------

REAL = {
    "wire-protocol": (["wire-protocol"], ["transport/tcp.py", "transport/evloop.py",
                                          "cluster/replication.py", "transport/workers.py"]),
    "codec-decode-path": (["blocking-hot-path"], ["transport/tcp.py", "transport/codec.py",
                                                  "infeed/batcher.py"]),
    "stream-reader": (["blocking-hot-path"], ["transport/tcp.py", "infeed/batcher.py"]),
    "cluster-merge-drain": (["blocking-hot-path"], ["cluster/*.py", "infeed/batcher.py",
                                                    "transport/tcp.py"]),
    "gateway-dispatch": (["blocking-hot-path"], ["serving/*.py", "infeed/batcher.py"]),
    "autotune-actuation": (["blocking-hot-path"], ["autotune/*.py"]),
    "flame-sampler": (["blocking-hot-path", "telemetry-discipline"], ["obs/profiling/*.py"]),
    "autotune-source": (["telemetry-discipline"], ["autotune/knobs.py"]),
    "event-loop": (["event-loop-blocking"], ["transport/evloop.py", "transport/tcp.py"]),
    "follower-truncate": (["segment-lifecycle"], ["storage/log.py", "storage/segment.py",
                                                  "cluster/replication.py"]),
    "flow-layer": (["protocol-dialogue", "lockset-inference", "resource-flow"],
                   ["transport/tcp.py", "transport/evloop.py", "transport/codec.py",
                    "cluster/replication.py"]),
    # the findings the linter first reported on the port, each settled
    "entry-annotation": (["undefined-name"], ["entry.py"]),
    "stage-times-lock": (["lock-discipline"], ["utils/metrics.py"]),
    "cluster-map-guard": (["lock-discipline", "lockset-inference"], ["cluster/client.py"]),
    "put-window-dial": (["lockset-inference"], ["transport/tcp.py"]),
    "replica-link-mode": (["protocol-dialogue"], [rel.split("/", 1)[1]
                                                  for rel in PROTOCOL_COMPANIONS]),
    "frame-to-bytes": (["hot-alloc"], ["records.py", "transport/shm_ring.py"]),
    "log-reset": (["segment-lifecycle", "resource-flow"], ["storage/log.py"]),
    "lock-order": (["lock-order"], ["cluster/replication.py", "serving/gateway.py"]),
}


def _port_files(globs):
    out = []
    for g in globs:
        found = sorted(PORT.glob(g))
        assert found, f"no port file matches {g}"
        out.extend(found)
    return out


@pytest.mark.parametrize("case", sorted(REAL))
def test_port_files_scan_clean(case):
    checkers, globs = REAL[case]
    result = run_lint(paths=_port_files(globs), checkers=checkers)
    assert not result.findings, "\n".join(f.render() for f in result.findings)


def test_tracing_is_under_the_hot_alloc_screen():
    from psana_ray_tpu_torch.lint.checkers.hotalloc import HOT_MARKER

    for rel in ("obs/tracing.py", "obs/timeseries.py", "transport/evloop.py"):
        head = (PORT / rel).read_text().splitlines()[:5]
        assert any(line.strip() == HOT_MARKER for line in head), rel
    result = run_lint(paths=[PORT / "obs" / "tracing.py"], checkers=["hot-alloc"],
                      use_allowlist=False)
    assert not result.findings, result.findings


def test_sample_path_marks_the_flame_sampler():
    from psana_ray_tpu_torch.lint.checkers.telemetry import SAMPLE_MARKER

    sampler = (PORT / "obs" / "profiling" / "sampler.py").read_text()
    ref = (REPO_ROOT / "psana_ray_tpu" / "obs" / "profiling" / "sampler.py").read_text()
    assert sampler.count(SAMPLE_MARKER) >= 4
    assert sampler.count(f"  {SAMPLE_MARKER}") == ref.count(f"  {SAMPLE_MARKER}")


# 'K' and 'V' are acked inside the dispatch, with no handler of their own
IN_DISPATCH = ("_OP_STREAM_ACK", "_OP_REPL_APPEND")


@pytest.mark.parametrize("op", ["_OP_CODEC", "_OP_ANCHOR", "_OP_STREAM", "_OP_STREAM_ACK",
                                "_OP_PUT_SEQ", "_OP_PUT_WAIT", "_OP_GET_BATCH_WAIT",
                                "_OP_CLUSTER", "_OP_REPL_OPEN", "_OP_REPL_APPEND",
                                "_OP_PROMOTE", "_OP_REPLAY", "_OP_COMMIT"])
def test_opcode_is_wired_both_ways(dialogue, op):
    tree = ast.parse((PORT / "transport" / "tcp.py").read_text())
    assert any(isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
               and n.targets[0].id == op for n in tree.body), f"{op} missing from tcp.py"
    if op in IN_DISPATCH:  # answered inside the dispatch: wire-protocol's scan covers it
        assert op not in dialogue["ops"]
        return
    rec = dialogue["ops"][op]
    assert not rec["handler_missing"] and rec["senders"], op


def test_protocol_scans_without_a_companion_flag_the_asymmetry():
    tcp, evloop = PORT / "transport" / "tcp.py", PORT / "transport" / "evloop.py"
    alone = run_lint(paths=[tcp], checkers=["wire-protocol"], use_allowlist=False)
    assert any("_OP_CLUSTER" in f.message and "never matched" in f.message
               for f in alone.findings), alone.findings
    without = run_lint(paths=[tcp, evloop], checkers=["wire-protocol"], use_allowlist=False)
    asym = {f.message.split()[1] for f in without.findings
            if "no code ever sends it" in f.message}
    assert {"_OP_REPL_OPEN", "_OP_REPL_APPEND"} <= asym, without.findings


def test_companions_are_the_ports_files():
    assert set(PROTOCOL_COMPANIONS) == {
        "psana_ray_tpu_torch/transport/tcp.py", "psana_ray_tpu_torch/transport/evloop.py",
        "psana_ray_tpu_torch/transport/workers.py", "psana_ray_tpu_torch/cluster/replication.py"}
    assert set(INCREMENTAL_COMPANIONS) - set(PROTOCOL_COMPANIONS) == {
        "psana_ray_tpu_torch/infeed/batcher.py", "psana_ray_tpu_torch/infeed/fanin.py"}
    for rel in INCREMENTAL_COMPANIONS:
        assert (REPO_ROOT / rel).is_file(), rel
    from psana_ray_tpu_torch.lint.checkers.hotalloc import HOT_PATH_FILES
    from psana_ray_tpu_torch.lint.model.checker import _TRANSPORT_RELS

    for rel in (*HOT_PATH_FILES, *_TRANSPORT_RELS):
        assert rel.startswith("psana_ray_tpu_torch/") and (REPO_ROOT / rel).is_file(), rel


def test_the_dialogues_modes_are_the_references(dialogue):
    assert len(dialogue["ops"]) >= 20
    stream = dialogue["modes"]["stream"]
    assert stream["opened_by"] == "_OP_STREAM" and stream["client_attr"] == "_stream"
    assert stream["server_allowed"] == {"_OP_STREAM_ACK", "_OP_BYE", "_OP_STREAM"}
    replay = dialogue["modes"]["replay"]
    assert replay["opened_by"] == "_OP_REPLAY" and "_OP_STREAM" in replay["illegal_ops"]
    assert replay["client_attr"] == "_replay_group"
    replica = dialogue["modes"]["replica"]
    assert replica["opened_by"] == "_OP_REPL_OPEN" and replica["client_attr"] == "_stream"
    assert replica["server_allowed"] == {"_OP_REPL_APPEND", "_OP_BYE"}


def _roots():
    from psana_ray_tpu_torch.lint.checkers import blocking, evblocking

    return ([("blocking-hot-path", r) for r in sorted(blocking.ROOTS)]
            + [("event-loop-blocking", r) for r in sorted(evblocking.ROOTS)])


@pytest.fixture(scope="module")
def functions():
    from psana_ray_tpu_torch.lint.checkers.blocking import _function_table

    return _function_table(ProjectIndex(default_target_files()))


@pytest.mark.parametrize("checker,root", _roots(), ids=lambda x: x)
def test_audited_root_resolves_in_the_port(functions, checker, root):
    from psana_ray_tpu_torch.lint.checkers.blocking import ROOT_HOME

    assert root in functions, f"{checker} root {root} resolves to no function of the port"
    fi, _node = functions[root]
    if root in ROOT_HOME:
        assert fi.rel == f"psana_ray_tpu_torch/{ROOT_HOME[root]}", (root, fi.rel)


def test_drain_seeds_name_the_stream_drains():
    from psana_ray_tpu_torch.lint.checkers.blocking import SEED_EDGES

    assert "get_batch_stream" in SEED_EDGES["batches_from_queue"]
    assert "get_batch_stream" in SEED_EDGES["serve_queue"]


def test_blocking_roots_rot_is_a_finding(tmp_path):
    rot = tmp_path / "infeed" / "batcher.py"
    rot.parent.mkdir()
    rot.write_text("def something_else():\n    pass\n")
    result = run_lint(paths=[rot], checkers=["blocking-hot-path"])
    assert any("resolves to no function" in f.message for f in result.findings)
    no_roots = sorted((PORT / "lint").rglob("*.py"))
    assert len(no_roots) > 10
    result = run_lint(paths=no_roots, checkers=["blocking-hot-path"])
    assert not any("resolves to no function" in f.message for f in result.findings)


# -- the model layer -------------------------------------------------------------


def test_drift_gate_anchors_to_the_ports_transport(dialogue):
    drift = list(check_drift(dialogue, all_models(), full=True))
    assert not drift, "\n".join(m for m, _h in drift)
    from psana_ray_tpu_torch.transport import evloop

    handlers = {rec["handler"] for rec in dialogue["ops"].values()}
    assert evloop._WORKER_LOCAL_OPS
    assert {evloop._OPS[op] for op in evloop._WORKER_LOCAL_OPS} <= handlers
    results, drift = run_model_report(profile="full")
    assert not drift and len(results) == 5
    assert all(r.violation is None and r.exhausted for r in results)


MUTATIONS = [
    ("windowed", {"resend_full_tail": False}),
    ("stream", {"requeue_at_head": False}),
    ("stream", {"enforce_window": False}),
    ("stream", {"requeue_lost": False}),
    ("durable", {"commit_processed_only": False}),
    ("chain", {"ack_after_logged": False}),
    ("chain", {"self_fence_behind": False}),
    ("fencing", {"check_generation": False}),
]


@pytest.mark.parametrize("name,flip", [(m.name, {}) for m in all_models()] + MUTATIONS,
                         ids=lambda x: x if isinstance(x, str) else
                         (",".join(x) if x else "live"))
def test_model_exploration_equals_the_references(name, flip):
    ours = next(type(m) for m in all_models() if m.name == name)(**flip)
    theirs = next(type(m) for m in ref_models() if m.name == name)(**flip)
    a, b = explore(ours, profile="full"), ref_explore(theirs, profile="full")
    assert (a.states, a.transitions, a.max_depth, a.exhausted, a.violation) == (
        b.states, b.transitions, b.max_depth, b.exhausted, b.violation)
    assert [str(s) for s in a.trace or []] == [str(s) for s in b.trace or []]
    if flip:
        assert a.violation and 0 < len(a.trace) <= 20
    else:
        assert a.violation is None and a.exhausted
