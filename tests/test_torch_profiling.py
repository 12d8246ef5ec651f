"""The port's continuous profiler and event-loop telemetry against the JAX
package's.

The same inputs, made from a numpy seed, go through both packages, equal
unless a tolerance is given: the stage vocabulary; ``StackTrie`` over the
same frames (rows, hot frames, stage totals, overflow at a small
``max_nodes``) and its collapsed and speedscope exports; a spool written
by each package and loaded by the other; ``prof_merge`` of a mixed pair of
spools with far-apart monotonic epochs; ``ProfTelemetry.tick_cost_model``
over scripted counters (rtol 1e-12); ``EvLoopTelemetry`` over the same
passes. Then the port alone, as the JAX package's own tests hold it: the
sampler allocates nothing once warm, tells on-CPU from waiting, costs
little, and on a live relay bills at least 0.8 of its on-CPU samples to
known stages. The port's loop carries the ``dispatch`` tag through its
``select``, where the JAX loop clears it first: a scripted idle loop
shows the documented difference.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from psana_ray_tpu.obs import prof_merge as jax_merge  # noqa: E402
from psana_ray_tpu.obs import profiling as jax_prof  # noqa: E402
from psana_ray_tpu.obs.profiling import export as jax_export  # noqa: E402
from psana_ray_tpu.obs.registry import federation_payload as jax_payload  # noqa: E402
from psana_ray_tpu.obs.stages import STAGES as JAX_STAGES  # noqa: E402
from psana_ray_tpu.transport import evloop as jax_evloop  # noqa: E402
from psana_ray_tpu_torch.infeed.batcher import batches_from_queue  # noqa: E402
from psana_ray_tpu_torch.obs import prof_merge, profiling  # noqa: E402
from psana_ray_tpu_torch.obs.flight import FlightRecorder  # noqa: E402
from psana_ray_tpu_torch.obs.profiling import export  # noqa: E402
from psana_ray_tpu_torch.obs.profiling import stagetag  # noqa: E402
from psana_ray_tpu_torch.obs.registry import MetricsRegistry, federation_payload  # noqa: E402
from psana_ray_tpu_torch.obs.stages import STAGES  # noqa: E402
from psana_ray_tpu_torch.records import EndOfStream, FrameRecord, decode  # noqa: E402
from psana_ray_tpu_torch.transport import evloop  # noqa: E402
from psana_ray_tpu_torch.transport.ring import RingBuffer  # noqa: E402
from psana_ray_tpu_torch.transport.tcp import TcpQueueClient, TcpQueueServer  # noqa: E402
from torch_parity import _no_lingering_child, one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"port": profiling, "jax": jax_prof}


@pytest.fixture(autouse=True)
def _no_default_profiler():
    """Each test starts and ends with both packages' default samplers off."""
    for pkg in PKGS.values():
        pkg.stop_default_profiler()
    yield
    for pkg in PKGS.values():
        pkg.stop_default_profiler()


# -- the vocabulary ----------------------------------------------------------
def test_the_tag_vocabulary_is_the_jax_one_and_both_stage_lists():
    assert stagetag.TAG_NAMES == jax_prof.TAG_NAMES
    assert tuple(stagetag.TAG_NAMES[1:]) == tuple(STAGES) == tuple(JAX_STAGES)
    assert stagetag.TAG_OF_STAGE == jax_prof.TAG_OF_STAGE
    assert stagetag.N_TAGS == jax_prof.N_TAGS == len(STAGES) + 1
    for name in ("UNTAGGED", "ENQUEUE", "QUEUE_DWELL", "DEQUEUE", "BATCH", "DEVICE_PUT",
                 "DISPATCH"):
        assert getattr(stagetag, f"TAG_{name}") == getattr(jax_prof, f"TAG_{name}")


def test_swap_restore_and_nested_regions():
    assert stagetag.current_tag() == stagetag.TAG_UNTAGGED
    prev = stagetag.swap_stage(stagetag.TAG_BATCH)
    assert prev == stagetag.TAG_UNTAGGED and stagetag.current_tag() == stagetag.TAG_BATCH
    stagetag.set_stage(prev)
    with stagetag.stage_region("batch"):
        with stagetag.stage_region("device_put"):
            assert stagetag.current_tag() == stagetag.TAG_DEVICE_PUT
        assert stagetag.current_tag() == stagetag.TAG_BATCH
    assert stagetag.current_tag() == stagetag.TAG_UNTAGGED
    calls = []

    class Inner:
        def __enter__(self):
            calls.append("enter")

        def __exit__(self, *exc):
            calls.append("exit")
            return False

    with stagetag.stage_region("no_such_stage", Inner()):
        assert stagetag.current_tag() == stagetag.TAG_UNTAGGED
    assert calls == ["enter", "exit"]
    stagetag.clear_thread()


# -- the trie and its exports --------------------------------------------------
def _leaf(n, fn):
    return fn(sys._getframe()) if n == 0 else _mid(n - 1, fn)


def _mid(n, fn):
    return fn(sys._getframe()) if n == 0 else _leaf(n - 1, fn)


def _side(n, fn):
    return fn(sys._getframe()) if n == 0 else _side(n - 1, fn)


def _twin_tries(seed, max_nodes, max_depth, n=200):
    """A port and a JAX trie fed the same frames, on-CPU flags and tags."""
    rng = np.random.default_rng(seed)
    ours = profiling.StackTrie(max_nodes=max_nodes, max_depth=max_depth)
    theirs = jax_prof.StackTrie(max_nodes=max_nodes, max_depth=max_depth)
    for _ in range(n):
        on = bool(rng.integers(0, 4))
        tag = int(rng.integers(0, stagetag.N_TAGS))
        entry = (_leaf, _side)[int(rng.integers(0, 2))]

        def fold(frame):
            ours.sample(frame, on, tag)
            theirs.sample(frame, on, tag)

        entry(int(rng.integers(0, 7)), fold)
    return ours, theirs


@pytest.mark.parametrize("seed,max_nodes,max_depth", [(0, 8192, 64), (1, 8192, 64),
                                                      (2, 16, 16), (3, 11, 8)])
def test_the_trie_folds_as_the_jax_trie(seed, max_nodes, max_depth):
    ours, theirs = _twin_tries(seed, max_nodes, max_depth)
    assert ours.rows() == theirs.rows()
    assert ours.hot_frames(8) == theirs.hot_frames(8)
    assert ours.stage_totals() == theirs.stage_totals()
    for k in ("samples_total", "on_cpu_total", "waiting_total", "overflow_total", "n_nodes"):
        assert getattr(ours, k) == getattr(theirs, k), k
    if max_nodes < 20:
        assert ours.overflow_total > 0 and ours.n_nodes <= max(max_nodes, stagetag.N_TAGS + 1)


@pytest.mark.parametrize("seed", range(3))
def test_collapsed_and_speedscope_exports_match_the_jax_exports(seed):
    ours, theirs = _twin_tries(seed, 8192, 64)
    for waiting in (False, True):
        lines = export.collapsed_lines(ours, waiting=waiting)
        assert lines == jax_export.collapsed_lines(theirs, waiting=waiting)
        assert export.parse_collapsed(lines) == jax_export.parse_collapsed(lines)
        assert sum(c for _, c in export.parse_collapsed(lines)) == (
            ours.waiting_total if waiting else ours.on_cpu_total)
        assert (export.speedscope_doc(ours, name="u", waiting=waiting)
                == jax_export.speedscope_doc(theirs, name="u", waiting=waiting))


def test_the_trie_is_allocation_free_in_steady_state():
    trie = profiling.StackTrie()
    f = sys._getframe()
    for _ in range(200):
        trie.sample(f, True, stagetag.TAG_BATCH)
        trie.sample(f, False, stagetag.TAG_UNTAGGED)
    before = sys.getallocatedblocks()
    for _ in range(10_000):
        trie.sample(f, True, stagetag.TAG_BATCH)
    grew = sys.getallocatedblocks() - before
    assert grew <= 16, f"trie.sample allocated ({grew} blocks / 10k samples)"
    assert trie.samples_total == 10_400


def test_the_sampling_pass_is_allocation_free_in_steady_state():
    s = profiling.FlameSampler(hz=97.0, process="pin", register=False)
    s._own_ident = -1  # sample the calling thread too
    for _ in range(50):
        s._sample_once()
    before = sys.getallocatedblocks()
    for _ in range(1000):
        s._sample_once()
    grew = sys.getallocatedblocks() - before
    s._close_fds()
    assert grew <= 16, f"_sample_once allocated ({grew} blocks / 1k calls)"


def test_a_full_trie_bills_the_deepest_prefix():
    trie = profiling.StackTrie(max_nodes=stagetag.N_TAGS + 2, max_depth=16)
    for _ in range(8):
        _side(10, lambda f: trie.sample(f, True, stagetag.TAG_UNTAGGED))
    assert trie.n_nodes <= stagetag.N_TAGS + 2 and trie.overflow_total > 0
    assert trie.samples_total == 8
    with pytest.raises(ValueError):
        profiling.FlameSampler(hz=0.0)


# -- spools and the merge ---------------------------------------------------------
def _sampler(pkg, process, wall0, mono0, seed):
    """An unstarted sampler of ``pkg`` with seeded samples, three copies
    of one anchor (the median's, beside the spool's dump-time anchor) and
    two cpu_frac ticks."""
    s = pkg.FlameSampler(hz=97.0, process=process, register=False)
    rng = np.random.default_rng(seed)
    for _ in range(40):
        on, tag = bool(rng.integers(0, 3)), int(rng.integers(0, stagetag.N_TAGS))
        _leaf(int(rng.integers(0, 5)), lambda f: s.trie.sample(f, on, tag))
    s.start_wall, s.start_mono = wall0, mono0
    s.anchors.extend({"wall": wall0, "mono": mono0} for _ in range(3))
    s.telemetry.cpu_series.append(mono0 + 1.0, 0.5)
    s.telemetry.cpu_series.append(mono0 + 2.0, 0.75)
    return s


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_spool_of_either_package_loads_in_the_other(writer, tmp_path):
    s = _sampler(PKGS[writer], "unit", 1000.0, 100.0, seed=5)
    write = export.write_spool if writer == "port" else jax_export.write_spool
    path = write(s, directory=str(tmp_path))
    assert os.path.basename(path) == f"unit-{os.getpid()}.prof.json"
    assert os.listdir(tmp_path) == [os.path.basename(path)]  # no temporary file left
    ours, theirs = export.load_spool(path), jax_export.load_spool(path)
    assert ours == theirs
    other = _sampler(PKGS["jax" if writer == "port" else "port"], "unit", 1000.0, 100.0, 5)
    doc = (jax_export if writer == "port" else export).spool_doc(other)
    assert set(doc) == set(ours) and set(doc["meta"]) == set(ours["meta"])
    assert set(doc["totals"]) == set(ours["totals"])
    assert ours["stacks"] == doc["stacks"] and ours["stage_totals"] == doc["stage_totals"]
    assert ours["totals"]["samples"] == 40 and len(ours["anchors"]) == 4
    bogus = tmp_path / "x.prof.json"
    bogus.write_text("{}")
    for load in (export.load_spool, jax_export.load_spool):
        with pytest.raises(ValueError):
            load(str(bogus))


def _mixed_pair(tmp_path):
    """A port spool and a JAX spool whose monotonic clocks started 4900 s
    apart while their wall clocks agree within a second."""
    a = _sampler(profiling, "producer", 1000.0, 100.0, seed=1)
    b = _sampler(jax_prof, "queue_server", 1001.0, 5000.0, seed=2)
    pa = export.write_spool(a, path=str(tmp_path / "producer-11.prof.json"))
    pb = jax_export.write_spool(b, path=str(tmp_path / "queue_server-22.prof.json"))
    return pa, pb


def test_both_merges_give_the_same_document_on_one_timeline(tmp_path):
    _mixed_pair(tmp_path)
    ours = prof_merge.merge([str(tmp_path)])
    assert ours == jax_merge.merge([str(tmp_path)])
    assert prof_merge.merged_collapsed([str(tmp_path)]) == jax_merge.merged_collapsed(
        [str(tmp_path)])
    assert prof_merge.merged_speedscope([str(tmp_path)]) == jax_merge.merged_speedscope(
        [str(tmp_path)])
    prof = ours["profile"]
    assert len(prof["processes"]) == 2 and prof["samples_total"] == 80
    counters = [e for e in ours["traceEvents"] if e.get("ph") == "C"]
    assert len(counters) == 4
    by_pid = {}
    for e in counters:
        by_pid.setdefault(e["pid"], []).append(e["ts"])
    first_a, first_b = (min(ts) for ts in by_pid.values())
    assert abs(first_a - first_b) < 5e6  # the wall clocks, not the 4900 s of monotonic epochs
    assert {e["args"]["name"] for e in ours["traceEvents"] if e.get("ph") == "M"} == {
        f"prof producer:{os.getpid()}", f"prof queue_server:{os.getpid()}"}


def test_the_merge_command_writes_every_artifact(tmp_path, capsys):
    spools = tmp_path / "spools"
    spools.mkdir()
    _mixed_pair(spools)
    out, folded, ss = tmp_path / "m.json", tmp_path / "c.folded", tmp_path / "c.ss.json"
    assert prof_merge.main([str(spools), "--out", str(out), "--collapsed", str(folded),
                            "--speedscope", str(ss)]) == 0
    assert json.loads(out.read_text())["profile"]["samples_total"] == 80
    assert folded.read_text().splitlines() == prof_merge.merged_collapsed([str(spools)])
    assert json.loads(ss.read_text())["profiles"][0]["endValue"] == sum(
        int(ln.rsplit(" ", 1)[1]) for ln in folded.read_text().splitlines())
    assert "merged 2 process profile(s)" in capsys.readouterr().out
    assert prof_merge.main([str(tmp_path / "empty")]) == 1


# -- the cost model and the loop's telemetry ------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_the_cost_model_matches_the_jax_cost_model(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    clock = {"cpu": 1.0, "frames": 0, "bytes": 0}

    class Times:
        @property
        def user(self):
            return 0.25 * clock["cpu"]

        @property
        def system(self):
            return 0.75 * clock["cpu"]

    monkeypatch.setattr(os, "times", lambda: Times())
    tels = [pkg.ProfTelemetry(frames_fn=lambda: clock["frames"],
                              bytes_fn=lambda: clock["bytes"]) for pkg in PKGS.values()]
    now = 10.0
    for _ in range(12):
        for tel in tels:
            tel.tick_cost_model(now=now)
        a, b = tels
        for k in ("cpu_frac", "cpu_ns_per_frame", "py_bytes_per_frame"):
            assert getattr(a, k) == pytest.approx(getattr(b, k), rel=1e-12, abs=0.0), k
        assert a.frames_seen == b.frames_seen and a.ticks_total == b.ticks_total
        now += float(rng.uniform(0.5, 1.5))
        clock["cpu"] += float(rng.uniform(0.0, 1.2))
        clock["frames"] += int(rng.integers(0, 400))
        clock["bytes"] += int(rng.integers(0, 1 << 24))
    assert a.cpu_timeline() == b.cpu_timeline() and len(a.cpu_timeline()) == 12
    assert a.snapshot() == b.snapshot()


def test_the_cost_model_measures_a_burn_and_registers_the_prof_source():
    frames = [0]
    tel = profiling.ProfTelemetry(frames_fn=lambda: frames[0], bytes_fn=lambda: 1 << 20)
    tel.tick_cost_model(now=10.0)
    deadline = time.process_time() + 0.08
    while time.process_time() < deadline:
        pass
    frames[0] = 200
    tel.tick_cost_model(now=11.0)
    assert tel.cpu_frac > 0.0 and tel.cpu_ns_per_frame > 0.0
    reg = MetricsRegistry.default()
    assert "prof" not in reg.snapshot()
    s = profiling.start_default_profiler(hz=50.0, process="unit")
    assert profiling.default_profiler() is s
    assert profiling.start_default_profiler(hz=999.0) is s  # idempotent
    assert reg.snapshot()["prof"]["enabled"] == 1 and reg.snapshot()["prof"]["hz"] == 50.0
    profiling.stop_default_profiler()
    assert "prof" not in reg.snapshot() and profiling.default_profiler() is None


@pytest.mark.parametrize("seed", range(4))
def test_the_loop_telemetry_matches_the_jax_loop_telemetry(seed):
    rng = np.random.default_rng(seed)
    ours, theirs = evloop.EvLoopTelemetry(), jax_evloop.EvLoopTelemetry()
    assert ours.stats() == theirs.stats() and ours.stats()["busy_frac"] == 0.0
    for _ in range(300):
        op = int(rng.integers(0, 6))
        lag = float(rng.uniform(0, 5))
        dispatch_ms, select_ms = float(rng.exponential(0.3)), float(rng.exponential(2.0))
        for t in (ours, theirs):
            if op == 0:
                t.conn_opened()
            elif op == 1:
                t.conn_closed()
            elif op == 2:
                t.refused()
            elif op == 3:
                t.timer_lag(lag)
            else:
                t.loop_pass(dispatch_ms, select_ms=select_ms)
        assert ours.stats() == theirs.stats()
    s = ours.stats()
    assert 0.0 < s["busy_frac"] < 1.0 and 0.0 < s["busy_frac_ewma"] < 1.0
    one = evloop.EvLoopTelemetry()
    one.loop_pass(10.0, select_ms=10.0)
    one.loop_pass(30.0, select_ms=0.0)
    assert one.stats()["busy_frac"] == pytest.approx(0.8)


# -- the surfaces ----------------------------------------------------------------------
def test_the_hooks_are_none_while_the_profiler_is_off(tmp_path):
    for pkg in PKGS.values():
        assert pkg.profile_top() is None and pkg.profile_summary() is None
    assert federation_payload()["profile"] is None
    fl = FlightRecorder()
    path = fl.dump("off", path=str(tmp_path / "off.json"), force=True)
    assert json.loads(open(path).read())["profile_top"] is None


def test_the_payload_and_the_dump_carry_the_jax_blocks_while_it_runs(tmp_path):
    from psana_ray_tpu.obs.flight import FlightRecorder as JaxFlight

    for pkg in PKGS.values():
        pkg.start_default_profiler(hz=97.0, process="surface")
    stop = threading.Event()

    def burn():
        stagetag.set_stage(stagetag.TAG_BATCH)
        while not stop.is_set():
            pass

    burner = threading.Thread(target=burn, daemon=True)
    burner.start()
    time.sleep(0.4)
    stop.set()
    burner.join(timeout=5)
    ours, theirs = federation_payload()["profile"], jax_payload()["profile"]
    assert ours is not None and set(ours) == set(theirs) and ours["hz"] == 97.0
    assert ours["samples"] > 0 and ours["hot"] and set(ours["hot"][0]) == set(theirs["hot"][0])
    json.dumps(ours)
    docs = {}
    for name, cls in (("port", FlightRecorder), ("jax", JaxFlight)):
        path = cls().dump("on", path=str(tmp_path / f"{name}.json"), force=True)
        docs[name] = json.loads(open(path).read())["profile_top"]
    assert set(docs["port"]) == set(docs["jax"]) and docs["port"]["samples"] > 0
    assert docs["port"]["hot"] and "batch" in docs["port"]["stage_cpu_ms"]


def test_the_shared_flags_and_the_four_programs():
    p = argparse.ArgumentParser()
    profiling.add_profile_args(p)
    a = p.parse_args([])
    assert a.profile_hz == profiling.DEFAULT_HZ == jax_prof.DEFAULT_HZ and a.profile_dir is None
    assert profiling.configure_profiling_from_args(p.parse_args(["--profile_hz", "0"])) is None
    s = profiling.configure_profiling_from_args(p.parse_args(["--profile_hz", "53"]),
                                                process="unit")
    assert s is not None and s.hz == 53.0 and s.running
    profiling.stop_default_profiler()
    q = argparse.ArgumentParser()
    q.add_argument("--profile_dir", default="existing")
    profiling.add_profile_args(q)
    assert q.parse_args([]).profile_dir == "existing"
    for mod in ("producer.py", "consumer.py", "queue_server.py", "sfx.py"):
        src = open(os.path.join(REPO, "psana_ray_tpu_torch", mod)).read()
        assert "add_profile_args(" in src and "configure_profiling_from_args(" in src, mod


def test_the_queue_server_help_advertises_the_flags():
    out = subprocess.run([sys.executable, "-m", "psana_ray_tpu_torch.queue_server", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=60,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0
    assert "--profile_hz" in out.stdout and "--profile_dir" in out.stdout


# -- the sampler on live threads -------------------------------------------------------
def test_on_cpu_and_waiting_threads_are_told_apart():
    stop = threading.Event()

    def burner():
        stagetag.set_stage(stagetag.TAG_BATCH)
        x = 0
        while not stop.is_set():
            x += 1

    def sleeper():
        stagetag.set_stage(stagetag.TAG_DEVICE_PUT)
        stop.wait(5.0)

    s = profiling.FlameSampler(hz=97.0, process="disc", register=False)
    threads = [threading.Thread(target=f, daemon=True) for f in (burner, sleeper)]
    for t in threads:
        t.start()
    s.start()
    time.sleep(1.5)
    s.stop(write_spool=False)
    stop.set()
    for t in threads:
        t.join(timeout=5)
    totals = s.trie.stage_totals()
    burn = totals.get("batch", {"on": 0, "off": 0})
    slp = totals.get("device_put", {"on": 0, "off": 0})
    assert burn["on"] + burn["off"] >= 50
    assert burn["on"] > 0.6 * (burn["on"] + burn["off"]), totals
    assert slp["off"] > 0.6 * (slp["on"] + slp["off"]), totals
    assert s.trie.samples_total == s.trie.on_cpu_total + s.trie.waiting_total


def test_sampling_costs_within_the_unit_test_bound():
    payload = np.random.default_rng(0).integers(0, 1000, (4, 64, 64), dtype=np.uint16)

    def work():
        t0 = time.perf_counter()
        for i in range(300):
            decode(FrameRecord(0, i, payload, 9.0).to_bytes())
        return time.perf_counter() - t0

    work()
    base = min(work() for _ in range(5))
    s = profiling.FlameSampler(hz=97.0, process="ab", register=False).start()
    try:
        prof = min(work() for _ in range(5))
    finally:
        s.stop(write_spool=False)
    assert s.trie.samples_total > 0
    assert prof <= base * 1.25 + 0.05, (base, prof)


def test_a_sampler_spool_merges(tmp_path):
    s = profiling.FlameSampler(hz=97.0, process="e2e", spool_dir=str(tmp_path),
                               register=False).start()
    stop = threading.Event()

    def burner():
        stagetag.set_stage(stagetag.TAG_BATCH)
        while not stop.is_set():
            pass

    t = threading.Thread(target=burner, daemon=True)
    t.start()
    time.sleep(0.6)
    stop.set()
    t.join(timeout=5)
    s.stop()
    for merge in (prof_merge.merge, jax_merge.merge):
        prof = merge([str(tmp_path)])["profile"]
        assert [p["process"] for p in prof["processes"]] == [f"e2e:{os.getpid()}"]
        assert prof["samples_total"] == s.trie.samples_total > 0
        assert "batch" in prof["stage_cpu_ms"] and prof["hot"]


@pytest.mark.parametrize("pkg,column", [("port", "off"), ("jax", "on")])
def test_a_thread_enumerate_does_not_list_bills_waiting_not_on_cpu(pkg, column):
    """A thread started by ``_thread.start_new_thread`` (pytest-xdist's
    receiver thread is one) has no native id the sampler can find, so no
    stat descriptor. The JAX sampler counts it on-CPU at every sample, a
    blocked thread included; the port's counts it waiting."""
    import _thread

    stop, seen = threading.Event(), []

    def hidden():
        seen.append(threading.get_ident())
        stop.wait(10.0)

    _thread.start_new_thread(hidden, ())
    while not seen:
        time.sleep(0.01)
    time.sleep(0.05)  # blocked in the wait
    s = PKGS[pkg].FlameSampler(hz=97.0, process="hidden", register=False)
    try:
        for _ in range(10):
            s._sample_once()
        rows = [r for r in s.trie.rows() if any("hidden" in fr for fr in r["frames"])]
    finally:
        stop.set()
        for info in s._threads.values():
            if info[0] >= 0:
                os.close(info[0])
    assert sum(r[column] for r in rows) == 10, rows
    if pkg == "port":
        assert seen[0] in s.untracked_threads()


# -- the select fault ----------------------------------------------------------------------
def _loop_rows(server_cls, ring_cls, sampler_cls, on_cpu):
    """Sample an idle server's loop thread while it waits in select, the
    sampler told (scripted) that the thread's CPU time did or did not
    advance since its last sample; the loop thread's rows."""
    srv = server_cls(ring_cls(8), host="127.0.0.1").serve_background()
    try:
        deadline = time.monotonic() + 10.0
        loop = None
        while loop is None:
            assert time.monotonic() < deadline, "the loop never reached select"
            for ident, f in sys._current_frames().items():
                codes, g = [], f
                while g is not None:
                    codes.append(g.f_code)
                    g = g.f_back
                if codes[0].co_name == "select" and any(
                        c.co_name == "run" and c.co_filename.endswith("evloop.py") for c in codes):
                    loop = ident
            time.sleep(0.01)
        s = sampler_cls(hz=97.0, process="loop", register=False)
        s._thread_on_cpu = lambda ident: on_cpu
        for _ in range(5):
            s._sample_once()
    finally:
        srv.shutdown()
    return [r for r in s.trie.rows() if any("EventLoop.run" in fr for fr in r["frames"])]


@pytest.mark.parametrize("on_cpu", [True, False], ids=["ticks_rose", "ticks_flat"])
def test_an_idle_loop_bills_dispatch_where_the_jax_loop_bills_untagged(on_cpu):
    """The sampler bills a sample to the stack and tag of its moment and
    calls it on-CPU when the thread's CPU ticks rose since the previous
    sample: the JAX loop clears its tag before select, so the CPU a pass
    spent bills to "untagged, in select". The port's loop keeps
    "dispatch" through select: the same samples bill to dispatch, and
    the dispatch row's waiting column holds the loop's select waits."""
    from psana_ray_tpu.transport.ring import RingBuffer as JaxRing
    from psana_ray_tpu.transport.tcp import TcpQueueServer as JaxServer

    col = "on" if on_cpu else "off"
    rows = {"port": _loop_rows(TcpQueueServer, RingBuffer, profiling.FlameSampler, on_cpu),
            "jax": _loop_rows(JaxServer, JaxRing, jax_prof.FlameSampler, on_cpu)}
    for pkg, stage in (("port", "dispatch"), ("jax", "untagged")):
        sel = [r for r in rows[pkg] if r["frames"][-1].split(":")[1].endswith("select")]
        assert sel and all(r["stage"] == stage and r[col] > 0 for r in sel), (pkg, rows[pkg])
    assert all(r["stage"] == "dispatch" for r in rows["port"]), rows["port"]


def test_most_busy_samples_of_a_live_relay_bill_to_known_stages():
    """producer thread -> the port's TCP queue server (its loop) -> a
    streamed drain through ``batches_from_queue``, profiled end to end: at
    least 0.8 of the on-CPU samples carry a stage (the JAX bound)."""
    records = [FrameRecord(0, i, np.full((8, 128, 128), i % 7, np.uint16), 9.0)
               for i in range(300)]
    n = len(records) * 5
    srv = TcpQueueServer(RingBuffer(64), host="127.0.0.1").serve_background()
    sampler = profiling.FlameSampler(hz=97.0, process="relay", register=False)

    def produce():
        c = TcpQueueClient("127.0.0.1", srv.port)
        try:
            for i in range(n):
                if not c.put_wait(records[i % len(records)], timeout=30):
                    return
            c.put_wait(EndOfStream(total_events=n), timeout=30)
        finally:
            c.disconnect()

    consumer = TcpQueueClient("127.0.0.1", srv.port)
    sampler.start()
    prod = threading.Thread(target=produce, daemon=True)
    prod.start()
    seen = 0
    try:
        for batch in batches_from_queue(consumer, batch_size=16, max_wait_s=60):
            seen += batch.num_valid
    finally:
        sampler.stop(write_spool=False)
        prod.join(timeout=30)
        consumer.disconnect()
        srv.shutdown()
    assert seen == n
    totals = sampler.trie.stage_totals()
    on_known = sum(t["on"] for name, t in totals.items() if name != "untagged")
    on_total = sampler.trie.on_cpu_total
    assert on_total >= 20, f"too few busy samples to judge: {totals}"
    untagged = [(r["on"], r["frames"][-3:]) for r in sampler.trie.rows()
                if r["stage"] == "untagged" and r["on"]]
    print(f"attributed {on_known}/{on_total}; untagged on-CPU rows {untagged}")  # pytest -rP
    assert on_known / on_total >= 0.8, (totals, untagged)
    assert len([s for s in totals if s != "untagged"]) >= 2, totals
