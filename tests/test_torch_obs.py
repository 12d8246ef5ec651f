"""The port's metrics registry, exporter, history, stall detector and
flight recorder against the JAX package's.

The same inputs, made from a numpy seed, go through both packages:
``flatten_numeric`` and ``render_prometheus`` of the same source trees
give the same leaves and the same text; ``SeriesRing`` and
``TimeSeriesStore`` give the same rate, EWMA, percentile, delta and tail
over the same samples (rtol 1e-12); ``StallDetector.poll_once(now=...)``
over the same scripted queue stats gives the same events and snapshots;
a flight dump has the JAX document's keys and is written atomically; the
federation payload and the HTTP endpoint answer what the JAX package's
collector reads.
"""

import json
import os
import signal
import threading
import time
import urllib.request

import numpy as np
import pytest

from psana_ray_tpu.obs import registry as jax_registry
from psana_ray_tpu.obs import stall as jax_stall
from psana_ray_tpu.obs import timeseries as jax_ts
from psana_ray_tpu.obs.flight import FlightRecorder as JaxFlight
from psana_ray_tpu.utils import metrics as jax_metrics
from psana_ray_tpu_torch.obs import exporter, registry, stall, timeseries
from psana_ray_tpu_torch.obs.flight import FlightRecorder
from psana_ray_tpu_torch.utils import metrics as port_metrics


def _tree(rng, depth=3):
    """A snapshot tree of ints, floats, bools, strings, non-finite values
    and an ``exemplars`` subtree."""
    out = {}
    for i in range(int(rng.integers(2, 5))):
        kind = int(rng.integers(0, 7))
        key = f"k{i}_{int(rng.integers(0, 99))}"
        if kind == 0 and depth:
            out[key] = _tree(rng, depth - 1)
        elif kind == 1:
            out[key + "_total"] = int(rng.integers(0, 10**9))
        elif kind == 2:
            out[key] = float(rng.normal(0, 1e3))
        elif kind == 3:
            out[key] = bool(rng.integers(0, 2))
        elif kind == 4:
            out[key] = "text"
        elif kind == 5:
            out[key] = [float("nan"), float("inf"), -float("inf")][int(rng.integers(0, 3))]
        else:
            out["exemplars"] = {"le_1": {"trace_id": "0x1", "ms": 0.5}}
    return out


@pytest.mark.parametrize("seed", range(6))
def test_flatten_and_prometheus_text_match_the_jax_registry(seed):
    rng = np.random.default_rng(seed)
    sources = {f"src-{j}\"x": _tree(rng) for j in range(3)}
    jax_leaves, port_leaves = [], []
    for tree in sources.values():
        jax_registry.flatten_numeric(("p",), tree, jax_leaves)
        registry.flatten_numeric(("p",), tree, port_leaves)
    assert port_leaves == jax_leaves
    jreg, preg = jax_registry.MetricsRegistry(), registry.MetricsRegistry()
    for name, tree in sources.items():
        jreg.register(name, tree)
        preg.register(name, tree)
    assert preg.render_prometheus() == jreg.render_prometheus()
    assert preg.snapshot() == jreg.snapshot()


def test_sources_of_every_kind_snapshot_as_in_the_jax_registry():
    """Metrics objects (the port's own), dicts, callables, ``stats()``
    objects and a raising source, rendered by both registries."""
    class Stats:
        def stats(self):
            return {"depth": 3, "puts": 9}

    def boom():
        raise RuntimeError("dead queue")

    for reg_mod, mets in ((jax_registry, jax_metrics), (registry, port_metrics)):
        pm = mets.PipelineMetrics()
        pm.observe_batch(4, 0.002, nbytes=64)
        pm.stages.observe("dequeue", 0.001, exemplar=7)
        reg = reg_mod.MetricsRegistry()
        for name, src in (("pm", pm), ("dict", {"a": 1}), ("call", lambda: {"b": 2.5}),
                          ("stats", Stats()), ("boom", boom)):
            reg.register(name, src)
        snap = reg.snapshot()
        assert snap["dict"] == {"a": 1} and snap["call"] == {"b": 2.5}
        assert snap["stats"] == {"depth": 3, "puts": 9} and "error" in snap["boom"]
        assert snap["pm"]["stages"]["dequeue"]["exemplars"]["le_1"]["trace_id"] == "0x7"
        text = reg.render_prometheus()
        assert 'psana_ray_puts{source="stats"} 9' in text
        assert "exemplars" not in text
        with pytest.raises(TypeError):
            reg_mod.snapshot_source(object())


def _samples(seed, n=700):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.05, 1.5, n)) + 1e9
    v = np.cumsum(rng.normal(3.0, 10.0, n))
    return list(zip(t.tolist(), v.tolist()))


@pytest.mark.parametrize("capacity", [2, 17, 600])
def test_series_ring_matches_the_jax_ring(capacity):
    pts = _samples(capacity)
    ours, theirs = timeseries.SeriesRing(capacity), jax_ts.SeriesRing(capacity)
    for k, (t, v) in enumerate(pts):
        ours.append(t, v)
        theirs.append(t, v)
        if k % 97 == 0:
            assert ours.samples() == theirs.samples() and ours.last() == theirs.last()
    assert len(ours) == len(theirs) == min(capacity, len(pts))
    for n in (None, 0, 1, 5, capacity + 3):
        assert ours.samples(n) == theirs.samples(n)
    with pytest.raises(ValueError):
        timeseries.SeriesRing(1)


@pytest.mark.parametrize("seed", range(3))
def test_store_views_match_the_jax_store(seed):
    pts = _samples(seed, 300)
    ours, theirs = timeseries.TimeSeriesStore(128), jax_ts.TimeSeriesStore(128)
    rng = np.random.default_rng(seed + 10)
    for t, v in pts:
        tree = {"q": {"puts": v, "depth": int(rng.integers(0, 40))}, "up": True,
                "skip": "x"}
        assert ours.record(tree, now=t) == theirs.record(tree, now=t)
    assert ours.keys() == theirs.keys() == ["q.depth", "q.puts", "up"]
    for key in ours.keys():
        for window in (None, 5.0, 60.0, 1e6):
            for view in ("delta", "rate"):
                a = getattr(ours, view)(key, window)
                b = getattr(theirs, view)(key, window)
                assert (a is None and b is None) or a == pytest.approx(b, rel=1e-12, abs=0)
            a, b = ours.ewma(key, 0.3, window), theirs.ewma(key, 0.3, window)
            assert a == pytest.approx(b, rel=1e-12, abs=0)
            for q in (0.0, 0.5, 0.99, 1.0):
                assert ours.percentile(key, q, window) == theirs.percentile(key, q, window)
        assert ours.last(key) == theirs.last(key)
    assert ours.tail(16) == theirs.tail(16)
    assert ours.tail(4, keys=["up", "nope"]) == theirs.tail(4, keys=["up", "nope"])
    s_ours, s_theirs = ours.snapshot(), theirs.snapshot()
    for k in ("keys", "capacity", "samples_total"):
        assert s_ours[k] == s_theirs[k]
    assert ours.rate("nope") is None and ours.ewma("nope") is None


def test_history_sampler_records_the_registry_and_appends_no_ring_in_steady_state():
    reg = registry.MetricsRegistry()
    src = {"n_total": 0}
    reg.register("c", lambda: dict(src))
    sampler = timeseries.HistorySampler(registry=reg, interval_s=10.0, capacity=4)
    for i in range(10):
        src["n_total"] = i
        assert sampler.sample_once(now=100.0 + i) == 1
    rings = dict(sampler.store._rings)
    sampler.sample_once(now=200.0)
    assert sampler.store._rings == rings  # no ring made for a known key
    assert sampler.store.series("c.n_total") == [(107.0, 7.0), (108.0, 8.0), (109.0, 9.0),
                                                 (200.0, 9.0)]
    snap = sampler.snapshot()
    assert snap["sweeps_total"] == 11 and snap["keys"] == 1
    with pytest.raises(ValueError):
        timeseries.HistorySampler(interval_s=0)


def test_default_history_is_a_registry_source_and_stops():
    class Args:
        history_interval = 0.05
        history_samples = 8

    registry.MetricsRegistry.reset_default()
    try:
        assert timeseries.default_history() is None
        sampler = timeseries.configure_history_from_args(Args())
        assert timeseries.configure_history_from_args(Args()) is sampler  # one a process
        assert "timeseries" in registry.MetricsRegistry.default().sources()
        deadline = time.monotonic() + 5.0
        while not timeseries.default_history().keys() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert "timeseries.interval_s" in timeseries.default_history().keys()
        Args.history_interval = 0
        timeseries.stop_default_history()
        assert timeseries.configure_history_from_args(Args()) is None
        assert timeseries.default_history() is None
    finally:
        timeseries.stop_default_history()
        registry.MetricsRegistry.reset_default()


class _Scripted:
    """A queue whose stats a script sets."""

    def __init__(self):
        self.s = {"depth": 0, "maxsize": 8, "puts": 0, "gets": 0}

    def stats(self):
        return dict(self.s)


def _script(seed):
    """``[(now, {queue: stats or None}), ...]``: pegged, frozen-get,
    starved and dead phases in a seeded order."""
    rng = np.random.default_rng(seed)
    steps, t = [], 0.0
    state = {"a": {"depth": 0, "maxsize": 8, "puts": 0, "gets": 0},
             "b": {"depth": 0, "maxsize": 0, "puts": 0, "gets": 0}}
    for _ in range(120):
        t += float(rng.uniform(0.2, 2.5))
        for q in state.values():
            phase = int(rng.integers(0, 5))
            if phase == 0:  # flowing
                n = int(rng.integers(1, 9))
                q["puts"] += n
                q["gets"] += n
                q["depth"] = int(rng.integers(0, 4))
            elif phase == 1:  # pegged
                q["puts"] += 1
                q["depth"] = q["maxsize"] or 5
            elif phase == 2:  # gets frozen with data waiting
                q["puts"] += 1
                q["depth"] = 3
            elif phase == 3:  # starved
                q["depth"] = 0
            # phase 4: nothing moves
        dead = int(rng.integers(0, 12)) == 0
        steps.append((t, {k: (None if dead and k == "b" else dict(v))
                          for k, v in state.items()}))
    return steps


@pytest.mark.parametrize("seed", range(4))
def test_stall_detector_gives_the_jax_events(seed):
    class Dead:
        def stats(self):
            raise ConnectionError("gone")

    events = {"jax": [], "port": []}
    clears = {"jax": 0, "port": 0}
    dets = {}
    for name, mod in (("jax", jax_stall), ("port", stall)):
        def on_clear(_n=name):
            clears[_n] += 1

        dets[name] = mod.StallDetector(poll_interval_s=1.0, full_threshold_s=2.0,
                                       idle_threshold_s=3.0,
                                       on_event=lambda e, _n=name: events[_n].append(e),
                                       on_clear=on_clear, max_events=16)
    queues = {"a": _Scripted(), "b": _Scripted()}
    for now, stats in _script(seed):
        pop = {}
        for k, s in stats.items():
            if s is None:
                pop[k] = Dead()
            else:
                queues[k].s = s
                pop[k] = queues[k]
        for d in dets.values():
            d.watch_provider(lambda _p=pop: _p)
            d.poll_once(now=now)
        assert dets["port"].degraded == dets["jax"].degraded
        assert dets["port"].snapshot() == dets["jax"].snapshot()
    assert [e.__dict__ for e in events["port"]] == [e.__dict__ for e in events["jax"]]
    assert [e.to_json() for e in dets["port"].events] == [e.to_json() for e in dets["jax"].events]
    assert clears["port"] == clears["jax"]
    assert {e.kind for e in events["port"]} >= {stall.EVENT_BACKPRESSURE}


def test_stall_detector_thread_watches_a_queue():
    from psana_ray_tpu_torch.transport.ring import RingBuffer

    q = RingBuffer(maxsize=2)
    q.put(1)
    q.put(2)
    got = []
    with stall.StallDetector(poll_interval_s=0.02, full_threshold_s=0.05,
                             on_event=got.append).watch("q", q) as det:
        deadline = time.monotonic() + 5.0
        while not got and time.monotonic() < deadline:
            time.sleep(0.01)
    assert got and got[0].kind == stall.EVENT_BACKPRESSURE and got[0].queue == "q"
    assert det.snapshot()["backpressure_total"] == 1


def _flight_pair(tmp_path):
    out = {}
    for name, cls in (("jax", JaxFlight), ("port", FlightRecorder)):
        fl = cls(maxlen=4)
        d = tmp_path / name
        fl.install(str(d), process="t", excepthook=False, signum=signal.SIGUSR1)
        for i in range(6):
            fl.record("reconnect", host="h", n=i)
        fl.record("stall_like", kind="ignored", wall=0)
        out[name] = (fl, d)
    return out


def test_flight_dump_documents_have_the_jax_keys(tmp_path):
    pair = _flight_pair(tmp_path)
    docs = {}
    try:
        for name, (fl, d) in pair.items():
            path = fl.dump("manual", trigger={"why": "test"})
            assert path is not None and fl.dump("again") is None  # rate-limited
            docs[name] = json.loads(open(path).read())
            assert os.listdir(d) == [os.path.basename(path)]  # no temporary file left
    finally:
        for fl, _ in pair.values():
            fl.uninstall()
    jdoc, pdoc = docs["jax"], docs["port"]
    assert set(pdoc) == set(jdoc)
    assert pdoc["profile_top"] is None
    for k in ("reason", "trigger", "process", "event_counts"):
        assert pdoc[k] == jdoc[k], k
    strip = [{k: v for k, v in e.items() if k not in ("wall", "mono")} for e in pdoc["events"]]
    jstrip = [{k: v for k, v in e.items() if k not in ("wall", "mono")} for e in jdoc["events"]]
    assert strip == jstrip and len(strip) == 4
    assert pdoc["events"][-1]["kind"] == "stall_like"  # the reserved keys win
    assert any("MainThread" in k for k in pdoc["threads"])
    snaps = {n: fl.snapshot() for n, (fl, _) in pair.items()}
    assert snaps["port"] == snaps["jax"]
    assert pair["port"][0].count_of("reconnect", "stall_like") == 7


def test_flight_on_stall_records_and_dumps_with_the_history_tail(tmp_path):
    registry.MetricsRegistry.reset_default()
    fl = FlightRecorder()
    fl.install(str(tmp_path), process="srv", excepthook=False, signum=signal.SIGUSR1)

    class Args:
        history_interval = 0.02
        history_samples = 8

    try:
        registry.MetricsRegistry.default().register("q", {"depth": 5})
        timeseries.configure_history_from_args(Args())
        deadline = time.monotonic() + 5.0
        while "q.depth" not in timeseries.default_history().keys():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        ev = stall.StallEvent(stall.EVENT_BACKPRESSURE, "default", 1.5, 8, 8, "pegged")
        fl.on_stall(ev)
        (path,) = [tmp_path / f for f in os.listdir(tmp_path)]
        doc = json.loads(path.read_text())
        assert doc["reason"] == "stall" and doc["trigger"]["kind"] == "backpressure"
        assert doc["events"][-1]["kind"] == "stall"
        assert doc["events"][-1]["stall_kind"] == "backpressure"
        assert doc["metrics"]["q"] == {"depth": 5}
        assert doc["timeseries_tail"]["q.depth"][-1][1] == 5
    finally:
        fl.uninstall()
        timeseries.stop_default_history()
        registry.MetricsRegistry.reset_default()


def test_flight_hooks_dump_on_an_unhandled_thread_exception(tmp_path):
    fl = FlightRecorder()
    fl.install(str(tmp_path), process="t", signum=signal.SIGUSR1)
    fl._prev_threading_excepthook = lambda hook_args: None  # the chained hook: quiet here
    try:
        t = threading.Thread(target=lambda: 1 / 0, name="worker-x")
        t.start()
        t.join(30)
        assert not t.is_alive()
        (path,) = [tmp_path / f for f in os.listdir(tmp_path)]
        doc = json.loads(path.read_text())
        assert doc["reason"] == "thread_exception"
        assert doc["trigger"]["thread"] == "worker-x"
        assert doc["trigger"]["exc_type"] == "ZeroDivisionError"
    finally:
        fl.uninstall()
    assert threading.excepthook is not fl._on_thread_exception


def test_federation_payload_has_the_jax_keys_and_worker_tag(monkeypatch):
    from psana_ray_tpu_torch.transport import workers

    reg = registry.MetricsRegistry()
    reg.register("q", {"depth": 1})
    ours = registry.federation_payload(reg)
    theirs = jax_registry.federation_payload(jax_registry.MetricsRegistry())
    assert set(ours) == set(theirs) | {"profile"}
    assert ours["ok"] is True and ours["metrics"] == {"q": {"depth": 1}}
    assert ours["profile"] is None and "worker" not in ours
    json.dumps(ours)
    monkeypatch.setattr(workers, "_CURRENT_WORKER_ID", 3)
    assert registry.federation_payload(reg)["worker"] == 3


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def test_metrics_server_serves_prometheus_json_and_federation():
    reg = registry.MetricsRegistry()
    reg.register("producer", {"frames_total": 12, "rate": 1.5})
    jreg = jax_registry.MetricsRegistry()
    jreg.register("producer", {"frames_total": 12, "rate": 1.5})
    assert exporter.start_metrics_server(0, registry=reg) is None
    with exporter.MetricsServer(registry=reg, host="127.0.0.1", port=0) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        code, ctype, text = _get(base + "/metrics")
        assert code == 200 and ctype == exporter.CONTENT_TYPE_PROM
        assert text == jreg.render_prometheus()
        assert json.loads(_get(base + "/healthz")[2]) == reg.snapshot()
        fed = json.loads(_get(base + "/federate")[2])
        assert fed["ok"] and fed["metrics"] == reg.snapshot() and fed["profile"] is None
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/nope")
        assert e.value.code == 404


def test_the_jax_collector_pulls_the_port_http_endpoint():
    from psana_ray_tpu.obs.collector import ClusterCollector

    reg = registry.MetricsRegistry()
    reg.register("consumer", {"frames_total": 5})
    with exporter.MetricsServer(registry=reg, host="127.0.0.1", port=0) as srv:
        col = ClusterCollector([f"http://127.0.0.1:{srv.port}"], register=False)
        states = col.poll_once(now=1000.0)
        assert list(states.values()) == ["up"]
        (store,) = col.stores().values()
        assert store.last("consumer.frames_total") == 5.0


def test_ensure_registered_keeps_the_first_source():
    registry.MetricsRegistry.reset_default()
    try:
        a, b = {"x": 1}, {"x": 2}
        registry.ensure_registered("durable", a)
        registry.ensure_registered("durable", b)
        assert registry.MetricsRegistry.default().snapshot() == {"durable": {"x": 1}}
    finally:
        registry.MetricsRegistry.reset_default()


@pytest.mark.parametrize("module", ["__init__", "exporter", "flight", "registry", "stages",
                                    "stall", "timeseries", "trace_merge", "tracing",
                                    "collector", "console", "top", "prof_merge",
                                    "profiling/__init__", "profiling/stagetag",
                                    "profiling/costmodel", "profiling/sampler",
                                    "profiling/export"])
def test_the_observability_plane_imports_no_torch_and_nothing_of_the_jax_package(module):
    import ast

    import psana_ray_tpu_torch.obs as obs

    path = os.path.join(os.path.dirname(obs.__file__), f"{module}.py")
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"torch", "jax", "psana_ray_tpu", "numpy"}, (module, sorted(roots))
