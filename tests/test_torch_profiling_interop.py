"""The profiling and federation planes of both packages against each other.

In-process: the port's ``ClusterCollector`` and console over scripted
payloads give the JAX collector's alerts, snapshots, rows and frame; over
live in-process servers it merges host-tagged series, marks a dead peer
down and a peer without the metrics op degraded, and reads a CLI's
``/federate`` or its ``/healthz``.

As processes, each way: a queue server CLI and a producer CLI of one
package spool their profiles, and the other package's ``prof_merge``
gives the same document as their own; the other package's collector and
``obs.top --once`` read that server over 'N' and that producer's
``/federate`` (the profiler's CPU% and the loop's BUSY% on the server's
row). And the port's counterpart of the JAX package's three-process
``obs.top --once`` acceptance.
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from psana_ray_tpu.obs import collector as jax_collector  # noqa: E402
from psana_ray_tpu.obs import console as jax_console  # noqa: E402
from psana_ray_tpu.obs import prof_merge as jax_merge  # noqa: E402
from psana_ray_tpu_torch.obs import collector, console, prof_merge  # noqa: E402
from psana_ray_tpu_torch.obs.exporter import MetricsServer  # noqa: E402
from psana_ray_tpu_torch.obs.flight import FLIGHT  # noqa: E402
from psana_ray_tpu_torch.obs.registry import MetricsRegistry  # noqa: E402
from psana_ray_tpu_torch.records import FrameRecord  # noqa: E402
from psana_ray_tpu_torch.transport import evloop  # noqa: E402
from psana_ray_tpu_torch.transport.ring import RingBuffer  # noqa: E402
from psana_ray_tpu_torch.transport.tcp import TcpQueueClient, TcpQueueServer  # noqa: E402
from torch_parity import _no_lingering_child  # noqa: E402,F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "psana_ray_tpu_torch"
JAX = "psana_ray_tpu"
OTHER = {PORT: JAX, JAX: PORT}
COLLECTORS = {PORT: (collector, console), JAX: (jax_collector, jax_console)}


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Server:
    """A queue server CLI of ``pkg`` on 127.0.0.1 and a free port."""

    def __init__(self, pkg, *args):
        self.dir = tempfile.TemporaryDirectory()
        port_file = os.path.join(self.dir.name, "port")
        self.log = tempfile.TemporaryFile("w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.queue_server", "--host", "127.0.0.1", "--port", "0",
             "--port_file", port_file, "--drain_s", "0", *args],
            env=_env(), cwd=REPO, stdout=self.log, stderr=subprocess.STDOUT, text=True)
        deadline = time.monotonic() + 60
        while not os.path.exists(port_file):
            assert self.proc.poll() is None and time.monotonic() < deadline, self.stop()
            time.sleep(0.05)
        with open(port_file) as f:
            self.port = int(f.read())
        self.address = f"tcp://127.0.0.1:{self.port}"

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        self.log.seek(0)
        out = self.log.read()
        self.log.close()
        self.dir.cleanup()
        return out


def _producer(pkg, address, *args):
    return subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.producer", "--detector_name", "smoke_a", "--address",
         address, *args],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


# -- in-process: the collector and the console -------------------------------
def test_peer_specs_parse_as_in_the_jax_collector():
    for spec in ("tcp://h:9", "h:9", "http://h:9/", "https://h:9"):
        assert collector.parse_peer(spec) == jax_collector.parse_peer(spec)
    for bad in ("not-a-peer", "", "h:x"):
        with pytest.raises(ValueError):
            collector.parse_peer(bad)


def _payload(rng, t, profile=True):
    good = int(t * 10)
    return {
        "ok": True, "host": "h", "pid": 7, "worker": 1 if t > 3 else None,
        "metrics": {
            "gateway": {"goodput_total": good // (2 if 2 <= t <= 5 else 1),
                        "completed_total": good},
            "stalls": {"degraded": int(t in (4, 5))},
            "replication": {"lag_records": int(rng.integers(0, 2000))},
            "queue_server": {"default/q": {"gets": 10 * t, "depth": 3, "puts": 12 * t}},
            "prof": {"cpu_frac": float(rng.uniform(0, 1))},
            "evloop": {"busy_frac": float(rng.uniform(0, 1)),
                       "busy_frac_ewma": float(rng.uniform(0, 1))},
            "wire_codec": {"ratio_in": 2.5},
        },
        "profile": {"cpu_frac": 0.5, "hot": [{"frame": "a.py:f:1", "self": 3, "pct": 60.0}]}
        if profile else None,
    }


class _StoppedClock:
    """The ``time`` module with a wall clock that stands still: both
    collectors read ``time.time()`` for their alerts' ages and peer
    states, so each package's frames are rendered at the same instant."""

    def __init__(self, now):
        self._now = now

    def time(self):
        return self._now

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.mark.parametrize("seed", range(3))
def test_the_collector_and_console_match_the_jax_ones_over_scripted_payloads(seed,
                                                                            monkeypatch):
    rng = np.random.default_rng(seed)
    payloads = [_payload(rng, t, profile=bool(t % 2)) for t in range(8)]
    got = {}
    for pkg, (col_mod, con_mod) in COLLECTORS.items():
        feed = iter(payloads)
        monkeypatch.setattr(col_mod._Peer, "pull", lambda self, t, feed=feed: next(feed))
        monkeypatch.setattr(col_mod, "time", _StoppedClock(1010.0))
        c = col_mod.ClusterCollector(["127.0.0.1:1"], register=False, burn_window_s=3.0,
                                     repl_lag_records=1000)
        alerts, frames = [], []
        for t in range(8):
            c.poll_once(now=1000.0 + t)
            alerts.append(sorted(a["alert"] for a in c.active_alerts()))
            p = c.peers()[0]
            row = con_mod.peer_row(p.label, p.state, c.store(p.label), 30.0, profile=p.profile)
            frames.append((row, con_mod.render(c, window_s=30.0, now=2000.0).split("\n", 1)[1]))
        store = c.store("127.0.0.1:1")
        got[pkg] = (alerts, frames, c.snapshot(), {k: store.series(k) for k in store.keys()})
        c.stop()
    assert got[PORT] == got[JAX]
    alerts = got[PORT][0]
    assert {"slo_burn", "stall", "replication_lag"} <= set(sum(alerts, []))
    assert console.sparkline([]) == "" and console.sparkline([1.0] * 3) == "▁▁▁"
    assert console.sparkline(list(range(16)), width=8)[-1] == "█"


def test_the_collector_merges_live_servers_and_degrades_loudly(monkeypatch):
    from psana_ray_tpu.transport.ring import RingBuffer as JaxRing
    from psana_ray_tpu.transport.tcp import TcpQueueServer as JaxServer

    ours = TcpQueueServer(RingBuffer(10), host="127.0.0.1").serve_background()
    theirs = JaxServer(JaxRing(10), host="127.0.0.1").serve_background()
    c = collector.ClusterCollector([f"127.0.0.1:{ours.port}", f"tcp://127.0.0.1:{theirs.port}"],
                                   register=False, pull_timeout_s=2.0)
    try:
        assert set(c.poll_once().values()) == {collector.PEER_UP}
        assert all(p.host and p.pid == os.getpid() for p in c.peers())
        c.poll_once()
        for label, store in c.stores().items():
            assert store.snapshot()["samples_total"] == 2, label
        # the port's loop registers its source with each new loop; the JAX
        # loop registers once a process, so not after a registry reset
        assert c.store(f"127.0.0.1:{ours.port}").last("evloop.loops_total") is not None
        before = FLIGHT.count_of("collector_peer_down")
        theirs.shutdown()
        states = c.poll_once()
        assert states[f"127.0.0.1:{theirs.port}"] == collector.PEER_DOWN
        assert states[f"127.0.0.1:{ours.port}"] == collector.PEER_UP
        assert FLIGHT.count_of("collector_peer_down") == before + 1
        assert c.snapshot()["peers_down"] == 1
        # a server whose 'N' answers the metrics op with {"ok": false}
        monkeypatch.setattr(evloop, "federation_payload",
                            lambda: (_ for _ in ()).throw(RuntimeError("old peer")))
        before = FLIGHT.count_of("collector_peer_degraded")
        assert c.poll_once()[f"127.0.0.1:{ours.port}"] == collector.PEER_DEGRADED
        assert FLIGHT.count_of("collector_peer_degraded") == before + 1
    finally:
        c.stop()
        ours.shutdown()
        theirs.shutdown()


def test_the_collector_reads_federate_and_falls_back_to_healthz():
    import http.server

    reg = MetricsRegistry()
    reg.register("fake", lambda: {"count_total": 3})
    ms = MetricsServer(registry=reg, host="127.0.0.1", port=0).start()

    class Old(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps({"legacy": {"depth": 4}}).encode() if self.path == "/healthz" \
                else b"{}"
            self.send_response(200 if self.path == "/healthz" else 404)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    old = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Old)
    threading.Thread(target=old.serve_forever, daemon=True).start()
    new_url, old_url = f"http://127.0.0.1:{ms.port}", f"http://127.0.0.1:{old.server_address[1]}"
    c = collector.ClusterCollector([new_url, old_url], register=False)
    try:
        states = c.poll_once()
        assert states == {new_url: collector.PEER_UP, old_url: collector.PEER_DEGRADED}
        assert c.store(new_url).last("fake.count_total") == 3.0
        assert c.store(old_url).last("legacy.depth") == 4.0
    finally:
        c.stop()
        ms.close()
        old.shutdown()
        old.server_close()


# -- processes, each way -------------------------------------------------------------
@pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port-spools", "jax-spools"])
def test_each_merge_reads_the_other_packages_process_spools(pkg, tmp_path):
    spools = str(tmp_path / "prof")
    srv = _Server(pkg, "--profile_dir", spools)
    try:
        prod = _producer(pkg, srv.address, "--num_events", "48", "--queue_size", "64",
                         "--profile_dir", spools)
        out, _ = prod.communicate(timeout=120)
        assert prod.returncode == 0, out[-2000:]
    finally:
        log = srv.stop()
    assert srv.proc.returncode == 0, log[-2000:]
    names = sorted(os.listdir(spools))
    assert [n.split("-")[0] for n in names] == ["producer", "queue_server"], names
    theirs = (jax_merge if pkg == PORT else prof_merge).merge([spools])
    ours = (prof_merge if pkg == PORT else jax_merge).merge([spools])
    assert theirs == ours
    prof = ours["profile"]
    assert {p["process"].split(":")[0] for p in prof["processes"]} == {"producer", "queue_server"}
    assert all(p["samples"] > 0 for p in prof["processes"]) and prof["hot"]
    assert prof_merge.merged_collapsed([spools]) == jax_merge.merged_collapsed([spools])


@pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port-processes", "jax-processes"])
def test_each_collector_and_console_read_the_other_packages_processes(pkg):
    reader = OTHER[pkg]
    col_mod, _ = COLLECTORS[reader]
    srv = _Server(pkg, "--history_interval", "0.2", "--queue_size", "4")
    mport = _free_port()
    # no consumer: the producer stays up, held by backpressure
    prod = _producer(pkg, srv.address, "--num_events", "200", "--queue_size", "4",
                     "--metrics_port", str(mport))
    peers = [f"127.0.0.1:{srv.port}", f"http://127.0.0.1:{mport}"]
    try:
        c = col_mod.ClusterCollector(peers, register=False)
        try:
            deadline = time.monotonic() + 60
            while set(c.poll_once().values()) != {"up"}:
                assert prod.poll() is None and time.monotonic() < deadline, c.peers()
                time.sleep(0.2)
            time.sleep(1.2)  # a cost-model tick in each process
            c.poll_once()
            store = c.store(peers[0])
            for key in ("prof.cpu_frac", "evloop.busy_frac", "evloop.loops_total"):
                assert store.last(key) is not None, (key, sorted(store.keys())[:40])
            prods = {p.label: p for p in c.peers()}
            assert prods[peers[1]].profile["hz"] == 97.0
            assert c.store(peers[1]).last("producer.frames_total") is not None
        finally:
            c.stop()
        top = subprocess.run(
            [sys.executable, "-m", f"{reader}.obs.top", "--peers", ",".join(peers), "--once",
             "--settle", "0.5"], env=_env(), cwd=REPO, capture_output=True, text=True,
            timeout=120)
        assert top.returncode == 0, top.stderr[-2000:]
        rows = {line.split()[0]: line for line in top.stdout.splitlines()
                if line.startswith(("127.0.0.1:", "http://"))}
        assert set(rows) == set(peers) and all(" up " in r for r in rows.values()), top.stdout
        cols = rows[peers[0]].split()
        head = next(ln for ln in top.stdout.splitlines() if ln.startswith("PEER")).split()
        cpu, busy = cols[head.index("CPU%")], cols[head.index("BUSY%")]
        assert cpu != "-" and busy != "-", top.stdout
        assert f":{srv.proc.pid}" in rows[peers[0]] and f":{prod.pid}" in rows[peers[1]]
    finally:
        prod.kill()
        prod.communicate(timeout=30)
        srv.stop()


def _port_server(tmp_path, name):
    port_file = str(tmp_path / f"port_{name}")
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PORT}.queue_server", "--port", "0", "--port_file", port_file,
         "--stall_poll_s", "0", "--queue_size", "64", "--history_interval", "0.2"],
        cwd=REPO, env=_env(), stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + 30
    while not os.path.exists(port_file):
        assert proc.poll() is None, "queue server died on startup"
        assert time.monotonic() < deadline, "server never wrote port file"
        time.sleep(0.05)
    return proc, int(open(port_file).read())


def test_once_renders_federated_rows_over_three_processes(tmp_path, capsys):
    """Three port servers: ``obs.top --once`` shows each host-tagged and up,
    the depth that 5 puts and 2 gets made on the first, and each server's
    CPU% and BUSY% (the profiler runs by default)."""
    from psana_ray_tpu_torch.obs.top import main as top_main

    procs = []
    try:
        servers = [_port_server(tmp_path, f"s{i}") for i in range(3)]
        procs = [p for p, _ in servers]
        ports = [port for _, port in servers]
        cli = TcpQueueClient("127.0.0.1", ports[0], reconnect_tries=1)
        for i in range(5):
            assert cli.put_wait(FrameRecord(0, i, np.zeros((1, 8, 8), np.uint16), 9.5),
                                timeout=10.0)
        assert cli.get(deadline=time.monotonic() + 10) is not None
        assert cli.get(deadline=time.monotonic() + 10) is not None
        cli.disconnect()
        time.sleep(1.2)  # a cost-model tick in each server
        assert top_main(["--peers", ",".join(f"127.0.0.1:{p}" for p in ports), "--once",
                         "--settle", "0.5"]) == 0
        out = capsys.readouterr().out
        lines = out.splitlines()
        head = next(ln for ln in lines if ln.startswith("PEER")).split()
        for port, proc in zip(ports, procs):
            row = next(ln for ln in lines if ln.startswith(f"127.0.0.1:{port}"))
            cols = row.split()
            assert cols[1] == "up" and f":{proc.pid}" in row, row
            assert cols[head.index("CPU%")] != "-" and cols[head.index("BUSY%")] != "-", row
        row0 = next(ln for ln in lines if ln.startswith(f"127.0.0.1:{ports[0]}"))
        assert row0.split()[head.index("DEPTH")] == "3"
        assert "sweeps=2" in out
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
