"""The observability planes of both packages against each other, as
processes.

- The JAX producer CLI with ``--trace_dir`` feeds the port's queue server
  and the port's consumer CLI, all three tracing every frame; then the
  port's producer CLI feeds the JAX queue server and the JAX consumer CLI.
  Each frame's trace id is the same in the three spools, and either
  package's ``trace_merge`` merges the mixed spools into the same
  document.
- The JAX package's ``ClusterCollector`` pulls the port's queue server
  over the 'N' ``{"op": "metrics"}`` RPC and reads its queue series; a
  port server without the stall detector (``--stall_poll_s 0``) shows no
  ``stalls`` source.
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import pytest

pytest.importorskip("torch")

from psana_ray_tpu.obs import trace_merge as jax_merge  # noqa: E402
from psana_ray_tpu_torch.obs import trace_merge  # noqa: E402
from psana_ray_tpu_torch.records import FrameRecord  # noqa: E402
from psana_ray_tpu_torch.transport.tcp import TcpQueueClient  # noqa: E402
from torch_parity import _no_lingering_child  # noqa: E402,F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "psana_ray_tpu_torch"
JAX = "psana_ray_tpu"
N = 12


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


class _Server:
    """A queue server process of ``pkg`` on 127.0.0.1 and a free port."""

    def __init__(self, pkg, *args):
        self.dir = tempfile.TemporaryDirectory()
        port_file = os.path.join(self.dir.name, "port")
        self.log = tempfile.TemporaryFile("w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.queue_server", "--host", "127.0.0.1", "--port", "0",
             "--port_file", port_file, "--drain_s", "1", *args],
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


def _traced_run(producer_pkg, server_pkg, consumer_pkg, trace_dir):
    """``N`` smoke_a frames from ``producer_pkg``'s producer CLI through
    ``server_pkg``'s server to ``consumer_pkg``'s streamed consumer CLI,
    every process tracing every frame into ``trace_dir``."""
    trace = ["--trace_dir", trace_dir, "--trace_sample", "1"]
    srv = _Server(server_pkg, "--trace_dir", trace_dir)
    try:
        consumer = subprocess.Popen(
            [sys.executable, "-m", f"{consumer_pkg}.consumer", "0", "--address", srv.address,
             "--stream", "--quiet", *trace],
            env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        producer = subprocess.run(
            [sys.executable, "-m", f"{producer_pkg}.producer", "--detector_name", "smoke_a",
             "--num_events", str(N), "--queue_size", "8", "--address", srv.address, *trace],
            env=_env(), cwd=REPO, capture_output=True, text=True, timeout=120)
        out, _ = consumer.communicate(timeout=120)
    finally:
        log = srv.stop()
    assert producer.returncode == 0, producer.stderr[-2000:]
    assert consumer.returncode == 0 and f"end of stream after {N} frames" in out, out[-2000:]
    assert srv.proc.returncode == 0, log[-2000:]


def _ids_by_process(trace_dir):
    out = {}
    for name in os.listdir(trace_dir):
        spool = trace_merge.load_spool(os.path.join(trace_dir, name))
        ids = {}
        for rec in spool["spans"] + spool["instants"]:
            ids.setdefault(rec["n"], set()).add(rec["id"])
        out[spool["meta"]["process"]] = ids
    return out


@pytest.mark.parametrize("pkgs", [(JAX, PORT, PORT), (PORT, JAX, JAX)],
                         ids=["jax-producer_port-server_port-consumer",
                              "port-producer_jax-server_jax-consumer"])
def test_trace_ids_survive_across_packages_and_both_merges_agree(pkgs, tmp_path):
    trace_dir = str(tmp_path / "spools")
    _traced_run(*pkgs, trace_dir)
    ids = _ids_by_process(trace_dir)
    assert set(ids) == {"producer", "queue_server", "consumer"}
    born = ids["producer"]["produce"]
    assert len(born) == N and ids["producer"]["enqueue"] == born
    assert ids["queue_server"]["queue_dwell"] == born and ids["queue_server"]["relay"] == born
    assert ids["consumer"]["dequeue"] == born
    ours, theirs = trace_merge.merge([trace_dir]), jax_merge.merge([trace_dir])
    assert ours == theirs
    assert {t["process"].split()[0] for t in ours["otherData"]["tracks"]} == set(ids)
    flows = [e for e in ours["traceEvents"] if e.get("cat") == "flow"]
    assert {e["id"] for e in flows} == born  # every frame linked across the tracks
    assert json.loads(json.dumps(ours)) == ours


def test_the_jax_collector_pulls_the_port_server_over_n(tmp_path):
    from psana_ray_tpu.obs.collector import ClusterCollector

    srv = _Server(PORT, "--history_interval", "0.2")
    try:
        c = TcpQueueClient("127.0.0.1", srv.port, queue_name="obs_q", maxsize=8)
        for i in range(5):
            assert c.put(FrameRecord(0, i, [[float(i)]], 1.0))
        payload = c.cluster_rpc({"op": "metrics"})
        assert payload["ok"] and payload["profile"]["hz"] == 97.0 and "worker" not in payload
        assert {"queue_server", "stalls", "prof", "evloop"} <= set(payload["metrics"])
        col = ClusterCollector([f"127.0.0.1:{srv.port}"], register=False)
        col.poll_once(now=1000.0)
        assert c.get() is not None
        col.poll_once(now=1001.0)
        (store,) = col.stores().values()
        assert store.last("queue_server.default/obs_q.puts") == 5.0
        assert store.series("queue_server.default/obs_q.gets") == [(1000.0, 0.0), (1001.0, 1.0)]
        assert store.last("stalls.degraded") == 0.0
        c.disconnect()
    finally:
        log = srv.stop()
    assert "queue server stopped" in log
    off = _Server(PORT, "--stall_poll_s", "0")
    try:
        c = TcpQueueClient("127.0.0.1", off.port)
        assert "stalls" not in c.cluster_rpc({"op": "metrics"})["metrics"]
        c.disconnect()
    finally:
        off.stop()


@pytest.mark.parametrize("pkg", [PORT, JAX])
def test_a_producer_blocked_by_backpressure_dumps_on_sigusr2(pkg, tmp_path):
    """A producer CLI with ``--flight_dir`` whose queue is full (no
    consumer) dumps at once on SIGUSR2: the port's takes its stats over a
    connection of its own. The JAX producer asks them over the data
    connection, behind the put that backpressure holds, so its dump waits
    for the stall to end (here: never) — a fault the port does not keep."""
    srv = _Server(PORT)
    flight = tmp_path / "flight"
    try:
        producer = subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.producer", "--detector_name", "smoke_a",
             "--num_events", "64", "--queue_size", "4", "--address", srv.address,
             "--flight_dir", str(flight)],
            env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        c = TcpQueueClient("127.0.0.1", srv.port, queue_name="shared_queue", maxsize=4)
        deadline = time.monotonic() + 60
        while c.size() < 4:  # the queue is full: the producer is held
            assert producer.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        time.sleep(0.5)
        producer.send_signal(signal.SIGUSR2)
        deadline = time.monotonic() + 3.0
        while not list(flight.glob("flight-*.json")) and time.monotonic() < deadline:
            time.sleep(0.05)
        dumps = sorted(flight.glob("flight-*.json"))
        producer.kill()
        producer.communicate(timeout=30)
        c.disconnect()
    finally:
        srv.stop()
    if pkg == PORT:
        assert dumps and json.loads(dumps[0].read_text())["reason"] == "signal"
    else:
        assert not dumps  # held behind the put
