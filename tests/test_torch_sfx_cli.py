"""The port's SFX operator CLI (``python -m psana_ray_tpu_torch.sfx``)
against the JAX package's, mirroring ``tests/test_sfx.py``'s CLI tests.

The whole operator path: the JAX package trains the smoke PeakNet-TPU (as
``tests/test_torch_sfx.py`` does) and saves the folded tree with orbax;
``tools/convert_params.py`` carries it into the port's file. Then one CLI
process of each package drains its own shm ring, both rings fed the same
RAW events (calibrated on the way from ``--calib_npz``), and each writes a
CXI file. Tolerance: per event, at least 95% of the peaks of either file
match a peak of the other within 1 px (the SFX tolerance of
``tests/test_torch_sfx.py``). In-process: the ``--mode`` and
``--features`` refusals and the h5py check come before any queue is
opened; a fresh run refuses an existing output and a resumed one appends;
``--max_events`` drains the batch in flight; the obs, profiler and
autotune flags of the JAX CLI are taken (``--autotune`` with its JAX
default, an explicit ``off`` building no daemon), and the cluster
flags serve a consumer group over two queue servers.
"""

import importlib.util
import logging
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("h5py")

import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu_torch import sfx  # noqa: E402
from psana_ray_tpu_torch.config import TransportConfig  # noqa: E402
from psana_ray_tpu_torch.transport import Registry  # noqa: E402
from psana_ray_tpu_torch.transport.addressing import open_queue  # noqa: E402
from torch_parity import _no_lingering_child, one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = "smoke_a"
SEED = 5
FEATURES = (8, 16)
EVAL_RUN = 2  # the training recipe reads run 1
N_EVENTS = 12


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The trained, folded serving tree: as an orbax directory (the JAX
    package's form) and converted into the port's file."""
    from psana_ray_tpu.checkpoint import save_params as orbax_save
    from test_torch_sfx import _train_serving_tree

    d = tmp_path_factory.mktemp("sfx_cli")
    orbax_dir, npz = str(d / "serving"), str(d / "serving.npz")
    orbax_save(orbax_dir, _train_serving_tree())
    spec = importlib.util.spec_from_file_location(
        "convert_params", os.path.join(ROOT, "tools", "convert_params.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.orbax2npz(orbax_dir, npz)
    return orbax_dir, npz


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """The RAW evaluation events and the npz of the constants that
    calibrate them (absolute gain: ADUs a photon)."""
    src = pt.SyntheticSource(run=EVAL_RUN, num_events=N_EVENTS, detector_name=DET, seed=SEED)
    path = str(tmp_path_factory.mktemp("calib") / "calib.npz")
    np.savez(path, pedestal=src.pedestal(), gain=src.spec.adu_gain * src.gain_map(),
             mask=src.create_bad_pixel_mask())
    return list(src.iter_indexed_events("raw")), path


@pytest.fixture(scope="module")
def init_params(tmp_path_factory):
    """An untrained serving file, for the tests of the CLI's plumbing."""
    path = str(tmp_path_factory.mktemp("init") / "init.npz")
    pt.save_params(path, {"params": pt.init_peaknet_tpu_params(FEATURES, seed=0)})
    return path


@pytest.fixture
def registry():
    Registry.reset_default()
    yield Registry.default()
    Registry.reset_default()


def _match(a, b, tol=1.0):
    """Greedy one-to-one matches between two ``[n, 2]`` point sets."""
    taken = np.zeros(len(b), bool)
    hits = 0
    for p in a:
        if not len(b):
            break
        d = np.hypot(b[:, 0] - p[0], b[:, 1] - p[1])
        d[taken] = np.inf
        j = int(np.argmin(d))
        if d[j] <= tol:
            taken[j] = True
            hits += 1
    return hits


def _unique(tag):
    return f"sfx_cli_{tag}_{os.getpid()}_{time.monotonic_ns() % 10**9}"


def test_cli_processes_over_shm_agree_with_the_jax_cli(trees, stream, tmp_path):
    from psana_ray_tpu.cxi import read_cxi_peaksets

    orbax_dir, npz = trees
    events, calib_npz = stream
    frame_bytes = events[0][1].nbytes
    names = {"jax": _unique("jax"), "port": _unique("port")}
    rings = {k: pt.ShmRingBuffer.create(n, maxsize=16, slot_bytes=frame_bytes + 4096)
             for k, n in names.items()}
    producers = [threading.Thread(target=pt.produce, args=(events, ring),
                                  kwargs=dict(timeout=120.0), daemon=True)
                 for ring in rings.values()]
    cxi = {k: str(tmp_path / f"{k}.cxi") for k in names}
    cursor = str(tmp_path / "port.cursor")
    common = ["--features", "8,16", "--mode", "quality", "--batch", "4",
              "--calib_npz", calib_npz]
    cmds = {
        "jax": [sys.executable, "-m", "psana_ray_tpu.sfx", "--address", f"shm://{names['jax']}",
                "--serving_params", orbax_dir, "--output", cxi["jax"], *common],
        "port": [sys.executable, "-m", "psana_ray_tpu_torch.sfx",
                 "--address", f"shm://{names['port']}", "--serving_params", npz,
                 "--output", cxi["port"], "--cursor_path", cursor, "--device", "cpu", *common],
    }
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT,
           "OMP_NUM_THREADS": "1"}
    procs = {}
    try:
        for t in producers:
            t.start()
        procs = {k: subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
                 for k, c in cmds.items()}
        outs = {k: p.communicate(timeout=600) for k, p in procs.items()}
        for t in producers:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        for ring in rings.values():
            ring.destroy()
    for k, p in procs.items():
        assert p.returncode == 0, (k, outs[k][1][-3000:])
    assert "end of stream: 12 events" in outs["port"][1]

    ours = {s.event_idx: s for s in pt.read_cxi_peaksets(cxi["port"])}
    theirs = {s.event_idx: s for s in read_cxi_peaksets(cxi["jax"])}
    assert sorted(ours) == sorted(theirs) == list(range(N_EVENTS))
    shares = []
    for e in range(N_EVENTS):
        a = np.stack([ours[e].y, ours[e].x], 1)
        b = np.stack([theirs[e].y, theirs[e].x], 1)
        hits = _match(a, b)
        shares.append(min(hits / max(len(a), 1), hits / max(len(b), 1)))
        assert ours[e].photon_energy == pytest.approx(theirs[e].photon_energy)
    print(f"per-event peak agreement {shares}")  # observed values: pytest -rP
    assert sum(s.n for s in ours.values()) > N_EVENTS  # the trained tree finds peaks
    assert min(shares) >= 0.95, shares
    assert pt.StreamCursor.load(cursor).resume_point(0) == N_EVENTS


def _args(params, output, *extra):
    return ["--serving_params", params, "--output", str(output), "--device", "cpu", *extra]


@pytest.fixture
def no_queue(monkeypatch):
    """Fail the test if the CLI opens a queue."""
    def refuse(*a, **k):
        raise AssertionError("the CLI opened a queue before refusing")

    monkeypatch.setattr(sfx, "open_queue", refuse)


def test_mode_and_features_refused_before_the_queue(init_params, tmp_path, no_queue, caplog):
    caplog.set_level(logging.ERROR)
    out = tmp_path / "x.cxi"
    assert sfx.main(_args(init_params, out, "--mode", "throughput")) == 1
    assert "expects s2d=4" in caplog.text
    assert sfx.main(_args(init_params, out, "--features", "4,8")) == 1
    assert "does not match" in caplog.text
    assert sfx.main(_args(init_params, out, "--features", "eight")) == 1
    assert "comma-separated" in caplog.text
    assert not out.exists()


def test_cursor_stride_mismatch_refused(init_params, tmp_path, no_queue, caplog):
    cursor = str(tmp_path / "c.cursor")
    pt.StreamCursor(stride=2, positions={0: 4}).save(cursor)
    assert sfx.main(_args(init_params, tmp_path / "x.cxi", "--cursor_path", cursor,
                          "--cursor_stride", "4")) == 1
    assert "stride=2" in caplog.text


def test_fresh_run_refuses_existing_output(init_params, tmp_path, no_queue):
    out = tmp_path / "exists.cxi"
    out.write_bytes(b"not empty")
    assert sfx.main(_args(init_params, out)) == 1
    assert out.read_bytes() == b"not empty"  # untouched


def test_without_h5py_main_fails_before_the_queue(init_params, tmp_path, no_queue,
                                                    monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py raises ImportError
    assert sfx.main(_args(init_params, tmp_path / "x.cxi")) == 1
    assert "h5py" in caplog.text


def test_an_orbax_tree_is_refused_naming_the_tool(trees, tmp_path, no_queue, caplog):
    assert sfx.main(_args(trees[0], tmp_path / "x.cxi")) == 1
    assert "tools/convert_params.py" in caplog.text


@pytest.mark.parametrize("address", ["tcp://localhost:5555"])
def test_tcp_address_refused_naming_item_8(init_params, tmp_path, address, caplog):
    """With no server listening on the address's port (a port just bound
    and closed) the CLI exits 1 naming the queue it could not open."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = address.replace("localhost:5555", f"127.0.0.1:{s.getsockname()[1]}")
    assert sfx.main(_args(init_params, tmp_path / "x.cxi", "--address", address)) == 1
    assert "could not open queue" in caplog.text


# the JAX CLI's obs, profiler and autotune flags: each is taken with its value
OBS_FLAGS = (
    "--metrics_port", "--metrics_host", "--trace_dir", "--trace_sample", "--flight_dir",
    "--history_interval", "--history_samples", "--profile_hz", "--profile_dir", "--autotune",
    "--autotune_interval",
)


@pytest.mark.parametrize("flag", OBS_FLAGS)
def test_obs_autotune_and_cluster_flags_refused_naming_item_8(init_params, tmp_path, flag):
    """Every flag is taken with its value (``--autotune`` takes a mode);
    the autotune pair defaults as the JAX CLI's."""
    if flag == "--autotune":
        a = sfx.parse_args(_args(init_params, tmp_path / "x.cxi", flag, "observe"))
        assert a.autotune == "observe"
        with pytest.raises(SystemExit):  # a mode outside off|on|observe
            sfx.parse_args(_args(init_params, tmp_path / "x.cxi", flag, "1"))
    else:
        a = sfx.parse_args(_args(init_params, tmp_path / "x.cxi", flag, "1"))
        assert str(getattr(a, flag[2:])) in ("1", "1.0")
    d = sfx.parse_args(_args(init_params, tmp_path / "x.cxi"))
    assert (d.autotune, d.autotune_interval) == ("off", 2.0)


def test_only_the_autotune_flags_are_refused_and_the_profiler_is_on_by_default(
        init_params, stream, tmp_path, registry, monkeypatch):
    """No flag is refused: an explicit ``--autotune off`` runs the stream
    and builds no daemon, ``on`` builds one (stopped at the run's end)
    whose registry holds the drain and pool knobs."""
    from psana_ray_tpu_torch.autotune import daemon
    from psana_ray_tpu_torch.obs.registry import MetricsRegistry
    from psana_ray_tpu_torch.obs.timeseries import stop_default_history

    a = sfx.parse_args(_args(init_params, tmp_path / "x.cxi"))
    assert a.profile_hz == 97.0 and a.profile_dir is None
    started = []
    real = daemon.AutotuneDaemon.start
    monkeypatch.setattr(daemon.AutotuneDaemon, "start",
                        lambda self: started.append(self) or real(self))
    events, calib_npz = stream

    class Sink:
        max_peaks = 32

        def __init__(self):
            self.sets = []

        def append(self, sets):
            self.sets.extend(sets)

    for mode in ("off", "on"):
        _feed(events[:4], f"tune_{mode}")
        sink = Sink()
        args = sfx.parse_args(_args(init_params, tmp_path / f"{mode}.cxi", "--queue_name",
                                    f"tune_{mode}", "--calib_npz", calib_npz, "--batch", "2",
                                    "--autotune", mode, "--profile_hz", "0"))
        try:
            assert sfx.run(args, writer=sink) == 0
        finally:
            stop_default_history()
        assert len(sink.sets) == 4
        assert len(started) == (mode == "on")
    assert started[0]._thread is None
    knobs = MetricsRegistry.default().snapshot()["autotune"]
    assert {"drain_chunk", "drain_poll_s", "bufpool_min_per_class"} <= set(knobs)


def test_cluster_flags_serve_one_group_member(init_params, stream, tmp_path):
    """``--cluster A,B --partitions 2 --group sfx`` reads a queue sharded
    over two queue servers as a member of group ``sfx``: every event is
    written once, and the coordinator (the first server) holds the group."""
    from psana_ray_tpu_torch.cluster import ClusterClient
    from psana_ray_tpu_torch.transport.tcp import TcpQueueServer

    events, calib_npz = stream
    servers = [TcpQueueServer(host="127.0.0.1", port=0).serve_background() for _ in range(2)]
    addrs = ",".join(f"127.0.0.1:{s.port}" for s in servers)
    try:
        prod = ClusterClient(addrs, queue_name="sfx_cluster", n_partitions=2)
        pt.produce(events, prod)
        prod.disconnect()

        class Sink:
            max_peaks = 32

            def __init__(self):
                self.sets = []

            def append(self, sets):
                self.sets.extend(sets)

        sink = Sink()
        args = sfx.parse_args(_args(init_params, tmp_path / "x.cxi", "--queue_name",
                                    "sfx_cluster", "--calib_npz", calib_npz, "--batch", "2",
                                    "--cluster", addrs, "--partitions", "2", "--group", "sfx",
                                    "--member_id", "m0"))
        assert sfx.run(args, writer=sink) == 0
        assert sorted(s.event_idx for s in sink.sets) == list(range(N_EVENTS))
        info = servers[0].groups.handle({"op": "info", "group": "sfx"})
        assert info["drained"] == [0, 1] and info["members"] == []  # it left at the end
    finally:
        for srv in servers:
            srv.shutdown()


def _feed(events, queue_name):
    """A producer's queue in the process's registry, filled with
    ``events`` and one EOS."""
    q = open_queue(TransportConfig(queue_name=queue_name, queue_size=len(events) + 1),
                   role="producer")
    pt.produce(events, q)
    return q


def test_resumed_run_appends_to_its_output(init_params, stream, tmp_path, registry):
    events, calib_npz = stream
    out, cursor = tmp_path / "run.cxi", str(tmp_path / "run.cursor")
    flags = ["--calib_npz", calib_npz, "--batch", "2", "--cursor_path", cursor,
             "--max_peaks", "32"]
    _feed(events[:6], "first")
    assert sfx.main(_args(init_params, out, "--queue_name", "first", *flags)) == 0
    assert pt.StreamCursor.load(cursor).resume_point(0) == 6
    before = pt.read_cxi_peaksets(str(out))
    _feed(events[6:], "second")
    # the same output, and no --overwrite: a resume (the cursor has positions) appends
    assert sfx.main(_args(init_params, out, "--queue_name", "second", *flags)) == 0
    after = pt.read_cxi_peaksets(str(out))
    assert [s.event_idx for s in after] == list(range(N_EVENTS))
    for s, t in zip(before, after[:6]):  # the first run's rows intact
        np.testing.assert_array_equal(s.y, t.y)
    assert pt.StreamCursor.load(cursor).resume_point(0) == N_EVENTS


def test_max_events_drains_the_batch_in_flight(init_params, stream, tmp_path, registry):
    """The run stops near the bound, overshooting by at most one batch and
    the one in flight, which is written; the cursor covers what was."""
    events, calib_npz = stream
    out, cursor = tmp_path / "bounded.cxi", str(tmp_path / "bounded.cursor")
    _feed(events, "bounded")

    class Sink:
        max_peaks = 32

        def __init__(self):
            self.sets = []

        def append(self, sets):
            self.sets.extend(sets)

    sink = Sink()
    metrics = pt.PipelineMetrics()
    args = sfx.parse_args(_args(init_params, out, "--queue_name", "bounded", "--calib_npz",
                                calib_npz, "--batch", "2", "--max_events", "5",
                                "--cursor_path", cursor))
    assert sfx.run(args, writer=sink, metrics=metrics) == 0
    n = len(sink.sets)
    assert 5 <= n <= 5 + 2 * 2 - 1
    assert [s.event_idx for s in sink.sets] == list(range(n))
    assert metrics.frames == n  # the caller's metrics took the record
    assert pt.StreamCursor.load(cursor).resume_point(0) == n
    assert not out.exists()  # the writer given took the peaks
