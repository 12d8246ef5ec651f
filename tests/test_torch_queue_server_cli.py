"""The port's queue server program, ``python -m
psana_ray_tpu_torch.queue_server``, as a process.

The port's producer CLI replays a seeded ``.npz`` into two consumer CLIs
with ``--stream`` through it, plain and with ``--wire_codec shuffle-rle``
or ``auto`` on all three, and the consumers' DEBUG lines carry each
frame's CRC-32, held against the file's;
the JAX producer CLI feeds the port's consumer through the port's
server, and the port's producer feeds the JAX consumer through the JAX
server. ``--shm`` backs a named queue with the ring a local consumer
attaches to. SIGTERM drains and exits 0, and the server process loads no
torch. The flags are the JAX command's; those of modules the port has not
ported exit 2 naming ROADMAP.md Item 8, and the replication flags are
checked as the JAX command checks them (an unknown ``--replica_codec``
fails at start). Over ``cluster://`` (two servers,
``--cluster A,B --partitions 4``) the producer CLI feeds a consumer group
of two consumer CLIs, of the port or one of each package, every frame
once; the cluster flags are the JAX command's.
"""

import argparse
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import pytest

pytest.importorskip("torch")

from psana_ray_tpu_torch import queue_server  # noqa: E402
from psana_ray_tpu_torch.records import FrameRecord  # noqa: E402
from psana_ray_tpu_torch.transport import ShmRingBuffer  # noqa: E402
from psana_ray_tpu_torch.transport.tcp import TcpQueueClient  # noqa: E402
from torch_parity import _no_lingering_child  # noqa: E402,F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "psana_ray_tpu_torch"
JAX = "psana_ray_tpu"


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


class _Server:
    """A queue server process (``pkg``'s) on 127.0.0.1 and a free port."""

    def __init__(self, pkg, *args):
        self.dir = tempfile.TemporaryDirectory()
        port_file = os.path.join(self.dir.name, "port")
        self.log = tempfile.TemporaryFile("w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m", f"{pkg}.queue_server", "--host",
             "127.0.0.1", "--port", "0", "--port_file", port_file, "--drain_s", "1", *args],
            env=_env(), cwd=REPO, stdout=self.log, stderr=subprocess.STDOUT, text=True)
        deadline = time.monotonic() + 60
        while not os.path.exists(port_file):
            assert self.proc.poll() is None and time.monotonic() < deadline, self.stop()[1]
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
        return self.proc.returncode, out


def _run(producer_cmd, consumer_cmds, lead_s=1.0, timeout=180):
    """Start the consumers, then (``lead_s`` later) the producer; wait
    for all. Returns each one's (exit code, output), producer first."""
    files = [tempfile.TemporaryFile("w+") for _ in range(1 + len(consumer_cmds))]
    procs = [subprocess.Popen(c, env=_env(), cwd=REPO, stdout=f, stderr=subprocess.STDOUT,
                              text=True) for c, f in zip(consumer_cmds, files[1:])]
    time.sleep(lead_s)
    procs.insert(0, subprocess.Popen(producer_cmd, env=_env(), cwd=REPO, stdout=files[0],
                                     stderr=subprocess.STDOUT, text=True))
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    out = []
    for code, f in zip(codes, files):
        f.seek(0)
        out.append((code, f.read()))
        f.close()
    return out


def _producer(pkg, address, *extra, events=24, shards=1, consumers=1):
    return [sys.executable, "-m", f"{pkg}.producer", "--detector_name", "smoke_a",
            "--num_events", str(events), "--num_shards", str(shards), "--num_consumers",
            str(consumers), "--queue_size", "8", "--address", address, *extra]


def _consumer(pkg, address, cid, *extra):
    return [sys.executable, "-m", f"{pkg}.consumer", str(cid), "--quiet", "--address", address,
            *extra]


def _ends(text):
    return [int(n) for n in re.findall(r"end of stream after (\d+) frames", text)]


def _imported(text):
    return {line.rsplit("|", 1)[1].strip().split(".")[0] for line in text.splitlines()
            if line.startswith("import time:") and line.count("|") == 2}


def _replay(tmp_path, n=30, shape=(2, 48, 64)):
    """A seeded replay file of ``n`` f32 frames (large enough that the
    codec compresses them) and each frame's CRC-32."""
    frames = np.random.default_rng(0).normal(100.0, 5.0, (n, *shape)).astype(np.float32)
    path = str(tmp_path / "run.npz")
    np.savez(path, frames=frames, photon_energy=np.full(n, 9.5))
    return path, [zlib.crc32(f) for f in frames]


@pytest.mark.parametrize("codec", ["", "shuffle-rle", "auto"])
def test_producer_to_streamed_consumers_through_the_server(codec, tmp_path):
    npz, want = _replay(tmp_path)
    server = _Server(PORT)
    try:
        flags = ("--wire_codec", codec) if codec else ()
        out = _run(_producer(PORT, server.address, "--exp", f"replay:{npz}", *flags, events=30,
                             shards=2, consumers=2),
                   [_consumer(PORT, server.address, c, "--stream", "--stream_window", "4",
                              "--log_level", "DEBUG", *flags) for c in (0, 1)])
    finally:
        code, server_out = server.stop()
    tails = [text[-1500:] for _, text in out]
    assert [c for c, _ in out] == [0, 0, 0], tails
    assert "producer done: frames=30" in out[0][1]
    assert sum(n for _, text in out[1:] for n in _ends(text)) == 30, tails
    received = {}
    for _, text in out[1:]:
        codecs = re.findall(r"consumer \d+: wire codec (\S+)", text)
        assert len(codecs) == 1 and codecs[0] in {"": ["None"], "shuffle-rle": ["shuffle-rle"],
                                                  "auto": ["None", "shuffle-rle"]}[codec]
        for idx, crc in re.findall(r"consumer \d+: rank=\d+ idx=(\d+) crc32=([0-9a-f]{8})",
                                   text):
            assert int(idx) not in received
            received[int(idx)] = int(crc, 16)
    assert received == dict(enumerate(want))
    assert code == 0 and "queue server stopped" in server_out, server_out[-1500:]
    assert not _imported(server_out) & {"torch", "jax", "psana_ray_tpu"}


@pytest.mark.parametrize("producer,server,consumer", [(JAX, PORT, PORT), (PORT, JAX, JAX)])
def test_mixed_packages_through_one_server(producer, server, consumer):
    srv = _Server(server)
    try:
        out = _run(_producer(producer, srv.address, "--wire_codec", "shuffle-rle"),
                   [_consumer(consumer, srv.address, 0, "--stream")], lead_s=2.0)
    finally:
        code, _ = srv.stop()
    assert [c for c, _ in out] == [0, 0], [text[-1500:] for _, text in out]
    assert _ends(out[1][1]) == [24] and code == 0


def test_shm_backing_serves_local_and_remote_processes():
    name = f"qs_{os.getpid()}_{time.monotonic_ns() % 10**6}"
    server = _Server(PORT, "--shm", name, "--queue_size", "4")
    try:
        c = TcpQueueClient("127.0.0.1", server.port, namespace=name, queue_name="q", maxsize=4)
        assert c.put(FrameRecord(0, 5, [[1.0, 2.0]], 3.0))
        ring = ShmRingBuffer.attach(f"{name}__q", retries=20, interval_s=0.05)
        got = ring.get()  # the ring a remote producer fed over TCP
        assert got.event_idx == 5 and got.panels.tolist() == [[[1.0, 2.0]]]
        ring.disconnect()
        c.disconnect()
    finally:
        code, out = server.stop()
        for ring_name in (name, f"{name}__q"):
            try:
                ShmRingBuffer.attach(ring_name, retries=0, interval_s=0.01).destroy()
            except TimeoutError:
                pass
    assert code == 0, out[-1500:]


def test_flags_match_the_jax_command():
    import psana_ray_tpu.queue_server as jax_qs

    parsers = {}
    for name, main in (("port", queue_server.main), ("jax", jax_qs.main)):
        real = argparse.ArgumentParser.parse_args

        def grab(self, args=None, namespace=None, _n=name):
            parsers[_n] = self
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                main([])
        finally:
            argparse.ArgumentParser.parse_args = real
    opts = {n: {o: a for a in p._actions for o in a.option_strings if o != "-h"}
            for n, p in parsers.items()}
    assert set(opts["port"]) == set(opts["jax"])
    for opt, action in opts["port"].items():
        if opt in queue_server.NOT_PORTED_FLAGS:
            assert action.help == argparse.SUPPRESS
        else:
            assert action.default == opts["jax"][opt].default, opt


@pytest.mark.parametrize("flag", queue_server.NOT_PORTED_FLAGS)
def test_unported_flags_exit_2_naming_item_8(flag, capsys):
    for argv in ([flag, "1"], [flag]):
        with pytest.raises(SystemExit) as e:
            queue_server.main(argv)
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert flag in err and "ROADMAP.md Queue 1 Item 8" in err


def _error_line(text):
    return [line.split("error: ", 1)[1] for line in text.splitlines() if "error: " in line]


@pytest.mark.parametrize("argv", [
    ["--durable_dir", "d", "--shm", "ring"],
    ["--workers", "2", "--shm", "ring"],
    ["--workers", "3", "--shm", "ring", "--durable_dir", "d"],
    ["--replicate_peers", "a:1,b:2", "--advertise", "a:1"],
    ["--replicate_peers", "a:1,b:2", "--durable_dir", "d"],
    ["--replicate_peers", "a:1,b:2", "--durable_dir", "d", "--advertise", "c:3"],
    ["--workers", "2", "--replicate_peers", "a:1,b:2", "--durable_dir", "d", "--advertise",
     "a:1"],
])
def test_refused_combinations_exit_2_with_the_jax_messages(argv, capsys):
    import psana_ray_tpu.queue_server as jax_qs

    errors = []
    for main in (queue_server.main, jax_qs.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        errors.append(_error_line(capsys.readouterr().err))
    assert errors[0] == errors[1] and len(errors[0]) == 1, errors


def test_an_unknown_replica_codec_fails_at_start(tmp_path):
    argv = ["--port", "0", "--durable_dir", str(tmp_path / "log"), "--replicate_peers",
            "127.0.0.1:1,127.0.0.1:2", "--advertise", "127.0.0.1:1", "--replica_codec", "nope"]
    with pytest.raises(ValueError, match="unknown wire codec"):
        queue_server.main(argv)


def _durable_server(tmp_path, *extra):
    return _Server(PORT, "--durable_dir", str(tmp_path / "log"), "--segment_bytes",
                   str(1 << 20), *extra)


def test_consumer_replay_from_begin_resume_and_an_offset(tmp_path):
    """The producer CLI's 24 frames and EOS go into a durable server (offsets
    0-24); ``--replay from=begin`` reads 10 of them for group g, ``from=resume``
    the rest to the EOS, ``from=20`` for group h the last four; then a live
    consumer still reads all 24, and each frame's CRC-32 is the same in
    every read."""
    server = _durable_server(tmp_path)
    try:
        # a queue of 32: the producer finishes with no consumer attached
        out = _run(_producer(PORT, server.address, "--queue_size", "32"), [], lead_s=0,
                   timeout=60)
        assert out[0][0] == 0, out[0][1][-1500:]

        def consumer(*extra):
            (code, text), = _run(_consumer(PORT, server.address, 0, "--log_level", "DEBUG",
                                           *extra), [], lead_s=0, timeout=60)
            crcs = dict(re.findall(r"idx=(\d+) crc32=([0-9a-f]{8})", text))
            return code, {int(k): v for k, v in crcs.items()}, text

        runs = {
            "begin": consumer("--replay", "from=begin", "--replay_group", "g",
                              "--max_frames", "10"),
            "resume": consumer("--replay", "from=resume", "--replay_group", "g"),
            "offset": consumer("--replay", "from=20", "--replay_group", "h"),
            "live": consumer(),
        }
        bad = consumer("--replay", "from=yesterday")
    finally:
        code, server_out = server.stop()
    assert [r[0] for r in runs.values()] == [0, 0, 0, 0], [r[2][-1500:] for r in runs.values()]
    assert sorted(runs["begin"][1]) == list(range(10))
    assert sorted(runs["resume"][1]) == list(range(10, 24))
    assert _ends(runs["resume"][2]) == [14]
    assert sorted(runs["offset"][1]) == [20, 21, 22, 23]
    assert sorted(runs["live"][1]) == list(range(24)) and _ends(runs["live"][2]) == [24]
    for name in ("begin", "resume", "offset"):
        assert all(runs["live"][1][i] == crc for i, crc in runs[name][1].items())
    assert bad[0] == 1 and "--replay wants from=<offset|begin|resume>" in bad[2]
    assert code == 0 and not _imported(server_out) & {"torch", "jax", "psana_ray_tpu"}


def test_replay_refused_by_a_memory_server_names_the_cure():
    server = _Server(PORT)
    try:
        (code, text), = _run(_consumer(PORT, server.address, 0, "--replay", "from=begin"), [],
                             lead_s=0)
    finally:
        server.stop()
    assert code == 1 and "no segment log" in text and "--durable_dir" in text


def test_jax_producer_into_a_port_durable_fleet_into_a_port_consumer(tmp_path):
    """A JAX producer CLI and a port consumer CLI through the port's
    ``--workers 2 --durable_dir`` fleet: every frame once, CRCs intact, and
    the fleet's processes load neither torch nor JAX."""
    npz, want = _replay(tmp_path, n=24)
    server = _durable_server(tmp_path, "--workers", "2")
    try:
        out = _run(_producer(JAX, server.address, "--exp", f"replay:{npz}", events=24),
                   [_consumer(PORT, server.address, 0, "--stream", "--log_level", "DEBUG")],
                   lead_s=1.5)
    finally:
        code, server_out = server.stop()
    assert [c for c, _ in out] == [0, 0], [text[-1500:] for _, text in out]
    received = {int(i): int(c, 16) for i, c in
                re.findall(r"consumer \d+: rank=\d+ idx=(\d+) crc32=([0-9a-f]{8})", out[1][1])}
    assert received == dict(enumerate(want)) and _ends(out[1][1]) == [24]
    assert code == 0 and server_out.count("queue server stopped") == 3, server_out[-2000:]
    assert not _imported(server_out) & {"torch", "jax", "psana_ray_tpu"}


# -- cluster:// through the CLIs -----------------------------------------------
@pytest.mark.parametrize("consumers", [(PORT, PORT), (JAX, PORT)])
def test_clis_over_a_two_server_cluster(consumers, tmp_path):
    """``--cluster A,B --partitions 4``: the port's producer CLI replays the
    file in two shards into 4 partitions over two port servers (the first
    with ``--durable_dir``, so the group's store is written), and two
    consumer CLIs of group ``audit`` (``--stream``) take two partitions
    each: every frame's CRC-32 arrives once across them, each ends on one
    EOS, and no port process loads torch or JAX."""
    npz, want = _replay(tmp_path, n=32)
    servers = [_Server(PORT, "--durable_dir", str(tmp_path / "a"), "--segment_bytes",
                       str(1 << 20)), _Server(PORT)]
    cluster = ",".join(f"127.0.0.1:{s.port}" for s in servers)
    flags = ("--cluster", cluster, "--partitions", "4")
    try:
        out = _run(
            [sys.executable, "-X", "importtime", *_producer(PORT, "auto", "--exp",
                                                            f"replay:{npz}", *flags, events=32,
                                                            shards=2)[1:]],
            # the JAX consumer logs each frame (no CRC); the port's its CRC-32 at DEBUG
            [[sys.executable, "-X", "importtime",
              *[f for f in _consumer(pkg, "auto", c, *flags, "--group", "audit", "--member_id",
                                     f"m{c}", "--stream", "--log_level", "DEBUG")[1:]
                if pkg == PORT or f != "--quiet"]]
             for c, pkg in enumerate(consumers)], lead_s=3.0)
    finally:
        stopped = [s.stop() for s in servers]
    tails = [text[-1500:] for _, text in out]
    assert [c for c, _ in out] == [0, 0, 0], tails
    received = {}
    for (_, text), pkg in zip(out[1:], consumers):
        assert len(_ends(text)) == 1, text[-1500:]
        lines = (re.findall(r"consumer \d+: rank=\d+ idx=(\d+) crc32=([0-9a-f]{8})", text)
                 if pkg == PORT else
                 [(i, None) for i in re.findall(r"consumer \d+: rank=\d+ idx=(\d+) shape=",
                                                text)])
        assert lines, f"a member got no partition: {text[-1500:]}"
        for idx, crc in lines:
            assert int(idx) not in received
            received[int(idx)] = want[int(idx)] if crc is None else int(crc, 16)
    assert received == dict(enumerate(want))
    for code, text in stopped:
        assert code == 0 and not _imported(text) & {"torch", "jax", "psana_ray_tpu"}
    for (_, text), pkg in zip(out, (PORT, *consumers)):
        if pkg == PORT:
            assert not _imported(text) & {"torch", "jax", "psana_ray_tpu"}
    with open(tmp_path / "a" / "groups.json") as f:
        group = __import__("json").load(f)["groups"]["audit"]
    assert group["drained"] == [0, 1, 2, 3] and group["generation"] >= 2


@pytest.mark.parametrize("consumer", [False, True])
def test_cluster_flags_match_the_jax_command(consumer):
    """``--cluster``, ``--partitions`` (8), ``--group`` and ``--member_id``:
    the JAX command's spellings, defaults, types and help."""
    from psana_ray_tpu.transport.addressing import add_cluster_args as jax_args
    from psana_ray_tpu_torch.transport.addressing import add_cluster_args

    def actions(add):
        p = argparse.ArgumentParser()
        add(p, consumer=consumer)
        return [(a.option_strings, a.dest, a.default, a.type, a.help, a.metavar)
                for a in p._actions if a.option_strings != ["-h", "--help"]]

    ours = actions(add_cluster_args)
    assert ours == actions(jax_args)
    assert len(ours) == (4 if consumer else 2) and ours[1][2] == 8
