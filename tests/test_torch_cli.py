"""The port's producer and consumer CLIs against the JAX package's.

Parsing: the same flags, spellings and defaults as the JAX CLIs, the
same ``PipelineConfig`` from the same command line, the profiler on by
default, and the autotune flags taken with the JAX defaults (``off``,
2.0 s), an explicit ``--autotune off`` building no daemon. Then
the commands as processes over one ``shm://`` ring: the port's producer
and consumer end the stream with "end of stream after 24 frames"; the
JAX producer feeds the port's consumer and the port's producer the JAX
consumer, with the per-frame lines equal line for line; two consumers
share a two-shard stream; and a producer and consumer killed mid-stream
resume from the consumer's cursor with every event covered. Each run
uses a ring made here, with small slots, and destroys it after.
"""

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from psana_ray_tpu_torch import consumer as port_consumer  # noqa: E402
from psana_ray_tpu_torch import producer as port_producer  # noqa: E402
from psana_ray_tpu_torch.config import RetrievalMode  # noqa: E402
from psana_ray_tpu_torch.consumer import DataReader  # noqa: E402
from psana_ray_tpu_torch.transport import Registry, ShmRingBuffer  # noqa: E402
from torch_parity import _no_lingering_child  # noqa: E402,F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX CLIs' obs, profiler and autotune flags: each is taken with its value
PRODUCER_OBS_FLAGS = (
    "--metrics_host", "--metrics_port", "--trace_dir", "--trace_sample", "--flight_dir",
    "--history_interval", "--history_samples", "--profile_hz", "--profile_dir", "--autotune",
    "--autotune_interval",
)
CONSUMER_OBS_FLAGS = tuple(f for f in PRODUCER_OBS_FLAGS if f != "--profile_dir")


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    Registry.reset_default()
    yield
    Registry.reset_default()


def _parser_of(entry, argv):
    """The ArgumentParser that ``entry(argv)`` builds, caught at its
    ``parse_args``."""
    caught = {}
    real = argparse.ArgumentParser.parse_args

    class Caught(Exception):
        pass

    def grab(self, args=None, namespace=None):
        caught["parser"] = self
        raise Caught

    argparse.ArgumentParser.parse_args = grab
    try:
        entry(argv)
    except Caught:
        pass
    finally:
        argparse.ArgumentParser.parse_args = real
    return caught["parser"]


def _options(parser):
    return {opt: a for a in parser._actions for opt in a.option_strings if opt != "-h"}


CLIS = {
    "producer": (lambda argv: port_producer.parse_arguments(argv),
                 "psana_ray_tpu.producer", "parse_arguments"),
    "consumer": (lambda argv: port_consumer.main(argv),
                 "psana_ray_tpu.consumer", "main"),
}


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_every_jax_flag_with_its_spelling_and_default(cli):
    import importlib

    entry, jax_mod, jax_fn = CLIS[cli]
    ours = _options(_parser_of(entry, []))
    theirs = _options(_parser_of(getattr(importlib.import_module(jax_mod), jax_fn), []))
    assert set(ours) == set(theirs)
    for opt, action in ours.items():
        assert action.help != argparse.SUPPRESS, opt  # nothing is taken only to be refused
        assert action.default == theirs[opt].default, opt
        assert action.choices == theirs[opt].choices, opt
        assert action.dest == theirs[opt].dest, opt
    # the positional consumer id
    assert [a.dest for a in _parser_of(entry, [])._actions if not a.option_strings] == [
        a.dest for a in _parser_of(getattr(importlib.import_module(jax_mod), jax_fn), [])._actions
        if not a.option_strings]


def _taken(args, flag):
    """The value ``[flag, "1"]`` parsed to, as the flag's type gives it
    (``--autotune`` takes a mode: ``on``)."""
    if flag == "--autotune":
        return args.autotune == "on"
    return str(getattr(args, flag[2:])) in ("1", "1.0")


def _value(flag):
    return "on" if flag == "--autotune" else "1"


def _daemons_started(monkeypatch):
    """Count the autotune daemons started from here on."""
    from psana_ray_tpu_torch.autotune import daemon

    started = []
    real = daemon.AutotuneDaemon.start

    def start(self):
        started.append(self)
        return real(self)

    monkeypatch.setattr(daemon.AutotuneDaemon, "start", start)
    return started


def _producer_run(argv):
    """The producer CLI in-process over ``auto``: two smoke_a events."""
    port_producer.main(["--exp", "synthetic", "--detector_name", "smoke_a", "--num_events", "2",
                        "--queue_name", "cli_autotune", "--profile_hz", "0", *argv])


def _consumer_run(argv):
    """The consumer CLI in-process over ``auto``, on a queue that holds
    one end-of-stream marker."""
    from psana_ray_tpu_torch.records import EndOfStream
    from psana_ray_tpu_torch.transport.ring import RingBuffer

    q = Registry.default().get_or_create("default", "cli_autotune", lambda: RingBuffer(4))
    q.put(EndOfStream())
    assert port_consumer.main(["--queue_name", "cli_autotune", "--quiet", "--profile_hz", "0",
                               *argv]) == 0


@pytest.mark.parametrize("flag", PRODUCER_OBS_FLAGS)
def test_producer_refuses_unported_flags_naming_item_8(flag):
    """Every obs, profiler and autotune flag of the JAX CLI is taken with
    its value; none is refused."""
    assert _taken(port_producer.parse_arguments([flag, _value(flag)])[1], flag)
    if flag.startswith("--autotune"):
        assert port_producer.parse_arguments([])[1].autotune == "off"
        assert port_producer.parse_arguments([])[1].autotune_interval == 2.0


@pytest.mark.parametrize("flag", CONSUMER_OBS_FLAGS)
def test_consumer_refuses_unported_flags_naming_item_8(flag):
    """As for the producer: every flag is taken with its value."""
    parser = _parser_of(port_consumer.main, [])
    assert _taken(parser.parse_args([flag, _value(flag)]), flag)
    if flag.startswith("--autotune"):
        assert parser.parse_args([]).autotune == "off"
        assert parser.parse_args([]).autotune_interval == 2.0


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_only_the_autotune_flags_are_refused_and_the_profiler_is_on_by_default(cli, monkeypatch):
    """No flag is refused any more: ``--autotune`` parses with the JAX
    default, an explicit ``--autotune off`` builds no daemon and ``on``
    builds one; the profiler is on by default."""
    entry = CLIS[cli][0]
    opts = _options(_parser_of(entry, []))
    assert opts["--autotune"].default == "off" and opts["--autotune_interval"].default == 2.0
    assert opts["--profile_hz"].default == 97.0 and opts["--profile_dir"].default is None
    run = _producer_run if cli == "producer" else _consumer_run
    started = _daemons_started(monkeypatch)
    run(["--autotune", "off"])
    assert started == []
    try:
        run(["--autotune", "on", "--history_interval", "0"])
    finally:
        # the daemon started the process's history sampler: stop it
        from psana_ray_tpu_torch.obs.timeseries import stop_default_history

        stop_default_history()
    assert len(started) == 1 and started[0]._thread is None  # stopped at the CLI's exit


def test_reference_flag_spellings():
    cfg, _ = port_producer.parse_arguments([
        "--exp", "synthetic", "--run", "58", "--detector_name", "epix10k2M",
        "--calib", "--uses_bad_pixel_mask", "--queue_name", "q1",
        "--queue_size", "400", "--num_consumers", "4", "--max_steps", "100",
        "--ray_namespace", "ns", "--log_level", "DEBUG",
    ])
    assert cfg.source.run == 58
    assert cfg.source.mode == RetrievalMode.CALIB
    assert cfg.mask.uses_bad_pixel_mask
    assert cfg.transport.queue_size == 400
    assert cfg.transport.num_consumers == 4
    assert cfg.transport.namespace == "ns"
    assert cfg.source.max_steps == 100


def test_defaults_rendezvous_with_data_reader():
    cfg, _ = port_producer.parse_arguments([])
    reader = DataReader()
    assert cfg.transport.queue_name == reader.queue_name
    assert cfg.transport.namespace == reader.namespace
    assert cfg.source.mode == RetrievalMode.IMAGE  # without --calib: the assembled image


@pytest.mark.parametrize("argv", [
    [],
    ["--calib", "--exp", "replay:x.npz", "--address", "shm://r", "--num_consumers", "2",
     "--wire_dtype", "uint16", "--start_event", "5", "--cursor_path", "c.json",
     "--manual_mask_path", "m.npy", "--num_events", "48"],
])
def test_parsed_config_equals_the_jax_config(argv):
    import dataclasses

    from psana_ray_tpu.producer import parse_arguments as jax_parse

    ours, _ = port_producer.parse_arguments(argv)
    theirs, _ = jax_parse(argv)
    for section in ("source", "mask", "transport", "log"):
        a, b = getattr(ours, section), getattr(theirs, section)
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), (section, f.name)


def test_bad_wire_dtype_refused(capsys):
    with pytest.raises(SystemExit) as e:
        port_producer.parse_arguments(["--wire_dtype", "complex64"])
    assert e.value.code != 0 and "wire_dtype" in capsys.readouterr().err


# -- the commands as processes over one shm ring ----------------------------


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _ring(tag, slots=8, slot_bytes=64 * 1024):
    name = f"cli_{tag}_{os.getpid()}_{time.monotonic_ns() % 10**9}"
    return ShmRingBuffer.create(name, maxsize=slots, slot_bytes=slot_bytes)


def _producer(pkg, ring, *extra):
    return [sys.executable, "-m", f"{pkg}.producer", "--exp", "synthetic",
            "--num_events", "24", "--detector_name", "smoke_a",
            "--address", f"shm://{ring.name}", *extra]


def _consumer(pkg, ring, cid=0, *extra):
    return [sys.executable, "-m", f"{pkg}.consumer", str(cid),
            "--address", f"shm://{ring.name}", *extra]


def _run(producer_cmd, consumer_cmds, timeout=240):
    """Start the consumers, then the producer; wait for all. Returns the
    producer's and each consumer's (exit code, output). Output goes to
    files, so no process blocks on a full pipe."""
    env = _env()
    files = [tempfile.TemporaryFile("w+") for _ in range(1 + len(consumer_cmds))]
    procs = [subprocess.Popen(c, env=env, cwd=REPO, stdout=f, stderr=subprocess.STDOUT,
                              text=True) for c, f in zip(consumer_cmds, files[1:])]
    procs.insert(0, subprocess.Popen(producer_cmd, env=env, cwd=REPO, stdout=files[0],
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


_FRAME_LINE = re.compile(r"(consumer \d+: rank=\d+ idx=\d+ shape=\(.*\) energy=[\d.]+)$")


def _frame_lines(text):
    return [m.group(1) for line in text.splitlines() if (m := _FRAME_LINE.search(line))]


def _end_count(text):
    m = re.search(r"end of stream after (\d+) frames", text)
    return int(m.group(1)) if m else None


@pytest.fixture(scope="module")
def interop_runs():
    """One shard, one consumer, three pairings: port -> port, JAX -> port
    and port -> JAX."""
    runs = {}
    for name, (prod, cons) in {
        "port->port": ("psana_ray_tpu_torch", "psana_ray_tpu_torch"),
        "jax->port": ("psana_ray_tpu", "psana_ray_tpu_torch"),
        "port->jax": ("psana_ray_tpu_torch", "psana_ray_tpu"),
    }.items():
        ring = _ring(name.replace("->", "_"))
        try:
            runs[name] = _run(_producer(prod, ring, "--calib"), [_consumer(cons, ring)])
        finally:
            ring.destroy()
    return runs


@pytest.mark.parametrize("pairing", ["port->port", "jax->port", "port->jax"])
def test_cli_pairing_ends_the_stream(interop_runs, pairing):
    (prc, pout), (crc, cout) = interop_runs[pairing]
    assert prc == 0 and crc == 0, (pout[-2000:], cout[-2000:])
    assert "end of stream after 24 frames" in cout
    assert "EOS delivered to 1 consumer(s)" in pout and "producer done: frames=24" in pout
    assert len(_frame_lines(cout)) == 24


def test_cli_pairings_print_the_same_frame_lines(interop_runs):
    lines = {k: _frame_lines(run[1][1]) for k, run in interop_runs.items()}
    assert lines["port->port"] == lines["jax->port"] == lines["port->jax"]
    assert [int(re.search(r"idx=(\d+)", ln).group(1)) for ln in lines["port->port"]] == list(
        range(24))
    assert "shape=(2, 16, 128)" in lines["port->port"][0]


def test_two_consumers_share_a_two_shard_stream():
    ring = _ring("two")
    try:
        out = _run(_producer("psana_ray_tpu_torch", ring, "--num_shards", "2",
                             "--num_consumers", "2", "--wire_dtype", "uint16"),
                   [_consumer("psana_ray_tpu_torch", ring, c, "--quiet", "--status_interval",
                              "0.2") for c in range(2)])
    finally:
        ring.destroy()
    assert [rc for rc, _ in out] == [0, 0, 0], [o[-2000:] for _, o in out]
    counts = [_end_count(text) for _, text in out[1:]]
    assert None not in counts and sum(counts) == 24
    assert all(not _frame_lines(text) for _, text in out[1:])  # --quiet
    assert "EOS delivered to 2 consumer(s)" in out[0][1]


# -- kill and resume over shm:// ------------------------------------------

N_EVENTS = 120  # epix100 mosaics: about 45 ms an event, so the stream is live when killed


def _resume_producer(ring, cursor):
    return [sys.executable, "-m", "psana_ray_tpu_torch.producer", "--exp", "synthetic",
            "--num_events", str(N_EVENTS), "--detector_name", "epix100",
            "--address", f"shm://{ring.name}", "--num_consumers", "1", "--cursor_path", cursor]


def _resume_consumer(ring, cursor):
    return [sys.executable, "-m", "psana_ray_tpu_torch.consumer", "0",
            "--address", f"shm://{ring.name}", "--cursor_path", cursor,
            "--cursor_save_every", "1"]


def _processed(text):
    return {int(m.group(1)) for m in re.finditer(r"rank=\d+ idx=(\d+)", text)}


def test_kill_and_resume_covers_every_event(tmp_path):
    env = _env()
    cursor = str(tmp_path / "stream.cursor.json")
    out1_path = tmp_path / "consumer1.out"
    slot_bytes = 704 * 768 * 4 + 4096  # one epix100 mosaic, f32, and its header

    # run 1: both sides SIGKILLed mid-stream
    ring1 = _ring("resume1", slots=4, slot_bytes=slot_bytes)
    producer1 = consumer1 = None
    try:
        producer1 = subprocess.Popen(_resume_producer(ring1, cursor), env=env, cwd=REPO,
                                     stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        with open(out1_path, "w") as f1:
            consumer1 = subprocess.Popen(_resume_consumer(ring1, cursor), env=env, cwd=REPO,
                                         stdout=f1, stderr=subprocess.STDOUT, text=True)
            deadline = time.monotonic() + 120
            watermark = -1
            while time.monotonic() < deadline:
                if os.path.exists(cursor):
                    try:
                        with open(cursor) as f:
                            watermark = int(json.load(f).get("positions", {}).get("0", -1))
                    except ValueError:  # caught between write and rename
                        pass
                    if watermark >= 20:
                        break
                time.sleep(0.02)
            assert watermark >= 20, f"no mid-stream progress (watermark={watermark})"
            assert producer1.poll() is None or watermark < N_EVENTS - 1  # still live
            producer1.send_signal(signal.SIGKILL)
            consumer1.send_signal(signal.SIGKILL)
            producer1.wait(timeout=30)
            consumer1.wait(timeout=30)
    finally:
        for proc in (producer1, consumer1):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        ring1.destroy()  # a killed peer may have wedged a slot: the rerun takes a fresh ring

    done1 = _processed(out1_path.read_text())
    assert done1, "consumer 1 processed nothing"
    with open(cursor) as f:
        resume_at = int(json.load(f)["positions"]["0"]) + 1
    assert 20 <= resume_at <= len(done1) + 1  # a contiguous watermark

    # run 2: a fresh ring, both sides restarted from the cursor
    ring2 = _ring("resume2", slots=4, slot_bytes=slot_bytes)
    try:
        out = _run(_resume_producer(ring2, cursor), [_resume_consumer(ring2, cursor)],
                   timeout=300)
    finally:
        ring2.destroy()
    (prc, pout), (crc, cout) = out
    assert prc == 0 and crc == 0, (pout[-2000:], cout[-2000:])
    assert f"rank 0 resuming at event >= {resume_at}" in pout
    done2 = _processed(cout)
    assert min(done2) == resume_at  # nothing below the watermark re-produced
    assert done1 | done2 == set(range(N_EVENTS))  # every event, at least once
    with open(cursor) as f:
        assert int(json.load(f)["positions"]["0"]) == N_EVENTS - 1


def test_stride_mismatch_refused(tmp_path):
    from psana_ray_tpu_torch.checkpoint import StreamCursor

    cursor = StreamCursor(stride=3)
    cursor.advance(0, 0)
    path = str(tmp_path / "c.json")
    cursor.save(path)
    out = subprocess.run([sys.executable, "-m", "psana_ray_tpu_torch.consumer", "--cursor_path",
                          path, "--cursor_stride", "2"], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and "refusing" in out.stderr
    cfg, _ = port_producer.parse_arguments(["--cursor_path", path, "--detector_name",
                                            "smoke_a", "--num_events", "4"])
    rt = port_producer.ProducerRuntime(cfg, num_local_shards=2)
    with pytest.raises(ValueError, match="stride=3"):
        rt.run(block=True)


def test_the_mask_is_applied_through_the_cli(tmp_path):
    path = str(tmp_path / "mask.npy")
    np.save(path, np.zeros((1, 32, 128), np.uint8))
    ring = _ring("mask")
    try:
        out = _run(_producer("psana_ray_tpu_torch", ring, "--manual_mask_path", path,
                             "--max_steps", "3"),
                   [_consumer("psana_ray_tpu_torch", ring)])
    finally:
        ring.destroy()
    assert [rc for rc, _ in out] == [0, 0]
    assert "reached max_steps=3" in out[0][1] and _end_count(out[1][1]) == 3


def test_the_producer_creates_the_ring():
    """Over ``shm://`` the producer CLI creates the ring it does not find
    (default slots, ``--queue_size`` of them) and the consumer attaches
    with its retry loop; the ring outlives both."""
    name = f"cli_create_{os.getpid()}_{time.monotonic_ns() % 10**9}"
    ring = type("Named", (), {"name": name})
    try:
        out = _run(_producer("psana_ray_tpu_torch", ring, "--queue_size", "4"),
                   [_consumer("psana_ray_tpu_torch", ring, 0, "--quiet")])
        left = ShmRingBuffer.attach(name, retries=0, interval_s=0.01)
        stats = left.stats()
        left.disconnect()
        assert stats["maxsize"] == 4 and stats["depth"] == 0
    finally:
        try:
            ShmRingBuffer.attach(name, retries=0, interval_s=0.01).destroy()
        except TimeoutError:
            pass
    assert [rc for rc, _ in out] == [0, 0], [o[-2000:] for _, o in out]
    assert _end_count(out[1][1]) == 24
