"""The port's profiler capture and stage ranges: ``trace()`` on a CPU
``InfeedPipeline`` run writes one Chrome trace in a timestamped
subdirectory holding a ``stage.device_put`` and a ``stage.dispatch``
range for every batch (the staging thread's ranges included); the stage
names are the JAX package's; ``trace(None)`` captures nothing; ``annotate``
opens a ``record_function`` only while a capture runs, on any thread; and
the consumer CLI's ``--profile_dir`` writes its trace."""

import glob
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from psana_ray_tpu_torch.infeed import InfeedPipeline  # noqa: E402
from psana_ray_tpu_torch.obs import stages  # noqa: E402
from psana_ray_tpu_torch.records import EndOfStream, FrameRecord  # noqa: E402
from psana_ray_tpu_torch.transport import RingBuffer, ShmRingBuffer  # noqa: E402
from psana_ray_tpu_torch.utils.trace import annotate, annotate_stage, trace  # noqa: E402
from torch_parity import _no_lingering_child, one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _names(path):
    """The host-side ranges and ops of a Chrome trace (on a card, a range
    that encloses kernels shows again as a ``gpu_user_annotation``)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e.get("name", "") for e in events
            if e.get("ph") == "X" and e.get("cat") in ("user_annotation", "cpu_op")]


def _filled_ring(n, shape=(2, 16, 128)):
    q = RingBuffer(n + 1)
    for i in range(n):
        q.put(FrameRecord(0, i, np.full(shape, i, np.float32), 9.0))
    q.put(EndOfStream())
    return q


@pytest.mark.parametrize("batch,events", [(4, 12), (2, 7)])
def test_trace_of_a_pipeline_run_holds_the_stage_ranges(tmp_path, one_torch_thread, batch,
                                                        events):
    q = _filled_ring(events)
    with trace(str(tmp_path)) as path:
        pipe = InfeedPipeline(q, batch_size=batch, device="cpu", prefetch_depth=2)
        seen = pipe.run(lambda b: b.frames.sum())
    assert seen == events
    (subdir,) = os.listdir(tmp_path)
    time.strptime(subdir, "%Y%m%d-%H%M%S")  # a timestamped subdirectory
    assert glob.glob(str(tmp_path / subdir / "*.pt.trace.json")) == [path]
    names = _names(path)
    n_batches = -(-events // batch)
    assert names.count("stage.device_put") == n_batches  # on the staging thread
    assert names.count("stage.dispatch") == n_batches
    assert any(n.startswith("aten::sum") for n in names)  # the step's ops under dispatch


def test_trace_none_captures_nothing(tmp_path):
    with trace(None) as path:
        with annotate_stage(stages.STAGE_DISPATCH):
            torch.ones(2).sum()
    assert path is None and os.listdir(tmp_path) == []


def test_annotate_and_stage_names(tmp_path):
    from psana_ray_tpu.obs import stages as jax_stages

    assert stages.STAGES == jax_stages.STAGES
    for name in ("STAGE_ENQUEUE", "STAGE_QUEUE_DWELL", "STAGE_DEQUEUE", "STAGE_BATCH",
                 "STAGE_DEVICE_PUT", "STAGE_DISPATCH", "STAGE_E2E"):
        assert getattr(stages, name) == getattr(jax_stages, name)
    with trace(str(tmp_path)) as path:
        for s in stages.STAGES:
            with annotate_stage(s):
                torch.ones(3).sum()
        with annotate("custom.range"):
            pass
    names = _names(path)
    assert [n for n in names if n.startswith("stage.")] == [f"stage.{s}" for s in stages.STAGES]
    assert "custom.range" in names


def test_trace_writes_even_when_the_block_raises(tmp_path):
    with pytest.raises(KeyError):
        with trace(str(tmp_path)) as path:
            with annotate("before.error"):
                pass
            raise KeyError("x")
    assert "before.error" in _names(path)


def test_annotate_records_only_while_a_capture_runs(monkeypatch):
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    opened = []
    real = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    go, done = threading.Event(), threading.Event()

    def started_before_the_capture():
        assert go.wait(10)
        with annotate("range.on_thread"):
            torch.ones(2).sum()
        done.set()

    worker = threading.Thread(target=started_before_the_capture, daemon=True)
    worker.start()
    with annotate("range.no_capture"):
        torch.ones(2).sum()
    assert opened == []  # no capture: no record_function entered
    cfg = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=cfg) as prof:
        go.set()
        assert done.wait(10)
        with annotate("range.main"):
            torch.ones(2).sum()
    worker.join(timeout=10)
    assert not worker.is_alive()
    with annotate("range.after"):
        pass
    assert opened == ["range.on_thread", "range.main"]
    names = {e.key for e in prof.key_averages()}
    assert {"range.on_thread", "range.main"} <= names
    assert not {"range.no_capture", "range.after"} & names


def test_annotate_as_a_decorator_opens_a_range_a_call(tmp_path):
    @annotate("range.decorated")
    def work(n):
        return torch.ones(n).sum()

    with trace(str(tmp_path)) as path:
        threads = [threading.Thread(target=work, args=(3,)) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert float(work(4)) == 4.0
    assert work.__name__ == "work"
    assert _names(path).count("range.decorated") == 3


def test_consumer_cli_profile_dir_writes_a_trace(tmp_path):
    name = f"trace_cli_{os.getpid()}_{time.monotonic_ns() % 10**9}"
    ring = ShmRingBuffer.create(name, maxsize=8, slot_bytes=64 * 1024)
    try:
        for i in range(3):
            ring.put(FrameRecord(0, i, np.zeros((2, 16, 128), np.float32), 9.0))
        ring.put(EndOfStream())
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        out = subprocess.run([sys.executable, "-m", "psana_ray_tpu_torch.consumer", "0",
                              "--address", f"shm://{name}", "--profile_dir", str(tmp_path)],
                             env=env, cwd=REPO, capture_output=True, text=True, timeout=180)
    finally:
        ring.destroy()
    assert out.returncode == 0, out.stderr[-2000:]
    assert "end of stream after 3 frames" in out.stderr
    (path,) = glob.glob(str(tmp_path / "*" / "*.pt.trace.json"))
    with open(path) as f:
        assert "traceEvents" in json.load(f)
