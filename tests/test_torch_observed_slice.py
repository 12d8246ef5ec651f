"""The ResNet slice traced end to end across three processes, on the CPU.

The port's producer CLI replays seeded RAW frames from an ``.npz``
through the port's queue server process to the port's ``InfeedPipeline``
in this process, twice: untraced, and with every process tracing every
frame (``--trace_sample 1``). The traced logits equal the untraced ones
exactly and stay within the fused nets' bound (``rel_err < 0.05``) of the
JAX package's pipeline (its Pallas calibration and fused ResNet in
interpret mode). In the merged trace every frame has its eight spans
(``produce``, ``enqueue``, ``queue_dwell``, ``relay``, ``dequeue``,
``batch``, ``device_put``, ``dispatch``) in that order once aligned, and
the pipeline's stage histograms hold one observation a frame. A SIGUSR2
dump is complete JSON from the moment it can be seen, and the producer
and queue server processes load no torch with the observability plane on.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu_torch.obs import trace_merge, tracing  # noqa: E402
from psana_ray_tpu_torch.obs.flight import FlightRecorder  # noqa: E402
from psana_ray_tpu_torch.transport.tcp import TcpQueueClient  # noqa: E402
from torch_parity import _no_lingering_child, one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 0.05
STAGES = (1, 1, 1, 1)
N, B, P, H, W = 8, 4, 2, 32, 32
SPANS = ("produce", "enqueue", "queue_dwell", "relay", "dequeue", "batch", "device_put",
         "dispatch")
ALIGN_TOL_US = 2000.0  # one host: the merge's clock alignment is good to microseconds


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _inputs():
    rng = np.random.default_rng(17)
    ped = (100.0 + 3.0 * rng.standard_normal((P, H, W))).astype(np.float32)
    gain = (1.0 + 0.02 * rng.standard_normal((P, H, W))).astype(np.float32)
    mask = (rng.random((P, H, W)) > 0.01).astype(np.uint8)
    raw = (ped + 35.0 * rng.poisson(0.1, (N, P, H, W)) * gain
           + rng.normal(0, 2.5, (N, P, H, W))).astype(np.float32)
    params = pt.init_resnet_params(in_channels=P, stage_sizes=STAGES, width=16, seed=0)
    return ped, gain, mask, raw, params


def _serve(trace_dir, npz, consts, packed, metrics):
    """One run: a queue server process, the producer CLI replaying ``npz``,
    and the pipeline here; every process traces every frame when
    ``trace_dir`` is set. Returns the logits by event index."""
    port_file = os.path.join(tempfile.mkdtemp(dir=os.path.dirname(npz)), "port")
    trace = [] if trace_dir is None else ["--trace_dir", trace_dir, "--trace_sample", "1"]
    server = subprocess.Popen(
        [sys.executable, "-m", "psana_ray_tpu_torch.queue_server", "--host", "127.0.0.1",
         "--port", "0", "--port_file", port_file, "--drain_s", "1", *trace[:2]],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    producer = client = None
    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(port_file):
            assert server.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        port = int(open(port_file).read())
        client = TcpQueueClient("127.0.0.1", port, queue_name="shared_queue", maxsize=8)
        if trace_dir is not None:
            args = argparse.Namespace(trace_dir=trace_dir, trace_sample=1, flight_dir=None)
            assert tracing.configure_from_args(args, "consumer", queue=client) is tracing.TRACER
        client.stream_open(4)
        producer = subprocess.Popen(
            [sys.executable, "-m", "psana_ray_tpu_torch.producer", "--exp", f"replay:{npz}",
             "--address", f"tcp://127.0.0.1:{port}", "--queue_size", "8", *trace],
            env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        def step(batch):
            cal = pt.fused_calibrate(batch.frames, *consts, threshold=10.0,
                                     out_dtype=torch.bfloat16)
            return pt.resnet_fused_infer(packed, pt.panels_to_nhwc(cal), STAGES)

        got = {}

        def keep(out, batch):
            for row, idx in enumerate(batch.event_idx[:batch.num_valid].tolist()):
                got[idx] = out[row].numpy()

        pipe = pt.InfeedPipeline(client, batch_size=B, device="cpu", batcher_buffers=6,
                                 metrics=metrics, max_wait_s=60.0)
        assert pipe.run(step, on_result=keep) == N
        out, _ = producer.communicate(timeout=60)
        assert producer.returncode == 0, out[-2000:]
    finally:
        tracing.TRACER.close()
        if client is not None:
            client.disconnect()
        for proc in (producer, server):
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                proc.wait(timeout=30)
    out, _ = server.communicate(timeout=30)
    assert server.returncode == 0, out[-2000:]
    return np.stack([got[i] for i in range(N)])


def _jax_logits(ped, gain, mask, raw, params):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from psana_ray_tpu.models import panels_to_nhwc
    from psana_ray_tpu.models.pallas_resnet import resnet_fused_infer
    from psana_ray_tpu.ops.pallas_calib import fused_calibrate

    jparams = {"params": jax.tree.map(jnp.asarray, params)}
    cal = fused_calibrate(jnp.asarray(raw), *(jnp.asarray(a) for a in (ped, gain, mask)),
                          threshold=10.0, out_dtype=jnp.bfloat16, interpret=True)
    return np.asarray(resnet_fused_infer(jparams, panels_to_nhwc(cal), stage_sizes=STAGES,
                                         interpret=True), np.float32)


def _frame_timelines(doc):
    """``{trace_id: {span name: (ts_us, dur_us)}}`` of the merged document."""
    out = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "frame":
            tid = int(e["args"]["trace_id"], 16)
            out.setdefault(tid, {})[e["name"]] = (e["ts"], e.get("dur", 0.0))
    return out


def test_traced_slice_equals_untraced_and_every_frame_has_its_spans(one_torch_thread,
                                                                     tmp_path):
    ped, gain, mask, raw, params = _inputs()
    npz = str(tmp_path / "frames.npz")
    np.savez(npz, frames=raw, photon_energy=np.full(N, 9.5))
    packed = pt.pack_fused(pt.resnet_from_flax(params, STAGES, device="cpu"))
    consts = tuple(torch.from_numpy(a) for a in (ped, gain, mask))
    plain = _serve(None, npz, consts, packed, pt.PipelineMetrics())
    trace_dir = str(tmp_path / "spools")
    metrics = pt.PipelineMetrics()
    traced = _serve(trace_dir, npz, consts, packed, metrics)
    assert np.array_equal(traced, plain)  # tracing changes no result
    ref = _jax_logits(ped, gain, mask, raw, params)
    err = float(np.max(np.abs(ref - traced)) / max(np.max(np.abs(ref)), 1e-3))
    print(f"logits rel_err {err}")
    assert np.isfinite(traced).all() and err < REL_TOL

    assert len(os.listdir(trace_dir)) == 3  # producer, queue server, consumer
    doc = trace_merge.merge([trace_dir])
    frames = _frame_timelines(doc)
    assert len(frames) == N
    worst = 0.0
    for tid, spans in frames.items():
        assert set(spans) == set(SPANS), (hex(tid), sorted(spans))
        starts = [spans[name][0] for name in SPANS]
        worst = max(worst, max(a - b for a, b in zip(starts, starts[1:])))
        assert all(spans[name][1] >= 0 for name in SPANS)
    print(f"largest step back in time {worst:.1f} us")
    assert worst <= ALIGN_TOL_US
    snap = metrics.stages.snapshot()
    assert {k: v["count"] for k, v in snap.items()} == {
        "dequeue": N, "batch": N, "device_put": N, "dispatch": N}
    exemplar = next(iter(snap["dispatch"]["exemplars"].values()))
    assert int(exemplar["trace_id"], 16) in frames  # a bucket's exemplar is a traced frame


def test_sigusr2_dumps(tmp_path):
    """Each SIGUSR2 dump appears whole: whenever a dump's name can be
    listed, its content is complete JSON."""
    fl = FlightRecorder()
    fl.install(str(tmp_path), process="t", excepthook=False)
    try:
        for n in range(1, 6):
            fl.record("eos_complete", n=n)
            os.kill(os.getpid(), signal.SIGUSR2)
            deadline = time.monotonic() + 10.0
            while True:
                names = sorted(f for f in os.listdir(tmp_path) if f.endswith(".json"))
                docs = [json.loads((tmp_path / f).read_text()) for f in names]
                if len(docs) == n:
                    break
                assert time.monotonic() < deadline, "SIGUSR2 did not produce a flight dump"
            doc = max(docs, key=lambda d: d["wall"])
            assert doc["reason"] == "signal" and doc["threads"]
            assert any(e["kind"] == "sigusr2" for e in doc["events"])
            fl._last_dump = 0.0
        assert not [f for f in os.listdir(tmp_path) if not f.endswith(".json")]
    finally:
        fl.uninstall()


def _imported_roots(stderr):
    """The top-level packages a ``-X importtime`` process imported."""
    return {line.rsplit("|", 1)[1].strip().split(".")[0] for line in stderr.splitlines()
            if line.startswith("import time:") and line.count("|") == 2}


def test_cli_processes_load_no_torch_with_the_observability_plane_on(tmp_path):
    """A queue server with its endpoint, history, tracer, flight recorder
    and stall detector, and a traced producer with its endpoint, run to
    the end with neither torch nor JAX imported."""
    port_file = str(tmp_path / "port")
    obs = ["--metrics_port", "0", "--history_interval", "0.1", "--trace_dir",
           str(tmp_path / "tr"), "--flight_dir", str(tmp_path / "fl")]
    env = {k: v for k, v in _env().items() if k != "JAX_PLATFORMS"}
    server = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m", "psana_ray_tpu_torch.queue_server", "--host",
         "127.0.0.1", "--port", "0", "--port_file", port_file, "--drain_s", "0",
         "--stall_poll_s", "0.1", *obs],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(port_file):
            assert server.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        producer = subprocess.run(
            [sys.executable, "-X", "importtime", "-m", "psana_ray_tpu_torch.producer",
             "--detector_name", "smoke_a", "--num_events", "4", "--num_consumers", "0",
             "--address", f"tcp://127.0.0.1:{open(port_file).read()}", "--trace_sample", "1",
             *obs[:2], *obs[4:]],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    finally:
        server.send_signal(signal.SIGTERM)
        _, server_err = server.communicate(timeout=30)
    assert producer.returncode == 0 and server.returncode == 0, server_err[-2000:]
    for err in (producer.stderr, server_err):
        roots = _imported_roots(err)
        assert "psana_ray_tpu_torch" in roots and not roots & {"torch", "jax"}
    assert len(os.listdir(tmp_path / "tr")) == 2  # the producer's and the server's spools
