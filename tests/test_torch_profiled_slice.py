"""The ResNet slice with every process profiled, on the CPU.

The port's producer CLI replays seeded RAW frames from an ``.npz``
through the port's queue server process to the port's ``InfeedPipeline``
in this process, twice: with ``--profile_hz 0`` everywhere, and with the
default 97 Hz profiler in all three processes (a sampler here too), each
spooling into one directory. The profiled logits equal the unprofiled
ones exactly and stay within the fused nets' bound (``rel_err < 0.05``)
of the JAX package's pipeline (its Pallas calibration and fused ResNet in
interpret mode). The three spools merge, into the same document by either
package's ``prof_merge``; ``obs.top --once`` shows the server's CPU% and
BUSY%; and the server and producer processes, profiled by default, load
no torch.
"""

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
from psana_ray_tpu.obs import prof_merge as jax_merge  # noqa: E402
from psana_ray_tpu_torch.obs import prof_merge, profiling  # noqa: E402
from psana_ray_tpu_torch.transport.tcp import TcpQueueClient  # noqa: E402
from torch_parity import _no_lingering_child, one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 0.05
STAGES = (1, 1, 1, 1)
N, B, P, H, W = 8, 4, 2, 32, 32
# the server's queue holds fewer frames than the producer sends, so the
# producer waits on a full queue, its sampler running, for at least
# HOLD_S before the pipeline drains it: replaying N frames alone ends
# within a sampling period, and under load with no sample taken
QUEUE = 2
HOLD_S = 0.5
WAIT_S = 60.0  # the bound of every wait on another process


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _inputs():
    rng = np.random.default_rng(23)
    ped = (100.0 + 3.0 * rng.standard_normal((P, H, W))).astype(np.float32)
    gain = (1.0 + 0.02 * rng.standard_normal((P, H, W))).astype(np.float32)
    mask = (rng.random((P, H, W)) > 0.01).astype(np.uint8)
    raw = (ped + 35.0 * rng.poisson(0.1, (N, P, H, W)) * gain
           + rng.normal(0, 2.5, (N, P, H, W))).astype(np.float32)
    params = pt.init_resnet_params(in_channels=P, stage_sizes=STAGES, width=16, seed=0)
    return ped, gain, mask, raw, params


def _serve(prof_dir, npz, consts, packed):
    """One run: a queue server process, the producer CLI replaying ``npz``
    and the pipeline here, all three profiled into ``prof_dir`` (None:
    ``--profile_hz 0``). Returns the logits by event index and, profiled,
    the console's first frame that shows the server's CPU% and BUSY%."""
    port_file = os.path.join(tempfile.mkdtemp(dir=os.path.dirname(npz)), "port")
    prof = ["--profile_hz", "0"] if prof_dir is None else ["--profile_dir", prof_dir]
    server = subprocess.Popen(
        [sys.executable, "-m", "psana_ray_tpu_torch.queue_server", "--host", "127.0.0.1",
         "--port", "0", "--port_file", port_file, "--drain_s", "1", *prof],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    producer = client = None
    frame = None
    try:
        deadline = time.monotonic() + WAIT_S
        while not os.path.exists(port_file):
            assert server.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        port = int(open(port_file).read())
        client = TcpQueueClient("127.0.0.1", port, queue_name="shared_queue", maxsize=QUEUE)
        metrics = pt.PipelineMetrics()
        if prof_dir is not None:
            profiling.start_default_profiler(spool_dir=prof_dir, process="serving",
                                             frames_fn=lambda: metrics.frames.count)
        producer = subprocess.Popen(
            [sys.executable, "-m", "psana_ray_tpu_torch.producer", "--exp", f"replay:{npz}",
             "--address", f"tcp://127.0.0.1:{port}", "--queue_size", str(QUEUE), *prof],
            env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        deadline = time.monotonic() + WAIT_S
        while client.size() < QUEUE:
            assert producer.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        time.sleep(HOLD_S)
        assert producer.poll() is None  # still waiting on the full queue
        client.stream_open(4)

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
        out, _ = producer.communicate(timeout=WAIT_S)
        assert producer.returncode == 0, out[-2000:]
        if prof_dir is not None:
            # the server's CPU% and BUSY% come with its first cost-model
            # tick: poll the console until a frame shows them
            deadline = time.monotonic() + WAIT_S
            while True:
                top = subprocess.run(
                    [sys.executable, "-m", "psana_ray_tpu_torch.obs.top", "--peers",
                     f"127.0.0.1:{port}", "--once", "--settle", "0.3"],
                    env=_env(), cwd=REPO, capture_output=True, text=True, timeout=WAIT_S)
                assert top.returncode == 0, top.stderr[-2000:]
                frame = top.stdout
                if _server_row(frame)[0] or time.monotonic() > deadline:
                    break
                time.sleep(0.5)
    finally:
        profiling.stop_default_profiler()
        if client is not None:
            client.disconnect()
        for proc in (producer, server):
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                proc.wait(timeout=WAIT_S)
    out, _ = server.communicate(timeout=WAIT_S)
    assert server.returncode == 0, out[-2000:]
    return np.stack([got[i] for i in range(N)]), frame


def _server_row(frame):
    """(CPU% and BUSY% both shown, the row's fields) of the server's row
    in an ``obs.top`` frame."""
    lines = frame.splitlines()
    head = next(ln for ln in lines if ln.startswith("PEER")).split()
    row = next(ln for ln in lines if ln.startswith("127.0.0.1:")).split()
    return row[head.index("CPU%")] != "-" and row[head.index("BUSY%")] != "-", row


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


def test_profiled_slice_equals_unprofiled_and_every_process_spools(one_torch_thread, tmp_path):
    ped, gain, mask, raw, params = _inputs()
    npz = str(tmp_path / "frames.npz")
    np.savez(npz, frames=raw, photon_energy=np.full(N, 9.5))
    packed = pt.pack_fused(pt.resnet_from_flax(params, STAGES, device="cpu"))
    consts = tuple(torch.from_numpy(a) for a in (ped, gain, mask))
    plain, _ = _serve(None, npz, consts, packed)
    prof_dir = str(tmp_path / "prof")
    profiled, frame = _serve(prof_dir, npz, consts, packed)
    assert np.array_equal(profiled, plain)  # profiling changes no result
    ref = _jax_logits(ped, gain, mask, raw, params)
    err = float(np.max(np.abs(ref - profiled)) / max(np.max(np.abs(ref)), 1e-3))
    print(f"logits rel_err {err}")
    assert np.isfinite(profiled).all() and err < REL_TOL

    names = sorted(n.split("-")[0] for n in os.listdir(prof_dir))
    assert names == ["producer", "queue_server", "serving"], names
    doc = prof_merge.merge([prof_dir])
    assert doc == jax_merge.merge([prof_dir])
    procs = {p["process"].split(":")[0]: p for p in doc["profile"]["processes"]}
    assert set(procs) == {"producer", "queue_server", "serving"}
    assert all(p["samples"] > 0 for p in procs.values())
    assert "dispatch" in procs["queue_server"]["stage_cpu_ms"]
    print({name: p["stage_cpu_ms"] for name, p in procs.items()})  # pytest -rP

    shown, row = _server_row(frame)
    assert row[1] == "up" and shown


def _imported_roots(stderr):
    """The top-level packages a ``-X importtime`` process imported."""
    return {line.rsplit("|", 1)[1].strip().split(".")[0] for line in stderr.splitlines()
            if line.startswith("import time:") and line.count("|") == 2}


def test_cli_processes_load_no_torch_with_the_profiler_on_by_default(tmp_path):
    port_file = str(tmp_path / "port")
    spools = str(tmp_path / "prof")
    env = {k: v for k, v in _env().items() if k != "JAX_PLATFORMS"}
    server = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m", "psana_ray_tpu_torch.queue_server", "--host",
         "127.0.0.1", "--port", "0", "--port_file", port_file, "--drain_s", "0",
         "--profile_dir", spools],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(port_file):
            assert server.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        producer = subprocess.run(
            [sys.executable, "-X", "importtime", "-m", "psana_ray_tpu_torch.producer",
             "--detector_name", "smoke_a", "--num_events", "4", "--num_consumers", "0",
             "--address", f"tcp://127.0.0.1:{open(port_file).read()}", "--profile_dir", spools],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    finally:
        server.send_signal(signal.SIGTERM)
        _, server_err = server.communicate(timeout=30)
    assert producer.returncode == 0 and server.returncode == 0, server_err[-2000:]
    for err in (producer.stderr, server_err):
        roots = _imported_roots(err)
        assert "psana_ray_tpu_torch" in roots and not roots & {"torch", "jax"}
    assert sorted(n.split("-")[0] for n in os.listdir(spools)) == ["producer", "queue_server"]
