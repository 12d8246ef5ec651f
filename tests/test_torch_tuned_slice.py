"""The tuned and the gateway-served slices as wholes, on the CPU.

SFX under autotune: the port's producer CLI replays seeded RAW smoke_a
events from an ``.npz`` through the port's queue server process
(``--workers 1 --durable_dir``, autotune on) into the SFX CLI in this
process (``--device cpu``, the smoke U-Net), twice: with ``--autotune
off`` and with ``--autotune on`` in all three processes. Both runs write
every event once, with equal peak sets; the tuned run's SFX process holds
the drain and pool knobs in its ``autotune`` source, and the server, over
its 'N' metrics RPC, the dials of the named durable queue it opened after
its daemon started.

The gateway: seeded RAW frames go through the port's queue server (in
this process) to ``ServingGateway.serve_queue`` on a tenanted client,
dispatched by ``make_batch_dispatch`` at operating points 1, 2 and 4 into
the calibration and a narrow fused ResNet. Every frame completes, none is
shed, and the logits stay within the fused nets' bound (``rel_err <
0.05``, as ``tests/test_pallas_resnet.py``) of the JAX package's pipeline
(its Pallas calibration and fused ResNet in interpret mode) on the same
frames and weights.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu_torch import sfx  # noqa: E402
from psana_ray_tpu_torch.obs.registry import MetricsRegistry  # noqa: E402
from psana_ray_tpu_torch.obs.timeseries import stop_default_history  # noqa: E402
from psana_ray_tpu_torch.producer import produce  # noqa: E402
from psana_ray_tpu_torch.serving import (  # noqa: E402
    GatewayTelemetry,
    ServingGateway,
    SloPolicy,
    make_batch_dispatch,
)
from psana_ray_tpu_torch.transport import RingBuffer  # noqa: E402
from psana_ray_tpu_torch.transport.tcp import TcpQueueClient, TcpQueueServer  # noqa: E402
from torch_parity import _no_lingering_child, one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 0.05
DET, FEATURES, N_EVENTS = "smoke_a", (8, 16), 24
TUNE = ["--autotune_interval", "0.25", "--history_interval", "0.1", "--profile_hz", "0",
        "--log_level", "WARNING"]


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


class _Sink:
    max_peaks = 32

    def __init__(self):
        self.sets = []

    def append(self, sets):
        self.sets.extend(sets)


def _start_server(tmp):
    port_file = os.path.join(tmp, "port")
    server = subprocess.Popen(
        [sys.executable, "-m", "psana_ray_tpu_torch.queue_server", "--host", "127.0.0.1",
         "--port", "0", "--port_file", port_file, "--workers", "1", "--durable_dir",
         os.path.join(tmp, "logs"), "--drain_s", "1", "--autotune", "on", *TUNE],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + 60
    while not os.path.exists(port_file):
        assert server.poll() is None and time.monotonic() < deadline, server.stdout.read()
        time.sleep(0.05)
    return server, int(open(port_file).read())


def _turn(port, tmp, npz, calib_npz, params, mode):
    """The producer CLI and the SFX CLI over the server, ``--autotune mode``."""
    address = f"tcp://127.0.0.1:{port}"
    queue = f"tuned_{mode}"
    producer = subprocess.Popen(
        [sys.executable, "-m", "psana_ray_tpu_torch.producer", "--exp", f"replay:{npz}",
         "--address", address, "--queue_name", queue, "--queue_size", "8", "--autotune", mode,
         *TUNE],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    sink = _Sink()
    try:
        args = sfx.parse_args([
            "--address", address, "--queue_name", queue, "--serving_params", params,
            "--output", os.path.join(tmp, f"{mode}.cxi"), "--calib_npz", calib_npz,
            "--batch", "4", "--peak_threshold", "0.45", "--max_peaks", "32",
            "--device", "cpu", "--autotune", mode, *TUNE])
        assert sfx.run(args, writer=sink) == 0
        tuned = MetricsRegistry.default().snapshot().get("autotune") if mode == "on" else None
    finally:
        stop_default_history()
        MetricsRegistry.default().unregister("autotune")
        out, _ = producer.communicate(timeout=60)
    assert producer.returncode == 0, out[-2000:]
    return sink.sets, tuned


def test_sfx_under_autotune_writes_every_event_with_the_untuned_peaks(tmp_path):
    src = pt.SyntheticSource(run=2, num_events=N_EVENTS, detector_name=DET, seed=5)
    events = list(src.iter_indexed_events("raw"))
    npz, calib_npz = str(tmp_path / "raw.npz"), str(tmp_path / "calib.npz")
    np.savez(npz, frames=np.stack([e[1] for e in events]),
             photon_energy=np.asarray([e[2] for e in events], np.float64))
    np.savez(calib_npz, pedestal=src.pedestal(), gain=src.spec.adu_gain * src.gain_map(),
             mask=src.create_bad_pixel_mask())
    params = str(tmp_path / "init.npz")
    pt.save_params(params, {"params": pt.init_peaknet_tpu_params(FEATURES, seed=0)})
    server, port = _start_server(str(tmp_path))
    try:
        off, _ = _turn(port, str(tmp_path), npz, calib_npz, params, "off")
        on, tuned = _turn(port, str(tmp_path), npz, calib_npz, params, "on")
        c = TcpQueueClient("127.0.0.1", port)
        try:
            served = c.cluster_rpc({"op": "metrics"})["metrics"]["autotune"]
        finally:
            c.disconnect()
    finally:
        server.send_signal(signal.SIGTERM)
        out, _ = server.communicate(timeout=60)
    assert server.returncode == 0, out[-3000:]
    for sets in (off, on):
        assert sorted(s.event_idx for s in sets) == list(range(N_EVENTS))
    key = {s.event_idx: s for s in off}
    peaks = 0
    for s in on:
        ref = key[s.event_idx]
        assert np.array_equal(s.y, ref.y) and np.array_equal(s.x, ref.x)
        assert np.array_equal(s.intensity, ref.intensity)
        peaks += s.n
    assert peaks > 0
    assert {"drain_chunk", "drain_poll_s", "bufpool_min_per_class"} <= set(tuned)
    assert tuned["mode"] == "on"
    # the server's dials: the default durable queue's, then each named
    # queue's as it opened after the daemon had started
    assert {"fsync_batch_n", "ram_items", "fsync_batch_n:default/tuned_on",
            "ram_items:default/tuned_off"} <= set(served)


N, P, H, W = 7, 2, 32, 32
STAGES = (1, 1, 1, 1)


def _inputs():
    rng = np.random.default_rng(31)
    ped = (100.0 + 3.0 * rng.standard_normal((P, H, W))).astype(np.float32)
    gain = (1.0 + 0.02 * rng.standard_normal((P, H, W))).astype(np.float32)
    mask = (rng.random((P, H, W)) > 0.01).astype(np.uint8)
    raw = (ped + 35.0 * rng.poisson(0.1, (N, P, H, W)) * gain
           + rng.normal(0, 2.5, (N, P, H, W))).astype(np.float32)
    params = pt.init_resnet_params(in_channels=P, stage_sizes=STAGES, width=16, seed=0)
    return ped, gain, mask, raw, params


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


def test_gateway_fed_resnet_matches_the_jax_pipeline():
    ped, gain, mask, raw, params = _inputs()
    packed = pt.pack_fused(pt.resnet_from_flax(params, STAGES, device="cpu"))
    consts = tuple(torch.from_numpy(a) for a in (ped, gain, mask))
    got, sizes = {}, []

    def consume(batch):
        sizes.append((batch.batch_size, batch.num_valid))
        frames = torch.from_numpy(batch.frames)
        cal = pt.fused_calibrate(frames, *consts, threshold=10.0, out_dtype=torch.bfloat16)
        out = pt.resnet_fused_infer(packed, pt.panels_to_nhwc(cal), STAGES)
        for row, idx in enumerate(batch.event_idx[:batch.num_valid].tolist()):
            got[idx] = out[row].float().numpy()

    srv = TcpQueueServer(RingBuffer(16), host="127.0.0.1").serve_background()
    producer = TcpQueueClient("127.0.0.1", srv.port)
    consumer = TcpQueueClient("127.0.0.1", srv.port, tenant="beamline", tenant_weight=2)
    try:
        feed = threading.Thread(target=produce, args=(((i, raw[i], 9.0) for i in range(N)),
                                                      producer), kwargs={"timeout": 30.0})
        feed.start()
        feed.join(timeout=30)  # all queued first: the backlog picks B4, then B2, then B1
        gw = ServingGateway(make_batch_dispatch(consume, n_buffers=6),
                            policy=SloPolicy(slo_ms=60_000.0,
                                             operating_points=((1, 1.0), (2, 2.0), (4, 4.0))),
                            telemetry=GatewayTelemetry(register=False))
        gw.serve_queue(consumer, tenant_of=lambda r: "beamline", max_wait_s=30.0)
    finally:
        producer.disconnect()
        consumer.disconnect()
        srv.shutdown()
    stats = gw.telemetry.stats()
    assert stats["offered_total"] == stats["completed_total"] == N
    assert stats["shed_total"] == 0 and gw.backlog() == 0
    assert sum(v for _, v in sizes) == N and {b for b, _ in sizes} <= {1, 2, 4}
    assert all(v <= b for b, v in sizes)
    ref = _jax_logits(ped, gain, mask, raw, params)
    logits = np.stack([got[i] for i in range(N)])
    assert np.isfinite(logits).all() and logits.shape == (N, 2)
    err = float(np.max(np.abs(ref - logits)) / max(np.max(np.abs(ref)), 1e-3))
    print(f"gateway logits rel_err {err}, dispatches {sizes}")  # pytest -rP
    assert err < REL_TOL
