"""The ResNet slice fed across the TCP transport.

The same seeded RAW frames go through the port's ``InfeedPipeline``
three times: from an in-process ``RingBuffer``, and across ``tcp://``
(a windowed producer client into the port's queue server, a streamed
consumer client out), raw and compressed with ``shuffle-rle``. The
logits over TCP equal the in-process logits bit for bit, and stay within
the fused nets' bound (``rel_err < 0.05``) of the JAX package's pipeline
(its Pallas calibration and fused ResNet in interpret mode) on the same
weights.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu_torch.producer import produce  # noqa: E402
from psana_ray_tpu_torch.transport import RingBuffer  # noqa: E402
from psana_ray_tpu_torch.transport.tcp import TcpQueueClient, TcpQueueServer  # noqa: E402

REL_TOL = 0.05
STAGES = (1, 1, 1, 1)
N, B, P, H, W = 6, 4, 2, 32, 32


def _inputs():
    rng = np.random.default_rng(13)
    ped = (100.0 + 3.0 * rng.standard_normal((P, H, W))).astype(np.float32)
    gain = (1.0 + 0.02 * rng.standard_normal((P, H, W))).astype(np.float32)
    mask = (rng.random((P, H, W)) > 0.01).astype(np.uint8)
    raw = (ped + 35.0 * rng.poisson(0.1, (N, P, H, W)) * gain
           + rng.normal(0, 2.5, (N, P, H, W))).astype(np.float32)
    params = pt.init_resnet_params(in_channels=P, stage_sizes=STAGES, width=16, seed=0)
    return ped, gain, mask, raw, params


def _port_logits(queue, ped, gain, mask, params):
    packed = pt.pack_fused(pt.resnet_from_flax(params, STAGES, device="cpu"))
    consts = tuple(torch.from_numpy(a) for a in (ped, gain, mask))

    def step(batch):
        cal = pt.fused_calibrate(batch.frames, *consts, threshold=10.0, out_dtype=torch.bfloat16)
        return pt.resnet_fused_infer(packed, pt.panels_to_nhwc(cal), STAGES)

    got = {}

    def keep(out, batch):
        for row, idx in enumerate(batch.event_idx[:batch.num_valid].tolist()):
            got[idx] = out[row].numpy()

    assert pt.InfeedPipeline(queue, batch_size=B, device="cpu", batcher_buffers=6).run(
        step, on_result=keep) == N
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


def _over_tcp(raw, codec, consts_params):
    srv = TcpQueueServer(RingBuffer(4), host="127.0.0.1").serve_background()
    producer = TcpQueueClient("127.0.0.1", srv.port, codec=codec)
    consumer = TcpQueueClient("127.0.0.1", srv.port, codec=codec)
    try:
        consumer.stream_open(3)
        feed = threading.Thread(target=produce, args=(((i, raw[i], 9.0) for i in range(N)),
                                                      producer), kwargs={"timeout": 30.0})
        feed.start()
        logits = _port_logits(consumer, *consts_params)
        feed.join(timeout=30)
        assert consumer._stream is not None  # the batcher drained the push stream
        assert producer.codec_name == codec
        return logits
    finally:
        producer.disconnect()
        consumer.disconnect()
        srv.shutdown()


def test_tcp_fed_slice_equals_in_process_and_matches_the_jax_pipeline():
    ped, gain, mask, raw, params = _inputs()
    ring = RingBuffer(N + 1)
    produce(((i, raw[i], 9.0) for i in range(N)), ring)
    in_process = _port_logits(ring, ped, gain, mask, params)
    for codec in (None, "shuffle-rle"):
        tcp = _over_tcp(raw, codec, (ped, gain, mask, params))
        assert np.array_equal(tcp, in_process), codec  # bit-equal
    ref = _jax_logits(ped, gain, mask, raw, params)
    assert np.isfinite(in_process).all() and in_process.shape == (N, 2)
    err = float(np.max(np.abs(ref - in_process)) / max(np.max(np.abs(ref)), 1e-3))
    print(f"logits rel_err {err}")  # observed values: pytest -rP
    assert err < REL_TOL
