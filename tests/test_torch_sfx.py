"""The port's SFX serving slice against the JAX package's, on the CPU.

The whole slice: the JAX package trains the smoke PeakNet-TPU as
``tests/test_sfx.py`` does (80 focal-loss steps on self-derived labels,
``norm="batch"``, then the exact BatchNorm fold), the tree is carried
over to the port, and the JAX ``SfxPipeline`` and the port's
``SfxPipeline(device="cpu")`` drain the same RAW events (calibrated on
the way by each package's fused calibration) into two CXI files.
Tolerances: per event, at least 95% of the peaks of either file match a
peak of the other within 1 px (bf16 activations take different rounding
paths in the two packages, which moves a few near-threshold peaks); the
port's file meets the reference's physics bar against the planted truth
(recall >= 0.6, precision >= 0.8). The host-side pieces (CXI layout,
cursor, tree inference) agree exactly.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu_torch.sources import SyntheticSource  # noqa: E402

DET = "smoke_a"
SEED = 5
FEATURES = (8, 16)
EVAL_RUN = 2  # training uses run 1
N_EVENTS = 12


def _train_serving_tree():
    """The JAX package's train -> serve recipe at smoke scale
    (``tests/test_sfx.py:34-75``), folded in memory: ``{"params": numpy}``."""
    import optax
    from flax.core import meta

    from psana_ray_tpu.models import PeakNetUNetTPU, fold_batchnorm, host_init, panels_to_nhwc
    from psana_ray_tpu.models.losses import masked_sigmoid_focal
    from psana_ray_tpu.parallel.steps import TrainState, make_train_step
    from psana_ray_tpu.sources import SyntheticSource as JaxSource

    src = JaxSource(num_events=1, detector_name=DET, seed=SEED)
    p, h, w = src.spec.frame_shape
    b, n_steps = 4, 80
    model = PeakNetUNetTPU(features=FEATURES, norm="batch", s2d=2)
    variables = meta.unbox(host_init(model, (b * p, h, w, 1)))
    opt = optax.adam(3e-3)
    opt_state = jax.jit(opt.init)({"params": variables["params"]})
    state = TrainState(variables, opt_state, jnp.zeros((), jnp.int32))
    step = make_train_step(
        model, opt, lambda lg, aux: masked_sigmoid_focal(lg, aux[0], aux[1], alpha=0.9))

    @jax.jit
    def prepare(frames):
        x = panels_to_nhwc(frames, mode="batch")
        return x, (x > 50.0).astype(jnp.float32)

    for s in range(n_steps):
        frames = np.stack([src.event(s * b + j)[0] for j in range(b)])
        x, tg = prepare(jnp.asarray(frames))
        state, _ = step(state, x, (tg, jnp.ones((b * p,), jnp.uint8)))
    return jax.tree.map(np.asarray, fold_batchnorm(state.variables))


@pytest.fixture(scope="module")
def serving_tree():
    return _train_serving_tree()


@pytest.fixture(scope="module")
def stream():
    """The RAW evaluation events and the calibration constants that take
    them back to photons."""
    src = SyntheticSource(run=EVAL_RUN, num_events=N_EVENTS, detector_name=DET, seed=SEED)
    events = list(src.iter_indexed_events("raw"))
    calib = (src.pedestal(), src.spec.adu_gain * src.gain_map(), src.create_bad_pixel_mask())
    return events, calib


def _port_ring(events):
    ring = pt.RingBuffer(maxsize=len(events) + 1)
    pt.produce(events, ring)
    return ring


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


def test_whole_slice_matches_the_jax_pipeline(serving_tree, stream, tmp_path):
    from psana_ray_tpu.cxi import CxiWriter as JaxWriter
    from psana_ray_tpu.cxi import read_cxi_peaks, read_cxi_peaksets
    from psana_ray_tpu.models.peaks import peak_metrics
    from psana_ray_tpu.records import EndOfStream, FrameRecord
    from psana_ray_tpu.sfx import SfxConfig as JaxConfig
    from psana_ray_tpu.sfx import SfxPipeline as JaxPipeline
    from psana_ray_tpu.transport.ring import RingBuffer

    events, calib = stream
    jring = RingBuffer(maxsize=N_EVENTS + 1)
    for idx, data, energy in events:
        assert jring.put(FrameRecord(0, idx, data, energy))
    assert jring.put(EndOfStream(total_events=N_EVENTS))
    jax_cxi, port_cxi = str(tmp_path / "jax.cxi"), str(tmp_path / "port.cxi")
    with JaxWriter(jax_cxi, max_peaks=64) as w:
        jpipe = JaxPipeline(serving_tree, w, calib=calib, config=JaxConfig(batch_size=4))
        assert jpipe.run(jring) == N_EVENTS

    with pt.CxiWriter(port_cxi, max_peaks=64) as w:
        pipe = pt.SfxPipeline(serving_tree, w, features=FEATURES, calib=calib,
                              config=pt.SfxConfig(batch_size=4), device="cpu")
        assert pipe.run(_port_ring(events)) == N_EVENTS
    assert pipe.metrics.batches == N_EVENTS // 4 and pipe.n_peaks > 0

    ours = {s.event_idx: s for s in read_cxi_peaksets(port_cxi)}
    theirs = {s.event_idx: s for s in read_cxi_peaksets(jax_cxi)}
    assert sorted(ours) == sorted(theirs) == list(range(N_EVENTS))
    shares = []
    for e in range(N_EVENTS):
        a = np.stack([ours[e].y, ours[e].x], 1)
        b = np.stack([theirs[e].y, theirs[e].x], 1)
        hits = _match(a, b)
        shares.append(min(hits / max(len(a), 1), hits / max(len(b), 1)))
        assert ours[e].photon_energy == pytest.approx(theirs[e].photon_energy)
    print(f"per-event peak agreement {shares}")  # observed values: pytest -rP
    assert min(shares) >= 0.95, shares

    # the physics bar, against the planted truth in raw coordinates
    n, x, y, _, event_idx = read_cxi_peaks(port_cxi)
    h = pt.DETECTORS[DET].height
    src = SyntheticSource(run=EVAL_RUN, num_events=N_EVENTS, detector_name=DET, seed=SEED)
    truth = []
    for e in event_idx:
        t = src.event_with_truth(int(e))[2].copy()
        t[:, 1] = t[:, 0] * h + t[:, 1]
        t[:, 0] = 0
        truth.append(t)
    m = peak_metrics(np.stack([y, x], axis=-1), n, truth, tolerance=3.0, min_amplitude=100.0)
    print(f"physics {m}")
    assert m["recall"] >= 0.6 and m["precision"] >= 0.8, m


def test_cxi_files_read_back_through_the_jax_readers(tmp_path):
    from psana_ray_tpu.cxi import read_cxi_peaksets

    path = str(tmp_path / "port.cxi")

    def mk(i):
        k = i % 3
        return pt.PeakSet(event_idx=i, shard_rank=i % 2, y=np.arange(k, dtype=np.float32) + i,
                          x=np.arange(k, dtype=np.float32) * 2, intensity=np.full(k, 0.5, np.float32),
                          photon_energy=9.0 + i)

    with pt.CxiWriter(path, max_peaks=4) as w:
        w.append([mk(0), mk(1), mk(2)])
        assert w.n_events == 3
    with pt.CxiWriter(path, max_peaks=4, mode="a") as w:
        assert w.n_events == 3
        w.append([mk(3), mk(4)])
    back = read_cxi_peaksets(path)
    assert [s.event_idx for s in back] == [0, 1, 2, 3, 4]
    for s in back:
        want = mk(s.event_idx)
        assert s.shard_rank == want.shard_rank
        np.testing.assert_array_equal(s.y, want.y)
        np.testing.assert_array_equal(s.x, want.x)
        np.testing.assert_array_equal(s.intensity, want.intensity)
        assert s.photon_energy == pytest.approx(want.photon_energy)
    with pytest.raises(ValueError, match="max_peaks"):
        pt.CxiWriter(path, max_peaks=8, mode="a")
    import h5py

    foreign = str(tmp_path / "foreign.h5")
    with h5py.File(foreign, "w") as f:
        f.create_dataset("x", data=np.zeros(3))
    with pytest.raises(ValueError, match="not a CxiWriter file"):
        pt.CxiWriter(foreign, mode="a")


def test_stream_cursor_matches_the_jax_cursor(rng, tmp_path):
    from psana_ray_tpu.checkpoint import StreamCursor as JaxCursor

    ours, theirs = pt.StreamCursor(stride=3), JaxCursor(stride=3)
    order = rng.permutation(60)
    for idx in order:
        rank = int(idx) % 3
        ours.advance(rank, int(idx))
        theirs.advance(rank, int(idx))
        assert ours.positions == theirs.positions
        for r in range(3):
            assert ours.resume_point(r) == theirs.resume_point(r)
            assert ours.pending_count(r) == theirs.pending_count(r)
    ours.advance(0, 0)  # a duplicate is ignored
    with pytest.raises(ValueError):
        ours.advance(1, 3)
    a, b = str(tmp_path / "a.cursor"), str(tmp_path / "b.cursor")
    ours.save(a)
    theirs.save(b)
    assert json.load(open(a)) == json.load(open(b))
    assert JaxCursor.load(a).positions == ours.positions
    assert pt.StreamCursor.load(b).positions == theirs.positions
    assert pt.StreamCursor.load(str(tmp_path / "none")).positions == {}


def test_max_events_bound_drains_in_flight_batch(serving_tree, stream, tmp_path):
    """As in the JAX package: the run stops near the bound, overshooting by
    at most one batch plus the one in flight, and the saved cursor covers
    exactly what was written."""
    from psana_ray_tpu.cxi import read_cxi_peaks

    events, calib = stream
    cxi, cursor_path = str(tmp_path / "bounded.cxi"), str(tmp_path / "bounded.cursor")
    with pt.CxiWriter(cxi, max_peaks=32) as w:
        pipe = pt.SfxPipeline(serving_tree, w, calib=calib, config=pt.SfxConfig(batch_size=2),
                              device="cpu")
        n = pipe.run(_port_ring(events), cursor=pt.StreamCursor(stride=1),
                     cursor_path=cursor_path, max_events=5)
    assert 5 <= n <= 5 + 2 * 2 - 1
    assert len(read_cxi_peaks(cxi)[0]) == n
    assert pt.StreamCursor.load(cursor_path).resume_point(0) == n


def test_tree_inference_and_refusals(serving_tree, tmp_path):
    from psana_ray_tpu.sfx import infer_features, infer_s2d

    params = serving_tree["params"]
    assert pt.infer_s2d(params) == infer_s2d(params) == 2
    assert pt.infer_features(params) == infer_features(params) == FEATURES
    with pytest.raises(ValueError, match="logits"):
        pt.infer_s2d({"not": "a tree"})
    with pytest.raises(ValueError, match="ConvBlock_0"):
        pt.infer_features({"not": "a tree"})
    with pt.CxiWriter(str(tmp_path / "x.cxi")) as w:
        with pytest.raises(ValueError, match="does not match the checkpoint"):
            pt.SfxPipeline(serving_tree, w, features=(4, 8), device="cpu")
        if not torch.cuda.is_available():
            # the card is the default: without one, the caller must ask for the CPU
            with pytest.raises(RuntimeError, match="device='cpu'"):
                pt.SfxPipeline(serving_tree, w)


def test_process_batch_equals_run(serving_tree, stream):
    """The serial ``process_batch`` writes what the pipelined ``run`` does."""

    class Sink:
        max_peaks = 64

        def __init__(self):
            self.sets = []

        def append(self, sets):
            self.sets.extend(sets)

    events, calib = stream
    a, b = Sink(), Sink()
    cfg = pt.SfxConfig(batch_size=4)
    pt.SfxPipeline(serving_tree, a, calib=calib, config=cfg, device="cpu").run(_port_ring(events))
    serial = pt.SfxPipeline(serving_tree, b, calib=calib, config=cfg, device="cpu")
    batcher = pt.FrameBatcher(4)
    for idx, data, energy in events:
        out = batcher.push(pt.FrameRecord(0, idx, data, energy))
        if out is not None:
            serial.process_batch(out)
    assert [s.event_idx for s in a.sets] == [s.event_idx for s in b.sets]
    for s, t in zip(a.sets, b.sets):
        np.testing.assert_array_equal(s.y, t.y)
        np.testing.assert_array_equal(s.intensity, t.intensity)
