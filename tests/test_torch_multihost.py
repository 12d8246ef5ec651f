"""The port's multi-host infeed against the JAX package's.

On one host (a one-rank gloo group in this process, beside the JAX
consumer on the virtual CPU mesh of ``tests/conftest.py``), on the same
records: every non-``slow`` case of ``tests/test_multihost.py`` (the
degenerate single host, the wedge and the stall that degrade then raise,
a stalled leg beside a healthy one, the multi-detector consumer, the step
coverage check), ``make_global_batch`` (``tests/test_infeed.py``), the
legs' registration (``tests/test_obs.py``), the batcher's stall signal
and ``drive_step``'s bytes. Both give the same ``n_local``, the same
rounds and outputs equal to rtol 1e-6 (the frames hold small integers,
so the masked row sums are exact in f32 in any order).

On 2 and 4 gloo ranks (spawned once each, ``tests/torch_multirank.py``):
the reference's ``stream`` and ``fanin`` scenarios
(``tests/multihost_worker.py``) with uneven tails, a host with no frame,
a ``(2, 2)`` mesh (two hosts of two ranks: the leader reads, the follower
receives), and a wedge on one host. Each rank's rows of every round equal
those of the JAX ``make_global_Batch`` + step on the concatenated local
batches (the JAX ``_local_rounds`` of each host's queue), rtol 1e-6;
every rank ends on the same round, only the faulted host's ranks raise,
and no step gathers rows. The slice: config 4's chain at a small size
(K1, ``panels_to_nhwc``, a frozen-affine ResNet of width 16 from the flax
tree) through ``GlobalStreamConsumer`` on 2 gloo ranks against the JAX
``fused_calibrate`` and ``resnet_fused_infer`` in interpret mode on the
concatenated rows: logits ``rel_err < 0.05`` (bf16,
``tests/test_pallas_resnet.py:106``), calibration rtol 1e-5, atol 1e-4
(``tests/test_ops.py:114``).
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

import psana_ray_tpu.infeed.multihost as jmh  # noqa: E402
from psana_ray_tpu.infeed.batcher import Batch as JBatch  # noqa: E402
from psana_ray_tpu.infeed.batcher import StreamStalled as JStreamStalled  # noqa: E402
from psana_ray_tpu.infeed.batcher import batches_from_queue as jax_batches  # noqa: E402
from psana_ray_tpu.infeed.pipeline import drive_step as jax_drive_step  # noqa: E402
from psana_ray_tpu.obs.flight import FLIGHT as JFLIGHT  # noqa: E402
from psana_ray_tpu.parallel import create_mesh as jax_create_mesh  # noqa: E402
from psana_ray_tpu.records import EndOfStream as JEos, FrameRecord as JRecord  # noqa: E402
from psana_ray_tpu.transport.registry import TransportWedged as JWedged  # noqa: E402
from psana_ray_tpu.utils.metrics import PipelineMetrics as JMetrics  # noqa: E402
import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu_torch.infeed import multihost as mh  # noqa: E402
from psana_ray_tpu_torch.infeed.batcher import StreamStalled  # noqa: E402
from psana_ray_tpu_torch.infeed.batcher import batches_from_queue as port_batches  # noqa: E402
from psana_ray_tpu_torch.infeed.pipeline import drive_step as port_drive_step  # noqa: E402
from psana_ray_tpu_torch.obs.flight import FLIGHT  # noqa: E402
from psana_ray_tpu_torch.obs.registry import MetricsRegistry  # noqa: E402
from psana_ray_tpu_torch.parallel import compat  # noqa: E402
from psana_ray_tpu_torch.parallel import mesh as pm  # noqa: E402
from psana_ray_tpu_torch.parallel.steps import make_infer_step  # noqa: E402
from psana_ray_tpu_torch.records import EndOfStream, FrameRecord  # noqa: E402
from psana_ray_tpu_torch.transport.registry import TransportWedged  # noqa: E402
from torch_multirank import run_ranks  # noqa: E402
from torch_parity import _no_lingering_child, one_torch_thread, rel_err  # noqa: E402,F401
from torch_rank_cases import ScriptedQueue, host_items, masked_rows_step  # noqa: E402

ROW_TOL = dict(rtol=1e-6, atol=0.0)
CALIB_TOL = dict(rtol=1e-5, atol=1e-4)
LOGIT_TOL = 0.05
FIELDS = ("frames", "valid", "shard_rank", "event_idx", "photon_energy")


def _frames(seed, n, shape, rank=0, first=0):
    """``n`` records' ``(shard_rank, event_idx, frame)``: small positive
    integers in f32, so every masked sum is exact."""
    rng = np.random.default_rng(seed)
    return [(rank, first + i, rng.integers(1, 64, shape).astype(np.float32)) for i in range(n)]


def _host(seed, n, shape, end="eos", rank=0, first=0, **extra):
    return {"frames": _frames(seed, n, shape, rank, first), "end": end, **extra}


def _queues(host):
    """The same items as a JAX-package queue and a port queue."""
    then = host["end"] == "wedge"
    return (ScriptedQueue(host_items(JRecord, host["frames"], host["end"], JEos),
                          then=JWedged if then else None),
            ScriptedQueue(host_items(FrameRecord, host["frames"], host["end"], EndOfStream),
                          then=TransportWedged if then else None))


@jax.jit
def _jax_row_sums(frames, valid):
    m = valid.astype(jnp.float32).reshape(-1, *([1] * (frames.ndim - 1)))
    return jnp.sum(frames * m, axis=tuple(range(1, frames.ndim)))


def _jax_step(b):
    return _jax_row_sums(b.frames, b.valid)


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_create_mesh(("data",), (8,))


@pytest.fixture(scope="module")
def port_mesh(one_torch_thread):
    """A one-rank gloo group in this process: the single host."""
    pm.init_process_group(0, 1, pm.free_port(), device="cpu")
    try:
        yield pm.create_mesh(("data",), (1,), device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture
def port_registry():
    MetricsRegistry.reset_default()
    yield MetricsRegistry.default()
    MetricsRegistry.reset_default()


def _run_both(jax_mesh, port_mesh, host, local_bs=8, **kw):
    """One stream through each package's ``GlobalStreamConsumer``: per
    package ``(n_local or the exception raised, [round outputs],
    [round valid masks], bytes counted)``."""
    jq, pq = _queues(host)
    results = []
    for cls, q, mesh, step, to_np in (
            (jmh.GlobalStreamConsumer, jq, jax_mesh, _jax_step, np.asarray),
            (mh.GlobalStreamConsumer, pq, port_mesh, masked_rows_step(port_mesh),
             lambda t: t.to_local().numpy())):
        c = cls(q, local_batch_size=local_bs, mesh=mesh, frame_shape=host["frames"][0][2].shape,
                **kw)
        outs, valid = [], []
        try:
            got = c.run(step, on_result=lambda o, g: (outs.append(to_np(o)),
                                                      valid.append(to_np(g.valid))))
        except Exception as e:  # noqa: BLE001 (compared below)
            got = e
        results.append((got, outs, valid, c.metrics.bytes.count))
    return results


def _same_rounds(jax_side, port_side):
    (jgot, jouts, jvalid, jbytes), (pgot, pouts, pvalid, pbytes) = jax_side, port_side
    assert len(pouts) == len(jouts) > 0
    for a, b in zip(jouts, pouts):
        np.testing.assert_allclose(b, a, **ROW_TOL)
    for a, b in zip(jvalid, pvalid):
        np.testing.assert_array_equal(b, a)
    assert pbytes == jbytes  # this host's ingest bytes, not the global batch's
    if isinstance(jgot, Exception):
        assert type(pgot).__name__ == type(jgot).__name__ and str(pgot) == str(jgot)
    else:
        assert pgot == jgot


# -- one host ------------------------------------------------------------------


def test_global_stream_consumer_single_host_degenerate(jax_mesh, port_mesh):
    """11 frames at local batch 8: a padded tail round, then the stop."""
    jax_side, port_side = _run_both(jax_mesh, port_mesh, _host(1, 11, (1, 4, 8)))
    _same_rounds(jax_side, port_side)
    assert port_side[0] == 11 and len(port_side[1]) == 2


def test_global_stream_consumer_wedge_degrades_then_raises(jax_mesh, port_mesh):
    """A wedged transport: no step runs on garbage, the loop ends, and the
    wedge is raised after it, in both packages."""
    calls = {"jax": [], "port": []}
    for name, cls, mesh, q in (("jax", jmh.GlobalStreamConsumer, jax_mesh,
                                ScriptedQueue([], then=JWedged)),
                               ("port", mh.GlobalStreamConsumer, port_mesh,
                                ScriptedQueue([], then=TransportWedged))):
        c = cls(q, local_batch_size=8, mesh=mesh, frame_shape=(1, 4, 8))
        with pytest.raises(JWedged if name == "jax" else TransportWedged):
            c.run(lambda b, name=name: calls[name].append(b))
    assert calls == {"jax": [], "port": []}


def test_global_stream_consumer_stall_timeout_degrades_then_raises(jax_mesh, port_mesh):
    """A silent leg with ``stall_timeout_s``: its pre-stall batch is
    stepped, then ``StreamStalled`` ("no EOS") after the wind-down."""
    host = _host(2, 8, (1, 4, 8), end="stall")
    jax_side, port_side = _run_both(jax_mesh, port_mesh, host, poll_interval_s=0.01,
                                    stall_timeout_s=0.3)
    assert isinstance(jax_side[0], JStreamStalled) and isinstance(port_side[0], StreamStalled)
    assert "no EOS" in str(port_side[0])
    _same_rounds(jax_side, port_side)
    assert sum(int(v.sum()) for v in port_side[2]) == 8


def _run_legs_both(jax_mesh, port_mesh, legs, local_bs=8):
    """``legs`` ({name: host}) through each package's
    ``MultiDetectorGlobalConsumer``: per package (counts or the exception
    raised, {leg: [round outputs]})."""
    results = []
    for pkg, mesh, step, to_np in (("jax", jax_mesh, _jax_step, np.asarray),
                                   ("port", port_mesh, masked_rows_step(port_mesh),
                                    lambda t: t.to_local().numpy())):
        mod = jmh if pkg == "jax" else mh
        consumers = {}
        for name, host in legs.items():
            q = _queues(host)[pkg == "port"]
            consumers[name] = mod.GlobalStreamConsumer(
                q, local_batch_size=local_bs, mesh=mesh, frame_shape=host["frames"][0][2].shape,
                poll_interval_s=0.01, stall_timeout_s=host.get("stall_s"))
        outs = {name: [] for name in legs}
        try:
            got = mod.MultiDetectorGlobalConsumer(consumers).run(
                {name: step for name in legs},
                on_result=lambda name, o, g: outs[name].append(to_np(o)))
        except Exception as e:  # noqa: BLE001 (compared below)
            got = e
        results.append((got, outs))
    return results


def _same_legs(jax_side, port_side):
    (jgot, jouts), (pgot, pouts) = jax_side, port_side
    for name in jouts:
        assert len(pouts[name]) == len(jouts[name]), name
        for a, b in zip(jouts[name], pouts[name]):
            np.testing.assert_allclose(b, a, **ROW_TOL)
    if isinstance(jgot, Exception):
        assert type(pgot).__name__ == type(jgot).__name__
    else:
        assert pgot == jgot


def test_multi_detector_global_consumer_single_host(jax_mesh, port_mesh):
    """Two detectors of different geometries and lengths."""
    legs = {"a": _host(3, 10, (1, 4, 8)), "b": _host(4, 5, (2, 2, 8))}
    jax_side, port_side = _run_legs_both(jax_mesh, port_mesh, legs)
    _same_legs(jax_side, port_side)
    assert port_side[0] == {"a": 10, "b": 5}


def test_multi_detector_stalled_leg_does_not_block_healthy_legs(jax_mesh, port_mesh):
    """The stalled leg degrades to padding while the healthy one streams
    to its end; the stall is raised after the loop."""
    legs = {"healthy": _host(5, 20, (1, 4, 8)),
            "stalled": _host(6, 3, (1, 4, 8), end="stall", stall_s=0.3)}
    jax_side, port_side = _run_legs_both(jax_mesh, port_mesh, legs)
    assert isinstance(port_side[0], StreamStalled)
    _same_legs(jax_side, port_side)
    assert len(port_side[1]["healthy"]) == 3 and len(port_side[1]["stalled"]) == 1


def test_multi_detector_requires_step_coverage(jax_mesh, port_mesh):
    for mod, mesh, q in ((jmh, jax_mesh, ScriptedQueue([])), (mh, port_mesh, ScriptedQueue([]))):
        leg = mod.GlobalStreamConsumer(q, local_batch_size=2, mesh=mesh, frame_shape=(1, 4, 4))
        with pytest.raises(KeyError, match="no step"):
            mod.MultiDetectorGlobalConsumer({"a": leg}).run({})


def test_make_global_batch_single_process(port_mesh):
    """``tests/test_infeed.py``'s single-process case: the rows as they
    were, placed ``P("data")`` (``Shard(0)`` on ``data``, replicated on
    ``model``), with no collective."""
    local = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    want = jmh.make_global_batch(local, jax_create_mesh(("data", "model"), (8, 1)))
    mesh = pm.create_mesh(("data", "model"), (1, 1), device_type="cpu")
    compat.reset_collectives()
    got = pt.make_global_batch(local, mesh)
    assert compat.collective_counts() == {}
    assert tuple(got.shape) == want.shape == (8, 4)
    assert [str(p) for p in got.placements] == ["S(0)", "R"]
    assert pt.batch_sharding(mesh) == list(got.placements)
    np.testing.assert_array_equal(got.to_local().numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="hosts"):
        pt.make_global_batch(local, mesh, global_batch_size=16)


def test_make_global_Batch_shards_every_field_alike(jax_mesh, port_mesh):
    """Frames, valid and the row metadata sharded alike; ``num_valid``
    this host's; hops stamped ``device_put``."""
    jq, pq = _queues(_host(7, 5, (1, 4, 8)))
    (jb,) = list(jax_batches(jq, 8))
    (pb,) = list(port_batches(pq, 8))
    pb.hops = [{}]
    jg, pg = jmh.make_global_Batch(jb, jax_mesh), pt.make_global_Batch(pb, port_mesh)
    assert pg.num_valid == jg.num_valid == 5 and pg.arena is None
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(pg, f).to_local().numpy(),
                                      np.asarray(getattr(jg, f)))
        assert [str(p) for p in getattr(pg, f).placements] == ["S(0)"]
    assert "device_put" in pg.hops[0]


def test_legs_register_under_detector_names(port_mesh, port_registry):
    """``tests/test_obs.py``: an explicit ``obs_name`` is kept, an unnamed
    leg takes its detector's name, and nothing is registered twice."""
    named = mh.GlobalStreamConsumer(ScriptedQueue([]), local_batch_size=2, mesh=port_mesh,
                                    frame_shape=(1, 4, 4), obs_name="epix_custom")
    unnamed = mh.GlobalStreamConsumer(ScriptedQueue([]), local_batch_size=2, mesh=port_mesh,
                                      frame_shape=(1, 4, 4))
    mh.MultiDetectorGlobalConsumer({"epix": named, "jungfrau": unnamed})
    sources = port_registry.sources()
    assert "multihost.epix_custom" in sources
    assert "multihost.epix" not in sources
    assert "multihost.jungfrau" in sources
    assert unnamed.obs_name == "jungfrau"


def test_infer_step_takes_a_plain_batch_as_before(port_mesh):
    """A plain global tensor: the rows cut, the outputs gathered, a plain
    tensor back; the same rows as a DTensor: the rows in, a DTensor out,
    no gather."""
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    infer = make_infer_step(lambda rows: rows.sum(1), port_mesh)
    plain = infer(x)
    compat.reset_collectives()
    sharded = infer(pt.make_global_batch(x, port_mesh))
    assert compat.collective_counts() == {}
    assert not isinstance(plain, compat.DTensor) and isinstance(sharded, compat.DTensor)
    assert [str(p) for p in sharded.placements] == ["S(0)"]
    assert torch.equal(plain, sharded.to_local())
    with pytest.raises(ValueError, match="DTensor batch"):
        infer(compat.DTensor.from_local(x, port_mesh, [compat.Replicate()], run_check=False))


# -- the batcher's stall signal and drive_step's bytes -----------------------------------


@pytest.mark.parametrize("raise_on_stall", [True, False])
def test_stall_signal_matches_jax(raise_on_stall):
    """Both batchers on the same records from a queue that goes silent:
    the same batches (the tail first), the same exception type, and a
    ``stream_stalled`` flight event only when raising."""
    host = _host(8, 6, (1, 4, 8), end="stall")
    jq, pq = _queues(host)
    results = []
    for gen, q, flight in ((jax_batches, jq, JFLIGHT), (port_batches, pq, FLIGHT)):
        before = flight.count_of("stream_stalled")
        batches, raised = [], None
        try:
            for b in gen(q, 4, poll_interval_s=0.01, max_wait_s=0.1,
                         raise_on_stall=raise_on_stall):
                batches.append([np.array(getattr(b, f)) for f in FIELDS] + [b.num_valid])
        except Exception as e:  # noqa: BLE001 (compared below)
            raised = type(e).__name__
        results.append((batches, raised, flight.count_of("stream_stalled") - before))
    (jb, jr, jf), (pb, pr, pf) = results
    assert len(pb) == len(jb) == 2
    for a, b in zip(jb, pb):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    assert pr == jr == ("StreamStalled" if raise_on_stall else None)
    assert pf == jf == int(raise_on_stall)


@pytest.mark.parametrize("prefer_stream", [True, False])
def test_prefer_stream_matches_jax(prefer_stream):
    """``prefer_stream=False`` pulls with ``get_batch`` though the queue
    offers a push stream."""

    class TwoWay(ScriptedQueue):
        used = None

        def get_batch_stream(self, n, timeout=None):
            self.used = "stream"
            return self.get_batch(n, timeout)

    used = []
    for gen, records, eos in ((jax_batches, JRecord, JEos), (port_batches, FrameRecord, EndOfStream)):
        q = TwoWay(host_items(records, _frames(9, 3, (1, 2, 2)), "eos", eos))
        q.used = "get_batch"
        assert sum(b.num_valid for b in gen(q, 4, prefer_stream=prefer_stream)) == 3
        used.append(q.used)
    assert used[0] == used[1] == ("stream" if prefer_stream else "get_batch")


def test_drive_step_counts_the_bytes_it_is_given():
    jb = JBatch(np.zeros((4, 2, 3), np.float32), *(np.zeros(4, d) for d in
                                                   (np.uint8, np.int32, np.int64, np.float32)))
    pb = pt.Batch(torch.zeros(4, 2, 3), *(torch.zeros(4) for _ in range(4)), num_valid=0)
    counted = []
    for drive, metrics, batch in ((jax_drive_step, JMetrics(), jb),
                                  (port_drive_step, pt.PipelineMetrics(), pb)):
        drive(metrics, lambda b: None, batch)
        drive(metrics, lambda b: None, batch, nbytes=1000)
        counted.append(metrics.bytes.count)
    assert counted == [96 + 1000] * 2


def test_init_process_group_names_the_local_rank():
    """A rank's card is ``cuda:local_rank``: the refusal names the local
    rank and the machine's card count (none here)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal needs a local rank past them")
    with pytest.raises(RuntimeError, match=r"local rank 3 has no card: 0 visible on this machine"):
        pm.init_process_group(7, 8, pm.free_port(), device="cuda", local_rank=3)


# -- 2 and 4 gloo ranks --------------------------------------------------------


def _stream(lengths, shape=(2, 4, 8), ends=None, seed=10):
    ends = ends or ["eos"] * len(lengths)
    return {"epix": (shape, [_host(seed + h, n, shape, end, rank=h, first=100 * h)
                             for h, (n, end) in enumerate(zip(lengths, ends))])}


def _fanin(epix, jungfrau, seed=20):
    legs = _stream(epix, seed=seed)
    legs["jungfrau"] = ((1, 8, 8), [_host(seed + 50 + h, n, (1, 8, 8), rank=h, first=100 * h)
                                    for h, n in enumerate(jungfrau)])
    return legs


LOCAL_BS = 4
TWO = {  # name: (mesh names, mesh shape, local batch, legs)
    "stream": (("data",), (2,), LOCAL_BS, _stream([10, 6])),
    "fanin": (("data",), (2,), LOCAL_BS, _fanin([10, 6], [3, 7])),
    "wedge": (("data",), (2,), LOCAL_BS, _stream([9, 2], ends=["eos", "wedge"])),
}
FOUR = {
    "stream": (("data",), (4,), LOCAL_BS, _stream([10, 6, 3, 0])),
    "fanin": (("data",), (4,), LOCAL_BS, _fanin([10, 6, 2, 7], [3, 7, 0, 5])),
    "hosts_of_two": (("data", "model"), (2, 2), LOCAL_BS, _stream([10, 6])),
    "hosts_of_two_wedge": (("data", "model"), (2, 2), LOCAL_BS,
                           _stream([7, 5], ends=["eos", "wedge"])),
    "wedge": (("data",), (4,), LOCAL_BS, _stream([9, 5, 4, 6], ends=["eos", "wedge", "eos", "eos"])),
}


def _jax_schedule(jax_mesh, legs, local_bs):
    """The JAX package's side of a multi-host case in this process: each
    host's local rounds (``GlobalStreamConsumer._local_rounds`` over its
    queue), concatenated each round into one global batch
    (``make_global_Batch`` on the virtual mesh) and stepped in the fixed
    detector order until its global valid count is 0. Returns per leg the
    round outputs and valid masks, and each host's deferred fault."""
    hosts = {name: [jmh.GlobalStreamConsumer(_queues(h)[0], local_batch_size=local_bs,
                                             mesh=jax_mesh, frame_shape=shape)
                    for h in hs] for name, (shape, hs) in legs.items()}
    rounds = {name: [c._local_rounds() for c in cs] for name, cs in hosts.items()}
    outs = {name: [] for name in legs}
    valid = {name: [] for name in legs}
    done = {name: False for name in legs}
    while not all(done.values()):
        for name in legs:
            if done[name]:
                continue
            local = [next(r) for r in rounds[name]]
            cat = JBatch(*(np.concatenate([np.asarray(getattr(b, f)) for b in local])
                           for f in FIELDS))
            g = jmh.make_global_Batch(cat, jax_mesh)
            if int(jnp.sum(g.valid.astype(jnp.int32))) == 0:
                done[name] = True
                continue
            outs[name].append(np.asarray(_jax_step(g)))
            valid[name].append(np.asarray(g.valid))
    faults = {name: [type(c.deferred).__name__ if c.deferred is not None else None for c in cs]
              for name, cs in hosts.items()}
    return outs, valid, faults


def _check_ranks(jax_mesh, cases, ours, name):
    _, _, local_bs, legs = cases[name]
    outs, valid, faults = _jax_schedule(jax_mesh, legs, local_bs)
    ranks = [r[name] for r in ours]
    for res in ranks:
        h = res["host"]
        rows = slice(h * local_bs, (h + 1) * local_bs)
        host_faults = {faults[leg][h] for leg in legs} - {None}
        assert res["raised"] == (host_faults.pop() if host_faults else None), (name, h)
        for leg, (_, hosts) in legs.items():
            assert len(res["rows"][leg]) == len(outs[leg]) > 0, (name, leg)  # same last round
            for r, (want, got) in enumerate(zip(outs[leg], res["rows"][leg])):
                np.testing.assert_allclose(got, want[rows], **ROW_TOL)
                np.testing.assert_array_equal(res["valid"][leg][r], valid[leg][r][rows])
            assert all(s == (local_bs * _hosts(cases, name),) for s in res["shape"][leg])
            if res["counts"] is not None:
                assert res["counts"][leg] == len(hosts[h]["frames"])
        assert not any(k.startswith("all_gather") for k in res["collectives"])  # no gather
    return ranks


def _hosts(cases, name):
    names, shape, _, _ = cases[name]
    return shape[list(names).index("data")]


@pytest.fixture(scope="module")
def two_ranks(one_torch_thread):
    return run_ranks(2, "torch_rank_cases:two_rank_cases", TWO)


@pytest.fixture(scope="module")
def four_ranks(one_torch_thread):
    return run_ranks(4, "torch_rank_cases:multihost_cases", FOUR)


@pytest.mark.parametrize("name", sorted(TWO))
def test_two_ranks_match_jax(jax_mesh, two_ranks, name):
    ranks = _check_ranks(jax_mesh, TWO, two_ranks, name)
    if name == "stream":  # the reference's: 3 rounds on every rank, rank 1 padding its last
        assert [len(r["rows"]["epix"]) for r in ranks] == [3, 3]
        assert [r["counts"]["epix"] for r in ranks] == [10, 6]
        assert [r["collectives"]["all_reduce/gloo"] for r in ranks] == [4, 4]
    if name == "wedge":
        assert [r["raised"] for r in ranks] == [None, "TransportWedged"]


def test_train_step_takes_each_ranks_rows(two_ranks):
    """``make_train_step`` on a mesh fed each rank's rows as DTensors (the
    labels gathered whole for the loss) takes the same step as fed the
    global batch on every rank (which ``tests/test_torch_multichip.py``
    holds against the JAX package)."""
    for r in two_ranks:
        got, want = r["train"]["rows"], r["train"]["global"]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
        np.testing.assert_allclose(got["weight"], want["weight"], rtol=1e-6, atol=1e-7)
    assert two_ranks[0]["train"]["rows"]["loss"] == two_ranks[1]["train"]["rows"]["loss"]


@pytest.mark.parametrize("name", sorted(FOUR))
def test_four_ranks_match_jax(jax_mesh, four_ranks, name):
    ranks = _check_ranks(jax_mesh, FOUR, four_ranks, name)
    if name.startswith("hosts_of_two"):  # the followers got the leaders' rows
        assert [r["host"] for r in ranks] == [0, 0, 1, 1]
        assert all(r["collectives"]["broadcast/gloo"] > 0 for r in ranks)
        for a, b in ((0, 1), (2, 3)):
            for x, y in zip(ranks[a]["rows"]["epix"], ranks[b]["rows"]["epix"]):
                np.testing.assert_array_equal(x, y)
    if name == "hosts_of_two_wedge":  # the wedged host's two ranks raise, the other's do not
        assert [r["raised"] for r in ranks] == [None, None, "TransportWedged", "TransportWedged"]
    if name == "wedge":
        assert [r["raised"] for r in ranks] == [None, "TransportWedged", None, None]


# -- the slice ---------------------------------------------------------------


SLICE_STAGES = (1, 1, 1, 1)
SLICE_P, SLICE_H, SLICE_W = 2, 32, 32


def _slice_inputs():
    rng = np.random.default_rng(31)
    shape = (SLICE_P, SLICE_H, SLICE_W)
    ped = (100.0 + 3.0 * rng.standard_normal(shape)).astype(np.float32)
    gain = (1.0 + 0.02 * rng.standard_normal(shape)).astype(np.float32)
    mask = (rng.random(shape) > 0.01).astype(np.uint8)
    hosts = []
    for h, n in enumerate((5, 3)):
        raw = (ped + 35.0 * rng.poisson(0.1, (n, *shape)) * gain
               + rng.normal(0, 2.5, (n, *shape))).astype(np.float32)
        hosts.append({"frames": [(h, 100 * h + i, raw[i]) for i in range(n)], "end": "eos"})
    params = pt.init_resnet_params(in_channels=SLICE_P, stage_sizes=SLICE_STAGES, width=16,
                                   seed=0)
    return (ped, gain, mask), hosts, params


def test_slice_served_through_the_consumer_on_two_ranks(one_torch_thread):
    from psana_ray_tpu.models import panels_to_nhwc
    from psana_ray_tpu.models.pallas_resnet import resnet_fused_infer
    from psana_ray_tpu.ops.pallas_calib import fused_calibrate

    consts, hosts, params = _slice_inputs()
    ours = run_ranks(2, "torch_rank_cases:multihost_slice", hosts, consts, params,
                     SLICE_STAGES, 2)
    assert [r["n_local"] for r in ours] == [5, 3]
    keys = [(h, idx) for h, host in enumerate(hosts) for _, idx, _ in host["frames"]]
    raw = np.stack([f for host in hosts for _, _, f in host["frames"]])
    jconsts = [jnp.asarray(a) for a in consts]
    cal32 = np.asarray(fused_calibrate(jnp.asarray(raw), *jconsts, threshold=10.0,
                                       out_dtype=jnp.float32, interpret=True))
    cal16 = fused_calibrate(jnp.asarray(raw), *jconsts, threshold=10.0, out_dtype=jnp.bfloat16,
                            interpret=True)
    logits = np.asarray(resnet_fused_infer({"params": jax.tree.map(jnp.asarray, params)},
                                           panels_to_nhwc(cal16), stage_sizes=SLICE_STAGES,
                                           interpret=True), np.float32)
    got_logits = np.stack([ours[h]["rows"][idx][0] for h, idx in keys])
    got_cal = np.stack([ours[h]["rows"][idx][1] for h, idx in keys])
    np.testing.assert_allclose(got_cal, cal32, **CALIB_TOL)
    err = rel_err(logits, got_logits)
    print(f"multi-host slice logits rel_err {err}")  # observed values: pytest -rP
    assert np.isfinite(got_logits).all() and got_logits.shape == (8, 2)
    assert err < LOGIT_TOL
