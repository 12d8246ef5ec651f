"""The port's per-frame tracing, stage decomposition, trace merge and
record wire format against the JAX package's.

The same inputs, made from a numpy seed, go through both packages, and
the results are equal unless stated: ``TraceContext.pack`` gives the same
25 bytes; the tracers sample the same frames at 1 in 1, 7 and 100;
``emit_batch_spans`` and ``observe_batch_stages`` over the same hop dicts
give the same spans and the same histograms; ``trace_merge.merge`` of the
same spools gives the same document; and frames encode to the same v2 and
v3 bytes, each package decoding the other's, the port's with a
``TraceContext``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from psana_ray_tpu import records as jax_records
from psana_ray_tpu.obs import stages as jax_stages
from psana_ray_tpu.obs import trace_merge as jax_merge
from psana_ray_tpu.obs import tracing as jax_tracing
from psana_ray_tpu.utils import metrics as jax_metrics
from psana_ray_tpu_torch import records
from psana_ray_tpu_torch.obs import stages, trace_merge, tracing
from psana_ray_tpu_torch.utils import metrics as port_metrics

CONTEXTS = [
    dict(trace_id=0, sampled=True, origin_host="", origin_pid=0),
    dict(trace_id=0x1234_5678_9ABC_DEF0, sampled=True, origin_host="node7", origin_pid=4242),
    dict(trace_id=2**64 - 1, sampled=False, origin_host="a-very-long-hostname", origin_pid=2**32 - 1),
    dict(trace_id=77, sampled=True, origin_host="höst", origin_pid=1),
]


@pytest.mark.parametrize("ctx", CONTEXTS, ids=range(len(CONTEXTS)))
def test_trace_context_packs_the_jax_bytes(ctx):
    ours, theirs = tracing.TraceContext(**ctx), jax_tracing.TraceContext(**ctx)
    assert ours.pack() == theirs.pack() and len(ours.pack()) == tracing.TraceContext.WIRE_SIZE == 25
    buf = b"xx" + ours.pack()
    back = tracing.TraceContext.unpack_from(buf, 2)
    assert dataclasses.asdict(back) == dataclasses.asdict(jax_tracing.TraceContext.unpack_from(buf, 2))
    assert back.trace_id == ctx["trace_id"] and back.sampled == ctx["sampled"]


@pytest.mark.parametrize("every", [1, 7, 100])
def test_sampling_sequence_matches_the_jax_tracer(every, tmp_path):
    seqs = {}
    for name, mod in (("jax", jax_tracing), ("port", tracing)):
        tr = mod.Tracer().configure(str(tmp_path / name), sample_every=every, process="p")
        try:
            got = [tr.maybe_trace() for _ in range(350)]
            seqs[name] = [(i, c.trace_id - tr._id_base, c.sampled, c.origin_pid)
                          for i, c in enumerate(got) if c is not None]
            assert tr.snapshot()["frames_seen_total"] == 350
        finally:
            tr.close()
        assert tr.maybe_trace() is None  # closed: off
    assert seqs["port"] == seqs["jax"] and len(seqs["port"]) == 350 // every


def _hops(seed, n=40):
    """Hop dicts with a seeded mix of present and missing stamps, some
    traced."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = float(rng.uniform(0, 1e4))
        h = {}
        for hop in stages.HOPS:
            t += float(rng.exponential(0.003))
            if rng.random() < 0.8:
                h[hop] = t
        if rng.random() < 0.5:
            h[tracing.TRACE_KEY] = 1000 + i
        out.append(h)
    return out, t + 0.01


class _Batch:
    def __init__(self, hops):
        self.hops = hops


def _span_lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f if '"t":"s"' in line or '"t":"i"' in line]


@pytest.mark.parametrize("seed", range(4))
def test_batch_spans_and_stage_histograms_match_the_jax_package(seed, tmp_path):
    hops, t_end = _hops(seed)
    spans, snaps = {}, {}
    for name, tmod, smod, mmod in (("jax", jax_tracing, jax_stages, jax_metrics),
                                   ("port", tracing, stages, port_metrics)):
        tr = tmod.Tracer().configure(str(tmp_path / name), sample_every=1, process="c")
        try:
            tmod.emit_batch_spans(_Batch([dict(h) for h in hops]), t_end, tracer=tr)
            tmod.emit_batch_spans(_Batch(None), t_end, tracer=tr)  # untimed: nothing
        finally:
            tr.close()
        spans[name] = _span_lines(tr.spool_path)
        st = mmod.StageTimes()
        smod.observe_batch_stages(st, _Batch([dict(h) for h in hops]), t_end)
        smod.observe_batch_stages(st, _Batch(None))
        snaps[name] = st.snapshot()
    assert spans["port"] == spans["jax"] and spans["port"]
    assert snaps["port"] == snaps["jax"]
    assert "enqueue" not in {s["n"] for s in spans["port"]}  # the producer's span


def test_stage_names_and_hops_are_the_jax_vocabulary():
    for name in ("HOPS", "STAGES", "STAGE_E2E", "HOP_SRC", "HOP_DEVICE_PUT"):
        assert getattr(stages, name) == getattr(jax_stages, name)
    assert tracing.TRACE_KEY == jax_tracing.TRACE_KEY
    assert (tracing.SPAN_PRODUCE, tracing.SPAN_RELAY) == (jax_tracing.SPAN_PRODUCE,
                                                          jax_tracing.SPAN_RELAY)


def test_mark_hop_stamps_frames_only():
    rec = records.FrameRecord(0, 1, np.zeros((1, 2, 2), np.float32), 9.0)
    assert rec.hops is None
    records.mark_hop(rec, stages.HOP_SRC, 5.0)
    records.mark_hop(rec, stages.HOP_ENQ)
    assert rec.hops["src"] == 5.0 and rec.hops["enq"] > 0
    eos = records.EndOfStream()
    records.mark_hop(eos, stages.HOP_SRC)  # a no-op
    assert not hasattr(eos, "hops")
    assert records.decode(rec.to_bytes()).hops is None  # never on the wire
    assert dataclasses.replace(rec).hops is rec.hops  # a copy keeps the stamps


def _write_spools(dirpath, seed):
    """Spools of three processes with spans, instants and peer anchors,
    written by the port's tracer."""
    rng = np.random.default_rng(seed)
    paths = []
    for proc in ("producer", "queue_server", "consumer"):
        tr = tracing.Tracer().configure(str(dirpath), sample_every=1, process=proc)
        for i in range(int(rng.integers(20, 300))):  # past FLUSH_EVERY: anchors mid-spool
            tid = int(rng.integers(1, 6))
            a = float(rng.uniform(0, 100))
            tr.span(tid, str(rng.choice(["relay", "batch", "dispatch"])), a,
                    a + float(rng.exponential(0.01)))
            if i % 7 == 0:
                tr.instant(tid, "produce", a)
        if proc != "queue_server":
            for _ in range(3):
                m = float(rng.uniform(0, 100))
                tr.record_peer_anchor({"send_wall": 0.0, "send_mono": m, "recv_mono": m + 1e-4,
                                       "peer_wall": 1.7e9 + m, "peer_mono": m})
        tr.close()
        paths.append(tr.spool_path)
    with open(paths[0], "a") as f:
        f.write('{"t":"s","id":1,"n":"torn"')  # a torn last line
    return paths


@pytest.mark.parametrize("seed", range(3))
def test_merge_gives_the_jax_document(seed, tmp_path):
    paths = _write_spools(tmp_path, seed)
    for inputs in ([str(tmp_path)], paths[:2]):
        ours, theirs = trace_merge.merge(inputs), jax_merge.merge(inputs)
        assert ours == theirs
        for tid in (1, 3, 999):
            one = trace_merge.merge(inputs, only_trace=tid)
            assert one == jax_merge.merge(inputs, only_trace=tid)
            assert trace_merge.exemplar_timeline(one) == jax_merge.exemplar_timeline(one)
    spool = trace_merge.load_spool(paths[1])
    off = trace_merge.clock_offset(spool)
    assert off == jax_merge.clock_offset(jax_merge.load_spool(paths[1]))
    assert trace_merge.clock_skew(spool, off) == 0.0  # the server: no exchanges
    with pytest.raises(FileNotFoundError):
        trace_merge.merge([str(tmp_path / "empty")])


def test_merge_command_writes_the_jax_commands_file(tmp_path, capsys):
    _write_spools(tmp_path, 7)
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    assert trace_merge.main([str(tmp_path), "--out", str(ours)]) == 0
    assert jax_merge.main([str(tmp_path), "--out", str(theirs)]) == 0
    assert json.loads(ours.read_text()) == json.loads(theirs.read_text())
    assert trace_merge.main([str(tmp_path), "--exemplar", "0x2", "--out", str(ours)]) == 0
    assert "exemplar 0x2:" in capsys.readouterr().out
    assert trace_merge.main([str(tmp_path), "--exemplar", "nope"]) == 2
    assert trace_merge.main([str(tmp_path), "--exemplar", "123456789"]) == 1


FRAMES = {
    "f32": lambda rng: rng.normal(100, 10, (3, 8, 16)).astype(np.float32),
    "uint16": lambda rng: rng.integers(0, 65535, (4, 5, 7)).astype(np.uint16),
    "int16-2d": lambda rng: rng.integers(-999, 999, (6, 9)).astype(np.int16),
}


@pytest.mark.parametrize("ctx", [None, *CONTEXTS[1:]], ids=["v2", "v3a", "v3b", "v3c"])
@pytest.mark.parametrize("kind", sorted(FRAMES))
def test_v2_and_v3_bytes_both_ways(kind, ctx):
    panels = FRAMES[kind](np.random.default_rng(len(kind)))
    ours = records.FrameRecord(3, 41, panels, 9.5, timestamp=12.5,
                               trace=None if ctx is None else tracing.TraceContext(**ctx))
    theirs = jax_records.FrameRecord(3, 41, panels, 9.5, timestamp=12.5,
                                     trace=None if ctx is None else jax_tracing.TraceContext(**ctx))
    wire = theirs.to_bytes()
    assert ours.to_bytes() == wire and b"".join(map(bytes, ours.wire_parts())) == wire
    assert records.parse_frame_header(wire)[6] == (2 if ctx is None else 3)
    got = records.decode(wire)
    assert got.equals(ours) and got.timestamp == 12.5
    if ctx is None:
        assert got.trace is None
    else:
        assert isinstance(got.trace, tracing.TraceContext)
        assert dataclasses.asdict(got.trace) == dataclasses.asdict(
            jax_tracing.TraceContext.unpack_from(wire, records.parse_frame_header(wire)[8] - 25))
    back = jax_records.FrameRecord.from_bytes(ours.to_bytes())
    assert back.equals(theirs)
    assert (back.trace is None) == (ctx is None)
    if ctx is not None:
        assert back.trace.pack() == ours.trace.pack()


def test_tracer_snapshot_status_and_configure_from_args(tmp_path):
    from psana_ray_tpu_torch.obs.flight import FLIGHT
    from psana_ray_tpu_torch.obs.registry import MetricsRegistry

    class Args:
        trace_dir = str(tmp_path / "tr")
        trace_sample = 3
        flight_dir = None

    MetricsRegistry.reset_default()
    try:
        tr = tracing.configure_from_args(Args(), "consumer")
        assert tr is tracing.TRACER and tr.enabled and tr.sample_every == 3
        assert {"trace", "flight"} <= set(MetricsRegistry.default().sources())
        tr.span(5, "batch", 1.0, 2.0)
        suffix = tracing.obs_status_suffix()
        assert suffix.startswith(" trace[1/3 spans=1]") and f"flight={FLIGHT.event_count}" in suffix
        snap = tr.snapshot()
        assert snap["spans_by_name"] == {"batch": 1} and snap["sample_every"] == 3
        name = os.path.basename(tr.spool_path)
        assert name.startswith("consumer-") and name.endswith(".trace.jsonl")
        meta = json.loads(open(tr.spool_path).readline())
        assert set(meta) == {"t", "process", "host", "pid", "every", "start_wall", "start_mono"}
    finally:
        tracing.TRACER.close()
        FLIGHT.uninstall()
        MetricsRegistry.reset_default()
    assert tracing.TRACER.status_suffix() == ""
    assert tracing.exchange_anchors(object()) == 0  # off, and no anchor RPC


def test_spans_past_the_cap_are_dropped_and_counted(tmp_path):
    tr = tracing.Tracer().configure(str(tmp_path), sample_every=1, max_spans=3)
    try:
        for i in range(5):
            tr.span(i, "relay", 0.0, 1.0)
        assert tr.snapshot()["spans_dropped_total"] == 2
        assert " drops=2]" in tr.status_suffix()
    finally:
        tr.close()
    assert len(_span_lines(tr.spool_path)) == 3
    with pytest.raises(ValueError):
        tracing.Tracer().configure(str(tmp_path), sample_every=0)
