"""The serving loop's ranges on the profiler's timeline, on the CPU.

Each run is captured by ``utils.trace.trace`` (every thread) and read
back from its Chrome trace: ``SfxPipeline.run`` opens one
``stage.dispatch``, ``stage.calib``, ``stage.model``, ``stage.peaks`` and
``stage.drain`` a batch, the three launches inside the dispatch, and the
staging thread's ``stage.dequeue`` and ``stage.batch``; a drain waits on
the card (``stage.sync``) only for a handle with an event; an
``InfeedPipeline`` step composed from ``fused_calibrate`` and
``resnet_fused_infer`` opens one ``stage.calib`` and one ``stage.model``
inside each ``stage.dispatch``; a slow ring shows as ``stage.wait_staged``
time on the consumer's thread."""

import json
import threading
import time
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu_torch.infeed import InfeedPipeline  # noqa: E402
from psana_ray_tpu_torch.records import EndOfStream, FrameRecord  # noqa: E402
from psana_ray_tpu_torch.sfx import Pending  # noqa: E402
from psana_ray_tpu_torch.sources import SyntheticSource  # noqa: E402
from psana_ray_tpu_torch.transport import RingBuffer  # noqa: E402
from psana_ray_tpu_torch.utils.trace import trace  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

DET = "smoke_a"
LAUNCHES = ("stage.calib", "stage.model", "stage.peaks")


def _ranges(path):
    """``(name, thread, start µs, end µs)`` of every ``stage.*`` host range."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("stage.")]


def _inside(inner, outers):
    """The outer range of ``outers`` on ``inner``'s thread that holds it."""
    _, tid, s, e = inner
    held = [o for o in outers if o[1] == tid and o[2] <= s and e <= o[3]]
    assert len(held) == 1, (inner, held)
    return held[0]


def _raw_stream(n):
    src = SyntheticSource(num_events=n, detector_name=DET, seed=3)
    calib = (src.pedestal(), src.gain_map(), src.create_bad_pixel_mask())
    return list(src.iter_indexed_events("raw")), calib


def _ring(events):
    ring = RingBuffer(maxsize=len(events) + 1)
    for idx, data, energy in events:
        ring.put(FrameRecord(0, idx, data, energy))
    ring.put(EndOfStream())
    return ring


class _Sink:
    max_peaks = 16

    def __init__(self):
        self.sets = []

    def append(self, sets):
        self.sets.extend(sets)


def _sfx(batch):
    _, calib = _raw_stream(1)
    tree = {"params": pt.init_peaknet_tpu_params((8, 16), seed=1)}
    return pt.SfxPipeline(tree, _Sink(), calib=calib, config=pt.SfxConfig(batch_size=batch),
                          device="cpu")


@pytest.mark.parametrize("batch,events", [(2, 6), (4, 10)])
def test_sfx_run_opens_one_range_of_each_part_a_batch(tmp_path, one_torch_thread, batch, events):
    stream, _ = _raw_stream(events)
    pipe = _sfx(batch)
    with trace(str(tmp_path)) as path:
        pipe.run(_ring(stream))
    assert len(pipe.writer.sets) == events
    rows = _ranges(path)
    n = Counter(r[0] for r in rows)
    n_batches = -(-events // batch)
    for name in ("stage.dispatch", "stage.drain") + LAUNCHES:
        assert n[name] == n_batches, (name, n)
    assert n["stage.sync"] == 0  # off the card a drain has no event to wait on
    dispatches = [r for r in rows if r[0] == "stage.dispatch"]
    for r in rows:
        if r[0] in LAUNCHES:
            _inside(r, dispatches)
    consumer = {r[1] for r in dispatches}
    staging = {r[1] for r in rows if r[0] in ("stage.dequeue", "stage.batch")}
    assert n["stage.dequeue"] >= 1 and n["stage.batch"] >= 1
    assert len(consumer) == 1 and staging and not staging & consumer
    drains = [r for r in rows if r[0] == "stage.drain"]
    assert {r[1] for r in drains} == consumer


def test_a_drain_on_the_card_waits_inside_one_sync_range(tmp_path, one_torch_thread):
    class Event:  # what a CUDA event offers the drain
        waits = 0

        def synchronize(self):
            Event.waits += 1

    pipe = _sfx(2)
    stream, _ = _raw_stream(2)
    batch = pt.FrameBatcher(2)
    for idx, data, energy in stream:
        out = batch.push(FrameRecord(0, idx, data, energy))
    handle = pipe.dispatch(out)
    on_card = Pending(handle.t0, handle.nbytes, handle.peaks, Event(), handle.batch)
    with trace(str(tmp_path)) as path:
        assert pipe.drain(on_card) == 2
        assert pipe.drain(handle) == 2
    rows = _ranges(path)
    drains = [r for r in rows if r[0] == "stage.drain"]
    syncs = [r for r in rows if r[0] == "stage.sync"]
    assert Event.waits == 1 and len(drains) == 2 and len(syncs) == 1
    assert _inside(syncs[0], drains) == min(drains, key=lambda r: r[2])


def _resnet_step(calib):
    from psana_ray_tpu_torch.convert import resnet_from_flax
    from psana_ray_tpu_torch.models import pack_fused, panels_to_nhwc, resnet_fused_infer
    from psana_ray_tpu_torch.ops import fused_calibrate

    ped, gain, mask = (torch.from_numpy(np.asarray(a)) for a in calib)
    stages = (1, 1, 1, 1)
    params = pack_fused(resnet_from_flax(
        pt.init_resnet_params(in_channels=ped.shape[0], stage_sizes=stages, width=8, seed=2),
        stage_sizes=stages, device="cpu"))

    @torch.no_grad()
    def step(batch):
        cal = fused_calibrate(batch.frames, ped, gain, mask, threshold=10.0,
                              out_dtype=torch.bfloat16)
        return resnet_fused_infer(params, panels_to_nhwc(cal), stages)

    return step


@pytest.mark.parametrize("batch,events", [(2, 5), (3, 9)])
def test_the_serving_step_opens_calib_and_model_inside_each_dispatch(tmp_path, one_torch_thread,
                                                                     batch, events):
    stream, calib = _raw_stream(events)
    step = _resnet_step(calib)
    with trace(str(tmp_path)) as path:
        pipe = InfeedPipeline(_ring(stream), batch_size=batch, device="cpu", prefetch_depth=2)
        assert pipe.run(step, block_until_ready=True) == events
    rows = _ranges(path)
    n = Counter(r[0] for r in rows)
    n_batches = -(-events // batch)
    assert n["stage.dispatch"] == n["stage.calib"] == n["stage.model"] == n_batches, n
    assert n["stage.peaks"] == n["stage.drain"] == n["stage.sync"] == 0, n
    dispatches = [r for r in rows if r[0] == "stage.dispatch"]
    held = [_inside(r, dispatches) for r in rows if r[0] in ("stage.calib", "stage.model")]
    assert Counter(held) == {d: 2 for d in dispatches}


def test_a_slow_ring_shows_as_wait_staged_time(tmp_path, one_torch_thread):
    delay, events = 0.05, 6
    ring = RingBuffer(maxsize=events + 1)
    frames = np.ones((2, 4, 8), np.float32)

    def produce():
        for i in range(events):
            time.sleep(delay)
            ring.put(FrameRecord(0, i, frames, 9.0))
        ring.put(EndOfStream())

    producer = threading.Thread(target=produce, daemon=True)
    with trace(str(tmp_path)) as path:
        producer.start()
        pipe = InfeedPipeline(ring, batch_size=2, device="cpu", prefetch_depth=2)
        assert pipe.run(lambda b: b.frames.sum()) == events
    producer.join(timeout=10)
    assert not producer.is_alive()
    rows = _ranges(path)
    waits = [r for r in rows if r[0] == "stage.wait_staged"]
    consumer = {r[1] for r in rows if r[0] == "stage.dispatch"}
    assert waits and {r[1] for r in waits} == consumer
    # the consumer waited for most of the producer's pace: 6 frames, 50 ms apart
    waited_s = sum(r[3] - r[2] for r in waits) * 1e-6
    assert waited_s >= 0.5 * delay * events, waited_s
