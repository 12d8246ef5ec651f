"""The window's arithmetic, the end-to-end readers, and the trace's
reduction (union of intervals, idle gaps and what the host did in them,
roofline shares, idle shares) on synthetic records."""

import time
import types

import pytest

from portbench import core, tracing, window

from conftest import REPO


def reader(folder, name):
    return core.load_module(REPO / "portbench" / folder / f"{name}.py").read


def test_window_opens_after_warmup_and_closes_at_the_first_late_batch():
    calls = []
    w = window.Window(1.0, 2, on_open=lambda: calls.append("open") or 10.0,
                      on_close=lambda: calls.append("close") or 11.5)
    for t, lat in ((9.0, 0.5), (10.0, 0.5), (10.2, 0.1), (10.9, 0.3), (11.0, 0.2),
                   (11.3, 0.4), (11.6, 0.1)):
        w.batch_done(t, 8, lat)
    assert (w.t0, w.t1) == (10.0, 11.0)
    assert calls == ["open", "close"] and w.opened_at == 10.0 and w.closed_at == 11.5
    # the batch done at t0 is warm-up; the one done at t1 counts
    assert [b[0] for b in w.in_window()] == [10.2, 10.9, 11.0]
    run = types.SimpleNamespace(window=w, t_start=4.0)
    assert reader("end_to_end", "frames_per_s")(run) == pytest.approx(24.0)
    assert reader("end_to_end", "setup_s")(run) == pytest.approx(6.0)
    assert reader("end_to_end", "batch_p50_ms.resnet")(run) == pytest.approx(200.0)
    assert reader("end_to_end", "batch_p95_ms.sfx")(run) == pytest.approx(290.0)  # linear between ranks


def test_window_summary_and_host_record():
    w = window.Window(2.0, 1)
    w.batch_done(1.0, 4, 0.1)
    w.host_done(1.5, 0.004, 0.001)
    w.host_done(2.5, 0.006, 0.003)
    w.batch_done(2.0, 4, 0.2)
    w.batch_done(3.0, 2, 0.3)
    s = w.summary()
    assert s["window_frames_per_s"] == pytest.approx(3.0)
    assert s["batch_p50_ms"] == pytest.approx(300.0)
    assert s["host_batch_ms"] == pytest.approx(5.0) and s["host_stage_ms"] == pytest.approx(2.0)


def test_sample_is_a_seeded_reservoir():
    def draw(seed):
        s = window.Sample(seed, 3)
        for i in range(100):
            s.offer(i)
        return s.items

    assert draw(7) == draw(7) and len(draw(7)) == 3
    assert draw(7) != draw(8)
    few = window.Sample(1, 5)
    for i in range(2):
        few.offer(i)
    assert few.items == [0, 1]


def test_union_is_not_a_sum():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert tracing.merged(iv, 0.0, 10.0) == [(0.0, 3.0), (5.0, 6.0)]
    assert tracing.covered(iv, 0.0, 10.0) == pytest.approx(4.0)  # the sum would be 5.2
    assert tracing.covered(iv, 2.5, 5.5) == pytest.approx(1.0)
    assert tracing.idle_gaps(iv, -1.0, 7.0) == [(-1.0, 0.0), (3.0, 5.0), (6.0, 7.0)]
    assert tracing.idle_gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_gaps_take_the_names_of_the_host_ranges_open_in_them():
    ranges = [("stage.dispatch", 0.0, 4.0), ("portbench.step", 1.0, 2.0),
              ("stage.device_put", 3.0, 9.0)]
    gaps = [(1.2, 1.4), (3.5, 3.7), (5.0, 6.0), (9.5, 9.6), (0.1, 0.3)]
    assert tracing.label_gaps(gaps, ranges) == [
        "portbench.step+stage.dispatch", "stage.device_put+stage.dispatch", "stage.device_put",
        "no range", "stage.dispatch"]


def fake_trace():
    kernels = [("void calib_cluster_kernel<1>", 1.0, 1.1), ("conv_sm90_kernel<128, 0>", 1.1, 1.5),
               ("elementwise", 1.6, 1.8), ("conv_sm90_kernel<64, 0>", 2.0, 2.2),
               ("before the window", 0.1, 0.2)]
    ops = kernels + [("Memcpy HtoD (Pinned -> Device)", 0.9, 1.2)]
    return tracing.Trace(sorted(kernels, key=lambda k: k[1]), sorted(ops, key=lambda k: k[1]),
                         [("portbench.step", 0.95, 2.3)], 0.5, 2.5)


def fake_run(trace, layer_costs, batches):
    w = window.Window(1.0, 1)
    w.opened_at, w.closed_at = trace.t0, trace.t1
    w.batches = batches
    module = types.SimpleNamespace(costs=lambda c, t: layer_costs,
                                   flops_per_batch=lambda c, t: 989e9)
    return core_run(trace, w, module)


def core_run(trace, w, module):
    run = types.SimpleNamespace(trace=trace, window=w, module=module, config={}, traffic={})
    run.traced_batches = types.MethodType(core.Run.traced_batches, run)
    run.costs = types.MethodType(core.Run.costs, run)
    return run


def test_idle_shares_and_rooflines_from_a_synthetic_trace():
    t = fake_trace()
    # two batches dispatched inside the window, one before it
    run = fake_run(t, {"unet_conv": [(0.0, 989e12 * 0.1)], "calib": [(3.35e12 * 0.02, 0.0)]},
                   [(0.45, 8, 0.1), (1.5, 8, 0.6), (2.4, 8, 0.5)])
    assert run.traced_batches() == [(0.9, 1.5), (1.9, 2.4)]
    # conv kernels: 0.4 + 0.2 s busy; bound 2 x 0.1 s
    assert reader("metrics", "unet_conv_roofline")(run) == pytest.approx(100 * 0.2 / 0.6)
    # calib: 0.1 s busy, bound 2 x 0.02 s
    assert reader("metrics", "calib_roofline.sfx")(run) == pytest.approx(100 * 0.04 / 0.1)
    # kernels cover 1.0-1.5, 1.6-1.8, 2.0-2.2 of the 2 s window
    assert reader("metrics", "idle_share.sfx")(run) == pytest.approx(1 - 0.9 / 2.0)
    # 2 batches of 989 GFLOP over 2 s
    assert reader("metrics", "mfu.sfx")(run) == pytest.approx(0.1)
    # the steps 0.9-1.5 and 1.9-2.4: kernels cover 0.5 and 0.2 of their 1.1 s
    assert reader("metrics", "idle_share.resnet_step")(run) == pytest.approx(1 - 0.7 / 1.1)
    assert reader("metrics", "mfu.resnet")(run) == pytest.approx(100 * 989e9 / 0.55 / 989e12)
    b = tracing.breakdown(t)
    assert b["device_ops"][0] == ["conv_sm90_kernel<128, 0>", pytest.approx(0.4)]
    # gaps 0.5-0.9 and 2.2-2.5 outside the step's range, 1.5-1.6 and 1.8-2.0 in it
    assert dict(map(tuple, b["idle_gaps"])) == pytest.approx(
        {"no range": 0.4 + 0.3, "portbench.step": 0.1 + 0.2})


def test_readers_return_nothing_without_their_kernels_or_a_trace():
    t = fake_trace()
    run = fake_run(t, {"resnet_conv": [(1.0, 1.0)]}, [(1.5, 8, 0.6)])
    run.trace = tracing.Trace([], [], [], 0.5, 2.5)
    assert reader("metrics", "resnet_conv_roofline")(run) is None
    run.trace = None
    for name in ("calib_roofline.resnet", "mfu.sfx", "idle_share.sfx", "mfu.resnet",
                 "idle_share.resnet_step"):
        assert reader("metrics", name)(run) is None


def test_host_batch_ms_reads_the_traced_window():
    w = window.Window(1.0, 1)
    w.opened_at, w.closed_at = 1.0, 2.0
    for t, b in ((0.5, 0.9), (1.2, 0.004), (1.8, 0.006), (2.5, 0.9)):
        w.host_done(t, b, 0.0)
    assert reader("metrics", "host_batch_ms.sfx")(types.SimpleNamespace(window=w)) == \
        pytest.approx(5.0)


def test_which_cells_report_which_metrics(bench):
    e2e = {c: {m["name"] for m in core.reported(bench, c, "end_to_end")}
           for c in ("sfx_b8", "resnet_b32")}
    assert e2e == {"sfx_b8": {"frames_per_s", "batch_p95_ms.sfx", "setup_s"},
                   "resnet_b32": {"batch_p50_ms.resnet", "setup_s"}}
    for c in e2e:
        layer = core.reported(bench, c, "per_layer")
        assert layer and all(m["moves"] in e2e[c] for m in layer)
        for m in layer + core.reported(bench, c, "end_to_end"):
            folder = "metrics" if m in layer else "end_to_end"
            assert (REPO / "portbench" / folder / f"{m['name']}.py").is_file()


def test_periodic_source_puts_on_its_schedule():
    import numpy as np

    from portbench import generator
    from psana_ray_tpu_torch.transport.ring import RingBuffer

    ring = RingBuffer(maxsize=64)
    pool = np.zeros((3, 1, 2, 2), np.uint16)
    src = generator.Source(ring, pool, np.ones(3), {"arrival": "periodic", "rate_hz": 50.0})
    t0 = time.monotonic()
    src.start()
    got, seen = [], []
    while len(got) < 10:
        new = [r for r in ring.get_batch(16, timeout=1.0) if hasattr(r, "event_idx")]
        got += new
        seen += [time.monotonic() - t0] * len(new)
    src.stop()
    n = src.join(timeout=10)
    assert n >= 10 and [r.event_idx for r in got[:10]] == list(range(10))
    # event i is not put before its due time i / 50 s
    assert all(t >= i / 50.0 - 1e-3 for i, t in enumerate(seen[:10]))
    assert seen[9] < 2.0
    with pytest.raises(ValueError):
        generator.Source(ring, pool, np.ones(3), {"arrival": "bursty"})
