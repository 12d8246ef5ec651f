"""The ``program_span`` readers of the port's serving ranges on synthetic
traces: a range counts when it starts inside the traced window, a nested
``stage.sync`` is taken out of its dispatch or drain, a reader gives
None where the window holds no range it reads (a program that does not
open it), and the per-batch readers divide by the window's own batches."""

import types

import pytest

from portbench import core, spans, tracing, window

from conftest import REPO

LO, HI = 10.0, 20.0  # the traced window (opened_at, closed_at]


def reader(name):
    return core.load_module(REPO / "portbench" / "metrics" / f"{name}.py").read


def fake_run(ranges, batches=(), host=()):
    """A run whose trace holds ``ranges`` (``(name, start, end)``) and whose
    window saw ``batches`` done and ``host`` batches staged at those times."""
    w = window.Window(HI - LO, 1)
    w.opened_at, w.closed_at = LO, HI
    w.batches = [(t, 8, 0.01) for t in batches]
    for t in host:
        w.host_done(t, 0.5, 0.0)
    trace = tracing.Trace([], [], sorted(ranges, key=lambda r: r[1]), LO, HI)
    return types.SimpleNamespace(trace=trace, window=w)


def test_a_range_counts_when_it_starts_inside_the_window():
    run = fake_run([("stage.dispatch", 9.5, 10.5), ("stage.dispatch", 10.0, 10.2),
                    ("stage.dispatch", 12.0, 12.004), ("stage.dispatch", 19.999, 20.5),
                    ("stage.dispatch", 20.0, 20.1), ("stage.dispatch", 20.2, 20.3),
                    ("stage.drain", 13.0, 13.1)])
    # 10.0 is the window's opening: outside; 20.0, its closing: inside
    assert spans.ranges(run, "stage.dispatch") == [(12.0, 12.004), (19.999, 20.5), (20.0, 20.1)]
    assert reader("launch_ms.sfx")(run) == pytest.approx(1e3 * (0.004 + 0.501 + 0.1) / 3)


def test_the_launch_and_the_drain_leave_out_their_wait_on_the_card():
    run = fake_run([
        ("stage.dispatch", 11.0, 11.010), ("stage.calib", 11.001, 11.002),
        ("stage.sync", 11.004, 11.009),
        ("stage.dispatch", 12.0, 12.008), ("stage.sync", 12.001, 12.007),
        ("stage.drain", 13.0, 13.030), ("stage.sync", 13.001, 13.021),
        ("stage.drain", 14.0, 14.002), ("stage.sync", 14.0005, 14.0015),
        ("stage.sync", 9.9, 9.95),  # before the window: in no range of it
        ("stage.dispatch", 9.0, 9.5), ("stage.drain", 21.0, 21.5),
    ])
    # dispatches 10 - 5 and 8 - 6 ms; drains 30 - 20 and 2 - 1 ms
    assert reader("launch_ms.resnet")(run) == pytest.approx((5.0 + 2.0) / 2)
    assert reader("drain_host_ms.sfx")(run) == pytest.approx((10.0 + 1.0) / 2)
    assert spans.self_seconds(run, "stage.dispatch", "stage.sync") == pytest.approx(
        [0.005, 0.002])


def test_readers_give_nothing_without_their_ranges():
    # the parent's program: a dispatch range with no sync inside, no drain,
    # no batcher or hand-off range
    run = fake_run([("stage.dispatch", 11.0, 11.01), ("stage.device_put", 11.5, 11.6),
                    ("portbench.step", 11.0, 11.01), ("stage.sync", 21.0, 21.1),
                    ("stage.batch", 9.0, 9.5), ("stage.wait_staged", 20.5, 20.6)],
                   batches=[11.02, 12.0], host=[11.4, 11.6])
    for name in ("launch_ms.resnet", "drain_host_ms.sfx", "batch_copy_ms.sfx",
                 "infeed_wait_ms.sfx"):
        assert reader(name)(run) is None, name
    assert reader("launch_ms.sfx")(run) == pytest.approx(10.0)
    run.trace = None
    for name in ("launch_ms.resnet", "launch_ms.sfx", "drain_host_ms.sfx", "batch_copy_ms.sfx",
                 "infeed_wait_ms.sfx"):
        assert reader(name)(run) is None, name


def test_per_batch_readers_divide_by_the_windows_own_batches():
    ranges = [("stage.batch", 11.0, 11.004), ("stage.batch", 11.1, 11.102),
              ("stage.batch", 15.0, 15.006), ("stage.batch", 9.0, 9.9),
              ("stage.wait_staged", 12.0, 12.03), ("stage.wait_staged", 16.0, 16.01),
              ("stage.wait_staged", 20.5, 21.0)]
    # staged in the window: 11.2, 15.1, 20.0 (not 9.95, 20.01); done: 12.5, 16.5 (not 10.0, 21)
    run = fake_run(ranges, batches=[10.0, 12.5, 16.5, 21.0],
                   host=[9.95, 11.2, 15.1, 20.0, 20.01])
    assert (spans.batches_staged(run), spans.batches_done(run)) == (3, 2)
    assert reader("batch_copy_ms.sfx")(run) == pytest.approx((4.0 + 2.0 + 6.0) / 3)
    assert reader("infeed_wait_ms.sfx")(run) == pytest.approx((30.0 + 10.0) / 2)
    no_batch = fake_run(ranges)
    assert reader("batch_copy_ms.sfx")(no_batch) is None
    assert reader("infeed_wait_ms.sfx")(no_batch) is None


def test_each_new_reader_is_a_program_span_metric_of_its_cell(bench):
    cells = {"launch_ms.resnet": "resnet_b32", "launch_ms.sfx": "sfx_b8",
             "drain_host_ms.sfx": "sfx_b8", "batch_copy_ms.sfx": "sfx_b8",
             "infeed_wait_ms.sfx": "sfx_b8"}
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, cell in cells.items():
        m = entries[name]
        assert (m["source"], m["unit"], m["better"], m["workloads"]) == (
            "program_span", "ms", "lower", [cell])
        assert m in core.reported(bench, cell, "per_layer")
