"""The port's autotune (``psana_ray_tpu_torch.autotune``) against the JAX
package's (``psana_ray_tpu.autotune``) on the same inputs.

The hill climbers of both packages are fed the same timed
``TimeSeriesStore`` samples, their noise drawn from one numpy seed, over
fake knobs, and must give the same decision list tick by tick (the
decision, the knob, the value set, kept or reverted) and leave the knob
at the same value, for: convergence on a surface, a regression revert
with its direction flip, a guardrail trip, a starved abort and observe
mode. Then ``Knob.clamp``, ``clip`` and ``neighbor`` over a grid, pins
and excluded groups (a bound gateway's ``serving`` group), every knob
factory's declaration, the ``autotune`` source's shape and
``add_autotune_args``'s flags and defaults. Pure stdlib on both sides:
no torch, no device.
"""

import argparse
import itertools
import time

import numpy as np
import pytest

import psana_ray_tpu.autotune as jax_at
import psana_ray_tpu.autotune.knobs as jax_knobs
import psana_ray_tpu.obs.timeseries as jax_ts
import psana_ray_tpu_torch.autotune as port_at
import psana_ray_tpu_torch.autotune.knobs as port_knobs
import psana_ray_tpu_torch.obs.timeseries as port_ts

PACKAGES = {
    "jax": (jax_at, jax_knobs, jax_ts),
    "port": (port_at, port_knobs, port_ts),
}


def _climber(pkg, start=8.0, mode="on", guardrails=(), groups=("g",), **kw):
    """A registry of fake knobs ``k0, k1, ...`` (one a group), its store
    and a hill climber over them."""
    at, knobs, ts = PACKAGES[pkg]
    store = ts.TimeSeriesStore()
    reg = knobs.KnobRegistry(mode=mode)
    vals = []
    for i, group in enumerate(groups):
        val = [start]
        vals.append(val)
        reg.register(knobs.Knob(
            f"k{i}", group, "client", lo=1, hi=64, step=4,
            get=lambda v=val: v[0], set=lambda x, v=val: v.__setitem__(0, x)))
    kw.setdefault("hold_ticks", 2)
    kw.setdefault("settle_ticks", 3)
    kw.setdefault("cooldown_ticks", 2)
    hc = at.HillClimber(reg, at.Objective("syn.frames_total", window_s=2.5), store=store,
                        guardrails=[at.Guardrail(*g) for g in guardrails], **kw)
    return store, reg, vals, hc


def _drive(hc, store, vals, surface, ticks, noise, shed=None, t0=1000.0):
    """One sample a second of fake time, a tick after each; the decision
    list, one entry a tick: ``(decision or None, the knobs' values)``.
    ``surface`` maps the knobs' values to frames a second, ``noise`` adds
    a seeded draw a tick, ``shed`` gives the shed counter's rate a tick."""
    out = []
    cum = getattr(store, "_cum", {"frames": 0.0, "shed": 0.0, "t": t0})
    store._cum = cum
    for i in range(ticks):
        cum["frames"] += surface(*[v[0] for v in vals]) + noise[i]
        cum["t"] += 1.0
        tree = {"syn": {"frames_total": cum["frames"]}}
        if shed is not None:
            cum["shed"] += shed(i)
            tree["gateway"] = {"shed_total": cum["shed"]}
        store.record(tree, now=cum["t"])
        out.append((hc.tick(), tuple(v[0] for v in vals)))
    return out


def _both(scenario):
    """``scenario(pkg)`` for both packages; returns the JAX result after
    asserting the port's is equal."""
    ref, got = scenario("jax"), scenario("port")
    assert got == ref
    return ref


def _decisions(trace):
    return [d for d, _ in trace if d is not None]


def test_convergence_on_a_surface_gives_the_same_decisions():
    noise = np.random.default_rng(0).normal(0.0, 3.0, 400)

    def run(pkg):
        store, reg, vals, hc = _climber(pkg)
        trace = _drive(hc, store, vals, lambda k: 1000.0 - abs(k - 33.0) * 10.0, 400, noise)
        return trace, reg.snapshot(), hc.snapshot()

    trace, snap, hc_snap = _both(run)
    assert abs(trace[-1][1][0] - 33.0) <= 4.0  # walked to the peak
    assert snap["k0"]["kept_total"] > 0 and snap["k0"]["reverts_total"] > 0
    assert {d["decision"] for d in _decisions(trace)} == {"keep", "revert"}
    assert hc_snap["decisions_total"] == len(_decisions(trace))


def test_regression_reverts_and_flips_direction_alike():
    noise = np.random.default_rng(1).normal(0.0, 2.0, 120)

    def run(pkg):
        store, reg, vals, hc = _climber(pkg, start=33.0)
        return _drive(hc, store, vals, lambda k: 2000.0 - k * 10.0, 120, noise), reg.snapshot()

    trace, snap = _both(run)
    decisions = _decisions(trace)
    assert decisions and decisions[0]["decision"] == "revert"
    assert decisions[0]["why"] == "regression" and decisions[0]["restored"] == 33.0
    # the revert flipped the direction: the next probe goes down and holds
    assert any(d["decision"] == "keep" and d["value"] < 33.0 for d in decisions)
    assert snap["k0"]["reverts_total"] == sum(d["decision"] == "revert" for d in decisions)
    assert trace[-1][1][0] <= 33.0


def test_guardrail_trip_reverts_the_open_probe_alike():
    rng = np.random.default_rng(2)
    noise = rng.normal(0.0, 2.0, 40)

    def run(pkg):
        store, reg, vals, hc = _climber(
            pkg, guardrails=[("gateway.shed_total", "rate_above", 1.0)])
        # upward probes improve; the shed counter spikes from tick 12 to 26
        trace = _drive(hc, store, vals, lambda k: 1000.0 + k * 50.0, 40, noise,
                       shed=lambda i: 50.0 if 12 <= i < 26 else 0.0)
        return trace, hc.guardrail_trips, reg.snapshot()["k0"]["actuations_total"]

    trace, trips, actuations = _both(run)
    guard = [d for d in _decisions(trace) if d.get("why", "").startswith("guardrail")]
    assert guard and guard[0]["why"] == "guardrail:gateway.shed_total"
    assert trips > 0
    # frozen through the episode: no probe opens while the spike lasts
    values = [v for _, v in trace[13:26]]
    assert len(set(values[1:])) == 1


def test_starved_metrics_abort_an_open_probe_alike():
    noise = np.zeros(3)

    def run(pkg):
        at, _, ts = PACKAGES[pkg]
        store, reg, vals, hc = _climber(pkg, max_starved_ticks=3, settle_ticks=0)
        trace = _drive(hc, store, vals, lambda k: 1000.0, 3, noise)
        assert vals[0][0] == 13.0  # the probe is open at the stepped value
        hc._store = ts.TimeSeriesStore()  # starve the objective
        trace += [(hc.tick(), (vals[0][0],)) for _ in range(6)]
        return trace

    trace = _both(run)
    aborted = [d for d in _decisions(trace) if d.get("why") == "metrics-starved"]
    assert aborted and aborted[0]["restored"] == 8.0 and trace[-1][1] == (8.0,)


def test_observe_mode_decides_alike_and_actuates_nothing():
    noise = np.random.default_rng(3).normal(0.0, 1.0, 60)

    def run(pkg):
        store, reg, vals, hc = _climber(pkg, mode="observe", groups=("g", "h"))
        trace = _drive(hc, store, vals, lambda a, b: 1000.0 + a + b, 60, noise)
        snap = reg.snapshot()
        return trace, snap["observed_total"], snap["k0"]["actuations_total"]

    trace, observed, actuated = _both(run)
    decisions = _decisions(trace)
    assert decisions and all(d["decision"] == "observe" for d in decisions)
    assert {d["knob"] for d in decisions} == {"k0", "k1"}  # the rotation, both knobs
    assert observed == len(decisions) and actuated == 0
    assert {v for _, v in trace} == {(8.0, 8.0)}


KNOB_SPECS = (
    dict(lo=1, hi=64, step=4),
    dict(lo=0.001, hi=0.05, step=0.001),
    dict(lo=8, hi=1024, step=8),
    dict(lo=3, hi=10, step=2.5),
    dict(lo=0.0, hi=1.0, step=1.0, values=(0.0, 1.0)),
    dict(lo=0, hi=0, step=1, values=(4, 16, 2, 64)),
)


@pytest.mark.parametrize("spec", range(len(KNOB_SPECS)))
def test_knob_clamp_clip_and_neighbor_over_a_grid(spec):
    kw = KNOB_SPECS[spec]
    knobs = {pkg: PACKAGES[pkg][1].Knob("x", "g", "client", get=float, set=print, **kw)
             for pkg in PACKAGES}
    grid = np.concatenate([np.linspace(kw["lo"] - 3, kw["hi"] + 3, 97),
                           np.random.default_rng(spec).uniform(-10, 2000, 64)])
    for v, direction in itertools.product(grid.tolist(), (1, -1)):
        ref, got = knobs["jax"], knobs["port"]
        assert got.clamp(v) == ref.clamp(v), v
        assert got.clip(v) == ref.clip(v), v
        assert got.neighbor(v, direction) == ref.neighbor(v, direction), (v, direction)


def test_knob_refuses_alike():
    for kw in (dict(lo=1, hi=0, step=1), dict(lo=0, hi=1, step=0)):
        for pkg in PACKAGES:
            with pytest.raises(ValueError):
                PACKAGES[pkg][1].Knob("x", "g", "client", get=float, set=print, **kw)
    for pkg in PACKAGES:
        with pytest.raises(ValueError):
            PACKAGES[pkg][1].KnobRegistry(mode="off")


def test_pins_and_excluded_groups_leave_the_rotation_alike():
    def run(pkg):
        _, knobs, _ = PACKAGES[pkg]
        reg = knobs.KnobRegistry()
        for name, group in (("a", "transport"), ("b", knobs.GROUP_SERVING), ("c", "drain"),
                            ("d", "memory"), ("e", "codec")):
            reg.register(knobs.Knob(name, group, "client", lo=1, hi=8, step=1, get=lambda: 2.0,
                                    set=lambda v: None),
                         pinned_reason="--e set explicitly" if name == "e" else None)
        assert reg.register(None) is None
        with pytest.raises(ValueError):
            reg.register(knobs.Knob("a", "g", "client", lo=1, hi=2, step=1, get=float,
                                    set=print))
        out = [reg.eligible()]
        reg.note_gateway(object())
        out.append(reg.eligible())
        reg.pin("a", "operator")
        reg.exclude_group("memory", "test")
        out.append(reg.eligible())
        with pytest.raises(KeyError):
            reg.pin("zz", "no such knob")
        out.append(reg.snapshot())
        return out

    eligible = _both(run)
    assert eligible[0] == ["a", "b", "c", "d"]
    assert eligible[1] == ["a", "c", "d"]  # the gateway owns the serving group
    assert eligible[2] == ["c"]


class _Target:
    """Every live dial a knob factory looks for."""

    put_window = 32
    stream_window = 32
    codec_name = None
    prefetch_depth = 2
    fsync_batch_n = 64
    ram_items = 100
    min_per_class = 4
    chunk = 8
    poll_s = 0.01

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("set_") or name == "renegotiate_codec":
            return lambda *a: self.calls.append((name, a))
        raise AttributeError(name)


FACTORIES = ("put_window_knob", "stream_window_knob", "drain_chunk_knob", "drain_poll_knob",
             "prefetch_depth_knob", "fsync_batch_knob", "ram_items_knob",
             "bufpool_retention_knob", "wire_codec_knob")


@pytest.mark.parametrize("factory", FACTORIES)
def test_every_knob_factory_declares_alike(factory):
    fields = ("name", "group", "side", "lo", "hi", "step", "cost", "values")
    knobs = {pkg: getattr(PACKAGES[pkg][1], factory)(_Target()) for pkg in PACKAGES}
    assert knobs["port"] is not None
    assert [getattr(knobs["port"], f) for f in fields] == [getattr(knobs["jax"], f)
                                                           for f in fields]
    assert knobs["port"].get() == knobs["jax"].get()
    # a target without the dial: the factories that can decline do
    if factory not in ("drain_chunk_knob", "drain_poll_knob"):
        assert getattr(port_knobs, factory)(object()) is None


def test_workers_knob_recommends_without_actuating():
    fields = ("name", "group", "side", "lo", "hi", "step", "cost")
    ref, got = jax_knobs.workers_knob(current=2), port_knobs.workers_knob(current=2)
    if ref is None:  # a one-core machine: both decline
        assert got is None
        return
    assert [getattr(got, f) for f in fields] == [getattr(ref, f) for f in fields]
    got.set(3.0)
    assert got.get() == 3.0  # recorded for the next restart, nothing resized


def test_autotune_source_shape_and_flags_alike():
    def run(pkg):
        at, knobs, ts = PACKAGES[pkg]
        store, reg, vals, hc = _climber(pkg, groups=("g", "h"))
        _drive(hc, store, vals, lambda a, b: 1000.0 + a - b, 20, np.zeros(20))
        d = at.AutotuneDaemon(hc, interval_s=0.5)
        snap = d.snapshot()
        p = argparse.ArgumentParser()
        at.add_autotune_args(p)
        flags = {a.dest: (a.option_strings, a.default, a.choices, a.type)
                 for a in p._actions if a.dest != "help"}
        return snap, flags, [g.__dict__ for g in at.default_guardrails()]

    snap, flags, guards = _both(run)
    assert {"mode", "knobs_total", "pinned_total", "observed_total", "ticks_total",
            "decisions_total", "guardrail_trips_total", "probe_open", "guard_frozen",
            "interval_s", "k0", "k1"} <= set(snap)
    assert set(snap["k0"]) == {"current", "lo", "hi", "pinned", "actuations_total",
                               "reverts_total", "kept_total", "min_actuated", "max_actuated"}
    assert flags["autotune"][1:3] == ("off", ("off", "on", "observe"))
    assert flags["autotune_interval"][1] == 2.0
    assert [g["key"] for g in guards] == ["stalls.degraded", "gateway.shed_total",
                                         "collector.alerts_active"]


def test_configure_from_args_registers_the_source_and_starts_the_history():
    from psana_ray_tpu_torch.obs.registry import MetricsRegistry

    p = argparse.ArgumentParser()
    port_at.add_autotune_args(p)
    assert port_at.configure_autotune_from_args(p.parse_args([]), [], None) is None  # off
    a = p.parse_args(["--autotune", "observe", "--autotune_interval", "0.05"])
    assert port_ts.default_history() is None
    val = [8.0]
    knob = port_knobs.Knob("k", "g", "client", lo=1, hi=64, step=4, get=lambda: val[0],
                           set=lambda v: val.__setitem__(0, v))
    d = port_at.configure_autotune_from_args(a, [knob, None],
                                             port_at.Objective("syn.frames_total"),
                                             pinned={"k": "operator"}, gateway=object())
    try:
        assert port_ts.default_history() is not None  # started for the controller
        assert d.interval_s == 0.1  # floored, as the JAX daemon floors it
        snap = MetricsRegistry.default().snapshot()["autotune"]
        assert snap["mode"] == "observe" and snap["k"]["pinned"] == 1
        assert d.controller.registry.eligible() == []
    finally:
        d.stop()
        port_ts.stop_default_history()


def test_a_knob_registered_while_the_daemon_ticks_joins_the_rotation():
    """A queue server's named queue registers its dials after the daemon
    started: registration takes the registry's lock and the next rotation
    (``eligible()``) sees the new knob, which the controller then probes."""
    import threading

    store = port_ts.TimeSeriesStore()
    reg = port_knobs.KnobRegistry()
    vals = {"a": [8.0], "late": [8.0]}

    def knob(name):
        v = vals[name]
        return port_knobs.Knob(name, name, "server", lo=1, hi=64, step=4, get=lambda: v[0],
                               set=lambda x: v.__setitem__(0, x))

    reg.register(knob("a"))
    hc = port_at.HillClimber(reg, port_at.Objective("syn.frames_total", window_s=2.5),
                             store=store, hold_ticks=1, settle_ticks=0, cooldown_ticks=0)
    done, errors = threading.Event(), []

    def tick():
        t, frames = 1000.0, 0.0
        try:
            while not done.is_set():
                t += 1.0
                frames += 1000.0 + vals["a"][0] + vals["late"][0]
                store.record({"syn": {"frames_total": frames}}, now=t)
                hc.tick()
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    thread = threading.Thread(target=tick, daemon=True)
    thread.start()
    try:
        for i in range(50):
            reg.register(port_knobs.Knob(f"x{i}", "g", "server", lo=1, hi=2, step=1,
                                         get=lambda: 1.0, set=lambda v: None))
        reg.register(knob("late"))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not reg.snapshot()["late"]["actuations_total"]:
            time.sleep(0.01)
    finally:
        done.set()
        thread.join(timeout=10)
    assert not errors
    assert "late" in reg.eligible() and reg.snapshot()["late"]["actuations_total"] > 0
