"""The port's serving gateway (``psana_ray_tpu_torch.serving``) against the
JAX package's (``psana_ray_tpu.serving``) on the same inputs.

``SloPolicy``: batch choice over backlogs, the admission budget normal
and degraded, the predicted sojourn, capacity and the ``observe_service``
EWMA, equal for both packages. ``ServingGateway`` on a simulated clock:
one offer/dispatch script, drawn from a numpy seed (three tenants at 2:1:1
weights offering in bursts past capacity, an escalation and a restore
mid-run, a drain at the end), gives the same admit and shed decisions, the
same dispatch sizes and tenant order, the same released leases and the
same telemetry in both packages; so does ``serve_queue`` over each
package's ring with an end-of-stream marker. Then ``make_batch_dispatch``
pads a partial dispatch to its operating point as the JAX one does (the
same arrays), ``run`` and ``drain`` never enter the dispatch callable at
once, and the stall detector escalates a gateway bound mid-episode and
restores it when the last episode clears, in both packages alike.
"""

import threading
import time

import numpy as np
import pytest

import psana_ray_tpu.obs.stall as jax_stall
import psana_ray_tpu.serving as jax_serving
import psana_ray_tpu_torch.obs.stall as port_stall
import psana_ray_tpu_torch.serving as port_serving

PACKAGES = {"jax": jax_serving, "port": port_serving}
STALL = {"jax": jax_stall, "port": port_stall}


def _both(scenario):
    ref, got = scenario("jax"), scenario("port")
    assert got == ref
    return ref


POINTS = ((1, 1.1), (2, 1.6), (4, 2.7), (8, 4.9), (16, 9.5), (32, 18.0))


def test_slo_policy_decides_alike():
    rng = np.random.default_rng(0)
    backlogs = [0, 1, 2, 3, 5, 8, 15, 16, 17, 31, 32, 33, 200, *rng.integers(0, 100, 40)]
    observed = [(int(b), float(ms)) for b, ms in zip(rng.choice([1, 2, 3, 4, 7, 8, 30, 32, 64],
                                                                 60),
                                                      rng.uniform(0.2, 40.0, 60))]

    def run(pkg):
        out = []
        for slo, points in ((25.0, None), (30.0, POINTS), (6.0, POINTS)):
            p = PACKAGES[pkg].SloPolicy(slo_ms=slo, operating_points=points)
            out.append((p.max_batch, p.min_batch, p.batch_sizes(), p.capacity_fps(),
                        p.budget_ms(False), p.budget_ms(True)))
            out.append([p.choose_batch(int(b)) for b in backlogs])
            out.append([p.predict_sojourn_ms(int(q), w, tw) for q in backlogs[:12]
                        for w, tw in ((1, 1), (2, 4), (1, 4), (3, 2))])
            for b, ms in observed:
                p.observe_service(b, ms)
                out.append((p.service_ms(b), p.per_frame_ms(b)))
            p.observe_service(4, -1.0)  # ignored
            out.append(p.snapshot())
        return out

    out = _both(run)
    assert out[1][0] == 1 and out[7][-1] != 1  # idle: B1; a backlog batches


def test_slo_policy_refuses_alike():
    for kw in (dict(operating_points=((2, 1.0), (2, 2.0))), dict(operating_points=((1, 0.0),)),
               dict(slo_ms=0.0), dict(shed_margin=0.4, degraded_margin=0.5),
               dict(degraded_margin=0.0)):
        for pkg in PACKAGES:
            with pytest.raises(ValueError):
                PACKAGES[pkg].SloPolicy(**kw)


class Rec:
    """A frame stand-in: its tenant, its id and a lease to release."""

    trace = None

    def __init__(self, tenant, i, released):
        self.tenant, self.i, self._released = tenant, i, released

    def release(self):
        self._released.append((self.tenant, self.i))


def _script(seed=7, steps=120):
    """Offers a step ``[(tenant, count)]``, dispatches a step, and the
    steps where the stall escalation rises and falls."""
    rng = np.random.default_rng(seed)
    offers = []
    for s in range(steps):
        burst = s % 10 < 6  # bursts past capacity, then quiet
        offers.append([(t, int(rng.poisson(lam * (3.0 if burst else 0.3))))
                       for t, lam in (("t0", 2.0), ("t1", 1.0), ("t2", 1.0))])
    dispatches = rng.integers(0, 3, steps)
    return offers, dispatches, 40, 70


def _gateway_run(pkg, offers, dispatches, escalate_at, restore_at):
    mod = PACKAGES[pkg]
    clock = [100.0]
    log, released = [], []

    def dispatch(recs, batch):
        log.append((batch, [(r.tenant, r.i) for r in recs]))
        for r in recs:
            r.release()
        clock[0] += (0.5 + 0.5 * batch) / 1000.0  # the device time of the point

    gw = mod.ServingGateway(dispatch, policy=mod.SloPolicy(slo_ms=100.0, operating_points=POINTS),
                            weights={"t0": 2, "t1": 1, "t2": 1},
                            telemetry=mod.GatewayTelemetry(register=False),
                            clock=lambda: clock[0])
    admitted, handled = [], []
    n = 0
    for step, (burst, k) in enumerate(zip(offers, dispatches)):
        if step == escalate_at:
            gw.escalate("test")
        if step == restore_at:
            gw.restore()
        for tenant, count in burst:
            for _ in range(count):
                admitted.append(gw.offer(Rec(tenant, n, released), tenant=tenant))
                n += 1
        for _ in range(int(k)):
            handled.append(gw.dispatch_once())
        clock[0] += 0.001
    gw.drain()
    stats = gw.telemetry.stats()
    return (admitted, handled, log, sorted(released), stats, gw.telemetry.shed_by_path(),
            gw.telemetry.tenant_goodput(), gw.policy.snapshot(), gw.backlog(),
            gw.offered_fps_by_tenant())


def test_gateway_on_a_simulated_clock_decides_alike():
    offers, dispatches, up, down = _script()
    out = _both(lambda pkg: _gateway_run(pkg, offers, dispatches, up, down))
    admitted, handled, log, released, stats, by_path = out[:6]
    offered = sum(c for burst in offers for _, c in burst)
    # conservation: every frame offered is completed or shed, none lost
    assert stats["offered_total"] == offered == len(admitted) == len(released)
    assert stats["offered_total"] == stats["completed_total"] + stats["shed_total"]
    assert out[8] == 0  # the backlog drained
    assert stats["shed_total"] == sum(by_path.values()) > 0
    assert by_path["admission"] > 0 and stats["escalations"] == stats["restores"] == 1
    assert {b for b, _ in log} > {1}  # the batch follows the backlog
    assert {t for _, recs in log for t, _ in recs} == {"t0", "t1", "t2"}


def _serve_queue_run(pkg, n_frames=40):
    import importlib

    mod = PACKAGES[pkg]
    root = pkg == "jax" and "psana_ray_tpu" or "psana_ray_tpu_torch"
    records = importlib.import_module(f"{root}.records")
    ring = importlib.import_module(f"{root}.transport.ring")
    q = ring.RingBuffer(n_frames + 4)
    for i in range(n_frames):
        q.put(records.FrameRecord(i % 3, i, np.full((2, 4, 4), i, np.float32), 9.5))
    q.put(records.EndOfStream(total_events=n_frames))
    clock = [10.0]
    log = []

    def dispatch(recs, batch):
        log.append((batch, [(r.shard_rank, r.event_idx) for r in recs]))
        clock[0] += 0.0005 * batch

    gw = mod.ServingGateway(dispatch, policy=mod.SloPolicy(slo_ms=200.0, operating_points=POINTS),
                            weights={"t0": 2}, telemetry=mod.GatewayTelemetry(register=False),
                            clock=lambda: clock[0])
    gw.serve_queue(q, tenant_of=lambda r: f"t{r.shard_rank}", poll_interval_s=0.001,
                   max_wait_s=5.0)
    stats = gw.telemetry.stats()
    for t in ("t0", "t1", "t2"):
        stats[t].pop("p99_ms")  # times in the reservoir: the clock's, equal, but kept out
    return log, stats, q.size()


def test_serve_queue_drains_to_eos_alike():
    log, stats, left = _both(_serve_queue_run)
    assert sorted(i for _, recs in log for _, i in recs) == list(range(40))
    assert stats["completed_total"] == 40 and stats["shed_total"] == 0 and left == 0


def _frames(root, n, shape=(2, 3, 5)):
    import importlib

    records = importlib.import_module(f"{root}.records")
    return [records.FrameRecord(1, i, np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
                                + i, 7.0 + i) for i in range(n)]


def test_make_batch_dispatch_pads_to_the_operating_point_as_the_jax_one():
    out = {}
    for pkg, root in (("jax", "psana_ray_tpu"), ("port", "psana_ray_tpu_torch")):
        got = []
        d = PACKAGES[pkg].make_batch_dispatch(
            lambda b: got.append([np.array(a, copy=True) for a in
                                  (b.frames, b.valid, b.shard_rank, b.event_idx,
                                   b.photon_energy)] + [b.num_valid]))
        recs = _frames(root, 11)
        d(recs[:3], 4)  # a partial dispatch: padded to 4 now
        d(recs[3:11], 8)  # a full one
        d(recs[:1], 1)
        out[pkg] = got
    assert len(out["port"]) == len(out["jax"]) == 3
    for a, b in zip(out["port"], out["jax"]):
        for x, y in zip(a[:5], b[:5]):
            np.testing.assert_array_equal(x, y)
        assert a[5] == b[5]
    assert out["port"][0][5] == 3 and list(out["port"][0][1]) == [1, 1, 1, 0]
    assert not out["port"][0][0][3].any()  # the padding row is zero


def test_make_batch_dispatch_keeps_one_batcher_a_size_and_releases_each_lease():
    released = []

    class Leased:
        def __init__(self, rec):
            self.rec = rec

        def __getattr__(self, name):
            return getattr(self.rec, name)

        def release(self):
            released.append(self.rec.event_idx)

    batches = []
    d = port_serving.make_batch_dispatch(lambda b: batches.append(b.batch_size), n_buffers=2)
    recs = [Leased(r) for r in _frames("psana_ray_tpu_torch", 7)]
    d(recs[:4], 4)
    d(recs[4:5], 1)
    d(recs[5:7], 4)
    assert batches == [4, 1, 4] and sorted(released) == list(range(7))
    assert sorted(d.batchers) == [1, 4] and len(d.batchers[4].pool) == 2


def test_dispatch_is_serialized_between_run_and_drain():
    inside, overlap, seen = [0], [0], []
    lock = threading.Lock()

    def dispatch(recs, batch):
        with lock:
            inside[0] += 1
            overlap[0] = max(overlap[0], inside[0])
        time.sleep(0.002)
        seen.extend(r.i for r in recs)
        with lock:
            inside[0] -= 1

    gw = port_serving.ServingGateway(
        dispatch, policy=port_serving.SloPolicy(slo_ms=10_000.0, operating_points=POINTS),
        telemetry=port_serving.GatewayTelemetry(register=False))
    released = []
    for i in range(200):
        assert gw.offer(Rec("t", i, released))
    stop = threading.Event()
    t = threading.Thread(target=gw.run, args=(stop,), daemon=True)
    t.start()
    gw.drain()
    stop.set()
    t.join(timeout=5.0)
    assert overlap[0] == 1 and sorted(seen) == list(range(200)) and gw.backlog() == 0


class _Queue:
    """A queue whose stats a test sets."""

    def __init__(self):
        self.depth, self.puts, self.gets = 0, 0, 0

    def stats(self):
        return {"depth": self.depth, "maxsize": 4, "puts": self.puts, "gets": self.gets}


def _stall_run(pkg):
    mod, stall = PACKAGES[pkg], STALL[pkg]
    gw = mod.ServingGateway(lambda r, b: None, telemetry=mod.GatewayTelemetry(register=False))
    late = mod.ServingGateway(lambda r, b: None, telemetry=mod.GatewayTelemetry(register=False))
    q = _Queue()
    det = stall.StallDetector(full_threshold_s=2.0, idle_threshold_s=100.0).watch("q", q)
    det.bind_gateway(gw)
    trace = []
    for t in range(12):
        if t == 2:
            q.depth = 4  # pegged at maxsize: backpressure after 2 s
        if t == 6:
            det.bind_gateway(late)  # bound mid-episode: escalated at once
        if t == 9:
            q.depth = 1  # cleared
        q.puts += 1
        q.gets += 1
        det.poll_once(now=float(t))
        trace.append((det.degraded, gw.degraded, late.degraded))
    return (trace, gw.telemetry.stats()["escalations"], gw.telemetry.stats()["restores"],
            late.telemetry.stats()["escalations"], late.telemetry.stats()["restores"])


def test_stall_detector_escalates_and_restores_bound_gateways_alike():
    trace, esc, res, late_esc, late_res = _both(_stall_run)
    assert trace[3] == (False, False, False) and trace[4] == (True, True, False)
    assert trace[6] == (True, True, True)  # the late gateway caught up at bind
    assert trace[-1] == (False, False, False)
    assert (esc, res, late_esc, late_res) == (1, 1, 1, 1)


def test_gateway_source_keys_match_the_jax_names():
    def run(pkg):
        mod = PACKAGES[pkg]
        gw = mod.ServingGateway(lambda r, b: None,
                                telemetry=mod.GatewayTelemetry(register=False),
                                clock=lambda: 5.0)
        gw.offer(Rec("a", 0, []), tenant="a")
        gw.drain()
        snap = gw.telemetry.snapshot()
        snap["a"].pop("p99_ms")
        return snap, mod.SHED_PATHS

    snap, paths = _both(run)
    assert {"shed_total", "completed_total", "offered_total", "degraded", "backlog",
            "shed_admission_total", "shed_deadline_total", "shed_stall_total"} <= set(snap)
    assert paths == ("admission", "deadline", "stall")


def test_the_gateway_registers_its_source():
    from psana_ray_tpu_torch.obs.registry import MetricsRegistry

    gw = port_serving.ServingGateway(lambda r, b: None)
    assert MetricsRegistry.default().snapshot()["gateway"]["backlog"] == gw.backlog() == 0
