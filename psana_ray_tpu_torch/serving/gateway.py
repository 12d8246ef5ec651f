"""The serving gateway: admission, deadline shedding, weighted fair share.

The port's copy of ``psana_ray_tpu/serving/gateway.py``. Frames enter
through :meth:`ServingGateway.offer`, the front door, where a frame that
cannot meet its deadline is shed at once, before any batcher or device
time is spent on it. Admitted frames queue a tenant; the dispatch loop
(:meth:`~ServingGateway.run`, :meth:`~ServingGateway.serve_queue`) serves
tenants by weighted deficit round-robin, checks each frame's deadline
again at dequeue (a frame that aged out in the queue is dropped loudly,
breadcrumb and counter, never processed late), picks the batch size from
the :class:`~psana_ray_tpu_torch.serving.policy.SloPolicy` frontier, and
feeds each dispatch's measured wall time back into the policy.

Shedding is never silent: every path (admission, dequeue age-out, stall
escalation) counts in the same family of
:class:`~psana_ray_tpu_torch.serving.telemetry.GatewayTelemetry` and
leaves a flight breadcrumb (rate-limited a path, so an overload cannot
flood the bounded flight ring); offered == completed + shed + backlog.

The stall detector escalates the gateway (``escalate``/``restore``, wired
by :meth:`psana_ray_tpu_torch.obs.stall.StallDetector.bind_gateway`):
while degraded, admission runs against the smaller ``degraded_margin``
budget, so the system sheds more at the door instead of letting every
queue grow.

Copies: a shed frame's transport lease is released here (the only owner
left); an admitted frame keeps its lease until the dispatch callable
consumes it (:func:`make_batch_dispatch` copies it into a batch arena with
``FrameBatcher.push_view``: one host copy a frame).

The dispatch loop neither sleeps nor waits unbounded: an idle pause is a
bounded ``Event`` wait that :meth:`~ServingGateway.offer` wakes.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from psana_ray_tpu_torch.obs.flight import FLIGHT
from psana_ray_tpu_torch.records import EndOfStream, EosTally
from psana_ray_tpu_torch.serving.policy import SloPolicy
from psana_ray_tpu_torch.serving.telemetry import (
    GatewayTelemetry,
    PATH_ADMISSION,
    PATH_DEADLINE,
    PATH_STALL,
)
from psana_ray_tpu_torch.transport.registry import TransportClosed

# breadcrumb rate limit: first shed on a path always leaves one, then
# one per this many sheds (cumulative count rides the breadcrumb) — the
# flight ring is bounded, an overload must not evict the rare events
# the ring exists for
_BREADCRUMB_EVERY = 256


def _release(rec) -> None:
    """Return a shed frame's transport lease (pooled TCP recv buffer /
    shm slot) — no-op for records that own their memory."""
    release = getattr(rec, "release", None)
    if release is not None:
        release()


def _trace_id(rec) -> Optional[int]:
    """The sampled trace id riding a record's envelope, or None: the
    exemplar the latency histograms keep a bucket."""
    ctx = getattr(rec, "trace", None)
    if ctx is not None and getattr(ctx, "sampled", False):
        return ctx.trace_id
    return None


class _TenantQ:
    """One tenant's admitted-frame queue, its WDRR deficit and the
    measured arrival-rate window (admission predicts from the rate and the
    backlog, not the backlog alone)."""

    __slots__ = ("name", "weight", "q", "deficit", "arrivals")

    # arrival timestamps kept at most this many (bounds memory under a
    # flood; the rate window trims by TIME, this trims by count)
    ARRIVALS_CAP = 4096

    def __init__(self, name: str, weight: int):
        self.name = name
        self.weight = max(1, int(weight))
        self.q: deque = deque()  # (deadline, admit_t, rec) in admit order
        self.deficit = 0.0
        self.arrivals: deque = deque(maxlen=self.ARRIVALS_CAP)  # offer() times

    def note_arrival(self, now: float, window_s: float) -> None:
        """Record one offer() (admitted OR shed — offered rate is the
        demand signal) and trim the window."""
        self.arrivals.append(now)
        cutoff = now - window_s
        while self.arrivals and self.arrivals[0] < cutoff:
            self.arrivals.popleft()

    def rate_active(self, now: float, window_s: float) -> bool:
        """Did this tenant offer anything within the rate window?"""
        cutoff = now - window_s
        while self.arrivals and self.arrivals[0] < cutoff:
            self.arrivals.popleft()
        return bool(self.arrivals)

    def offered_fps(self, now: float, window_s: float) -> float:
        cutoff = now - window_s
        while self.arrivals and self.arrivals[0] < cutoff:
            self.arrivals.popleft()
        if not self.arrivals:
            return 0.0
        return len(self.arrivals) / window_s


class ServingGateway:
    """Admission + shedding + WDRR dispatch over per-tenant queues.

    ``dispatch(records, batch_size)`` drives the device: ``records`` is
    the admitted, deadline-checked frame list (``len(records) <=
    batch_size``; the operating point pads the remainder) and MUST
    consume the records' transport leases (``make_batch_dispatch`` does).
    ``weights`` maps tenant name -> integer weight (unlisted tenants get
    ``default_weight``); goodput under overload converges to the weight
    shares. ``clock`` is injectable for deterministic tests.
    """

    def __init__(
        self,
        dispatch: Callable[[List[Any], int], None],
        policy: Optional[SloPolicy] = None,
        weights: Optional[Dict[str, int]] = None,
        default_weight: int = 1,
        telemetry: Optional[GatewayTelemetry] = None,
        clock: Callable[[], float] = time.monotonic,
        rate_window_s: float = 2.0,
    ):
        self._dispatch = dispatch
        self.policy = policy or SloPolicy()
        self._weights = dict(weights or {})
        self._default_weight = max(1, int(default_weight))
        self._clock = clock
        # admission rate window: a tenant that offered within it counts
        # toward the predicted WDRR interleave even while its queue is
        # empty for the moment; 0 predicts from the backlog alone
        self._rate_window_s = max(0.0, float(rate_window_s))
        self._lock = threading.Lock()
        # serializes dispatch_once end to end: the dispatch callable is
        # NOT required to be thread-safe (make_batch_dispatch's
        # FrameBatcher arenas are not), and the documented run()-thread
        # + drain()-caller pattern would otherwise drive it from two
        # threads at once. offer() never takes this lock, so admission
        # stays concurrent with a dispatch in flight.
        self._dispatch_serial = threading.Lock()
        self._tenants: Dict[str, _TenantQ] = {}  # guarded-by: _lock
        self._order: deque = deque()  # WDRR tenant rotation  # guarded-by: _lock
        self._degraded = False  # guarded-by: _lock
        self._backlog = 0  # frames admitted, not yet dispatched  # guarded-by: _lock
        self._shed_since_crumb: Dict[str, int] = {}  # guarded-by: _lock
        self._work = threading.Event()  # offer() -> wake an idle dispatch loop
        self.telemetry = telemetry or GatewayTelemetry()
        self.telemetry.attach(self)

    # -- tenants -----------------------------------------------------------
    def _tenant(self, name: str, weight: Optional[int]) -> _TenantQ:
        # guarded-by-caller: _lock
        tq = self._tenants.get(name)
        if tq is None:
            if weight is None:
                weight = self._weights.get(name, self._default_weight)
            tq = self._tenants[name] = _TenantQ(name, weight)
            self._order.append(name)
        elif weight is not None:
            tq.weight = max(1, int(weight))
        return tq

    def backlog(self) -> int:
        with self._lock:
            return self._backlog

    def offered_fps_by_tenant(self, now: Optional[float] = None) -> Dict[str, float]:
        """Measured per-tenant offered rate over the admission rate
        window: the series the history sampler records and the admission
        predictor reads; empty when rate tracking is off."""
        if self._rate_window_s <= 0.0:
            return {}
        now = self._clock() if now is None else now
        with self._lock:
            return {
                name: round(tq.offered_fps(now, self._rate_window_s), 3)
                for name, tq in self._tenants.items()
            }

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded

    # -- stall-detector escalation ----------------------------------------
    def escalate(self, reason: Any = None) -> None:
        """Raise the shed threshold (admission budget shrinks to the
        policy's ``degraded_margin``). Idempotent; restored by
        :meth:`restore`."""
        with self._lock:
            was = self._degraded
            self._degraded = True
        if not was:
            self.telemetry.escalated()
            FLIGHT.record("gateway_degraded", reason=str(reason or ""))

    def restore(self) -> None:
        with self._lock:
            was = self._degraded
            self._degraded = False
        if was:
            self.telemetry.restored()
            FLIGHT.record("gateway_restored")

    # -- admission (the front door) ---------------------------------------
    def _predicted_sojourn_ms(self, tq: _TenantQ, now: float) -> float:
        """Queue wait + device time a frame admitted NOW would see —
        :meth:`SloPolicy.predict_sojourn_ms` over the ACTIVE weight
        total: a tenant counts toward the predicted WDRR interleave
        when it is backlogged OR its measured offered-rate window is
        hot (a burster whose queue just drained still takes its turns
        during this frame's wait; a share from the backlog alone would
        under-predict by that tenant's slice, and the tail admissions
        would land late)."""
        # guarded-by-caller: _lock
        total_w = tq.weight
        for other in self._tenants.values():
            if other is tq:
                continue
            if other.q or (
                self._rate_window_s > 0.0
                and other.rate_active(now, self._rate_window_s)
            ):
                total_w += other.weight
        return self.policy.predict_sojourn_ms(len(tq.q), tq.weight, total_w)

    def offer(
        self,
        rec: Any,
        tenant: str = "default",
        deadline: Optional[float] = None,
        weight: Optional[int] = None,
        now: Optional[float] = None,
    ) -> bool:
        """Admit-or-shed one frame. ``deadline`` (clock units) defaults
        to now + SLO. Returns True when admitted; a shed frame's lease
        is released and the shed is counted + breadcrumbed (path
        ``admission``, or ``stall`` when only the escalated threshold
        rejected it)."""
        now = self._clock() if now is None else now
        with self._lock:
            tq = self._tenant(tenant, weight)
            if self._rate_window_s > 0.0:
                # the offer itself is the arrival signal (admitted or
                # shed — offered rate measures DEMAND), recorded before
                # the prediction so a tenant's own burst is visible to
                # every same-instant competitor
                tq.note_arrival(now, self._rate_window_s)
            if deadline is None:
                deadline = now + self.policy.slo_ms / 1000.0
            remain_ms = (deadline - now) * 1000.0
            predicted = self._predicted_sojourn_ms(tq, now)
            path = None
            if predicted > min(self.policy.budget_ms(self._degraded), remain_ms):
                # the stall path: this frame would have been admitted at
                # the NORMAL threshold — the escalation is what shed it
                if self._degraded and predicted <= min(
                    self.policy.budget_ms(False), remain_ms
                ):
                    path = PATH_STALL
                else:
                    path = PATH_ADMISSION
            if path is None:
                tq.q.append((deadline, now, rec))
                self._backlog += 1
            else:
                crumb = self._note_shed(path)
        if path is None:
            self.telemetry.admitted(tenant)
            self._work.set()
            return True
        self.telemetry.shed(path, tenant, 1, at_door=True)
        if crumb:
            FLIGHT.record(
                "gateway_shed", path=path, tenant=tenant,
                predicted_ms=round(predicted, 2), shed_so_far=crumb,
            )
        _release(rec)
        return False

    def _note_shed(self, path: str) -> int:
        """Rate-limit breadcrumbs per path; returns the cumulative count
        to stamp on the breadcrumb, or 0 to stay quiet this time."""
        # guarded-by-caller: _lock
        n = self._shed_since_crumb.get(path, 0) + 1
        if n == 1 or n % _BREADCRUMB_EVERY == 0:
            self._shed_since_crumb[path] = n
            return n
        self._shed_since_crumb[path] = n
        return 0

    # -- dispatch (WDRR + dequeue deadline re-check) ----------------------
    def _pick_tenant(self) -> Optional[_TenantQ]:
        # guarded-by-caller: _lock
        backlogged = [t for t in self._tenants.values() if t.q]
        if not backlogged:
            return None
        for _replenished in (False, True):
            for _ in range(len(self._order)):
                name = self._order[0]
                self._order.rotate(-1)
                tq = self._tenants[name]
                if tq.q and tq.deficit >= 1.0:
                    return tq
            # nobody eligible: a new WDRR round — each backlogged tenant
            # earns quantum * weight frames of deficit (quantum = the
            # max operating point, so one round is a handful of batches)
            q = self.policy.max_batch
            for tq in backlogged:
                tq.deficit = min(
                    2.0 * q * tq.weight, max(0.0, tq.deficit) + q * tq.weight
                )
        return backlogged[0]  # unreachable: replenish made one eligible

    def dispatch_once(self, now: Optional[float] = None) -> int:
        """One WDRR dispatch: pick a tenant, re-check deadlines at
        dequeue (aged-out frames shed loudly), batch adaptively, drive
        the device, feed the measured service time back. Returns the
        number of frames HANDLED (dispatched + shed) — 0 means idle.
        Serialized: concurrent callers (a run() thread racing a
        drain()) queue behind ``_dispatch_serial``, so the dispatch
        callable is never re-entered."""
        # lock-order: ServingGateway._dispatch_serial -> ServingGateway._lock
        # (the serial gate is always the outer lock; _lock-holding paths
        # never wait on the gate)
        with self._dispatch_serial:
            return self._dispatch_once_locked(now)

    def _dispatch_once_locked(self, now: Optional[float]) -> int:
        # guarded-by-caller: _dispatch_serial
        now = self._clock() if now is None else now
        shed_recs: List[Any] = []
        with self._lock:
            tq = self._pick_tenant()
            if tq is None:
                return 0
            batch_size = self.policy.choose_batch(len(tq.q))
            svc_s = self.policy.service_ms(batch_size) / 1000.0
            batch: List[tuple] = []
            while tq.q and len(batch) < batch_size:
                deadline, admit_t, rec = tq.q.popleft()
                self._backlog -= 1
                if now + svc_s > deadline:
                    # aged out in the queue: it cannot complete in time —
                    # drop loudly, never process late
                    shed_recs.append(rec)
                    continue
                batch.append((deadline, admit_t, rec))
            tq.deficit -= len(batch)
            tenant = tq.name
            crumb = self._note_shed(PATH_DEADLINE) if shed_recs else 0
        if shed_recs:
            self.telemetry.shed(PATH_DEADLINE, tenant, len(shed_recs))
            if crumb:
                FLIGHT.record(
                    "gateway_shed", path=PATH_DEADLINE, tenant=tenant,
                    count=len(shed_recs), shed_so_far=crumb,
                )
            for rec in shed_recs:
                _release(rec)
        if not batch:
            return len(shed_recs)
        recs = [rec for (_d, _t, rec) in batch]
        # exemplar capture BEFORE dispatch consumes the leases: a
        # sampled record's trace id tags the latency observation so a
        # bad bucket resolves to that frame's cross-host timeline
        exemplars = [_trace_id(rec) for (_d, _t, rec) in batch]
        t0 = self._clock()
        self._dispatch(recs, batch_size)
        t1 = self._clock()
        self.policy.observe_service(batch_size, (t1 - t0) * 1000.0)
        self.telemetry.dispatched(batch_size, len(recs))
        for (deadline, admit_t, _rec), tid in zip(batch, exemplars):
            self.telemetry.completed(
                tenant, t1 - admit_t, in_slo=(t1 <= deadline), exemplar=tid
            )
        return len(recs) + len(shed_recs)

    def run(self, stop: Optional[threading.Event] = None,
            idle_wait_s: float = 0.02) -> None:
        """The standalone dispatch loop: serve until ``stop`` is set.
        Idle pauses are bounded Event waits woken by :meth:`offer` —
        no sleeps."""
        while not (stop is not None and stop.is_set()):
            if self.dispatch_once() == 0:
                self._work.wait(timeout=idle_wait_s)
                self._work.clear()

    def drain(self, deadline_s: float = 30.0) -> None:
        """Dispatch until the backlog empties (EOS / end-of-run tail)."""
        deadline = self._clock() + deadline_s
        while self.backlog() and self._clock() < deadline:
            self.dispatch_once()

    # -- transport pump ----------------------------------------------------
    def serve_queue(
        self,
        queue,
        tenant_of: Optional[Callable[[Any], str]] = None,
        stop: Optional[threading.Event] = None,
        poll_interval_s: float = 0.01,
        max_wait_s: Optional[float] = None,
        prefer_stream: bool = True,
    ) -> None:
        """Pump a transport queue through admission into the dispatch
        loop until EOS (the consumer drive path behind a gateway).

        Same drain preference and EOS-tally semantics as
        :func:`~psana_ray_tpu_torch.infeed.batcher.batches_from_queue`:
        server-push stream > zero-copy view drain > plain ``get_batch``,
        multiple producer shards covered by :class:`EosTally`, duplicate
        sibling markers returned to the queue. ``tenant_of(rec)`` names
        the tenant per frame (default: one shared tenant). At EOS the
        remaining admitted backlog is drained through the device, then
        this returns. ``max_wait_s`` bounds total starvation."""
        tally = EosTally()
        pop = (
            getattr(queue, "get_batch_stream", None) if prefer_stream else None
        ) or (getattr(queue, "get_batch_view", None) or queue.get_batch)
        starved_since: Optional[float] = None
        try:
            while True:
                if stop is not None and stop.is_set():
                    return
                timeout = 0.0 if self.backlog() else poll_interval_s
                try:
                    items = pop(self.policy.max_batch * 2, timeout=timeout)
                except TransportClosed:
                    break  # transport died: drain what we admitted
                if not items:
                    if tally.flush_duplicates(queue):
                        # yield before re-reading a returned sibling
                        # marker (the competing-consumer livelock,
                        # batches_from_queue) — bounded, offer()-woken
                        self._work.wait(timeout=max(poll_interval_s, 0.02))
                        self._work.clear()
                    now = self._clock()
                    starved_since = starved_since if starved_since is not None else now
                    if max_wait_s is not None and now - starved_since >= max_wait_s:
                        break
                    self.dispatch_once()
                    continue
                starved_since = None
                tally.flush_duplicates(queue)
                now = self._clock()
                stream_done = False
                for pos, item in enumerate(items):
                    if isinstance(item, EndOfStream):
                        if tally.process(item):
                            for rest in items[pos + 1:]:
                                if isinstance(rest, EndOfStream):
                                    tally.process(rest)
                                else:  # popped past the marker: still ours
                                    self.offer(
                                        rest,
                                        tenant=tenant_of(rest)
                                        if tenant_of is not None else "default",
                                        now=now,
                                    )
                            stream_done = True
                            break
                        continue
                    self.offer(
                        item,
                        tenant=tenant_of(item) if tenant_of is not None else "default",
                        now=now,
                    )
                # serve what admission let through before the next pop —
                # admission bounds the backlog to ~an SLO budget of work,
                # so this inner drain is bounded too
                while self.dispatch_once():
                    pass
                if stream_done:
                    FLIGHT.record("eos_complete", source="serving_gateway")
                    break
        finally:
            tally.flush_duplicates(queue, final=True)
        self.drain()


def make_batch_dispatch(
    consume: Callable[..., None],
    n_buffers: int = 0,
    new_arena: Optional[Callable[..., Any]] = None,
):
    """Adapt ``consume(batch)``, which eats fixed-shape
    :class:`~psana_ray_tpu_torch.infeed.batcher.Batch` objects (a model
    step that copies the batch to the card), into a gateway ``dispatch``
    callable.

    Keeps one :class:`FrameBatcher` a batch size (the adaptive sizes are a
    fixed menu, the operating points, not a continuum) and copies each
    record into the batch arena with ``push_view``: the record's transport
    lease is released right after its one copy. The tail is padded to the
    operating point with the validity mask. ``new_arena`` makes each
    batcher's arenas (pinned ones on the card,
    :func:`psana_ray_tpu_torch.infeed.pipeline.pinned_arena`); with
    ``n_buffers`` arenas pooled per batcher, ``consume`` sets
    ``batch.arena.fence`` behind its copy out of the arena, and the batcher
    waits on it before it writes that arena again. ``dispatch.batchers``
    maps each batch size to its batcher."""
    from psana_ray_tpu_torch.infeed.batcher import FrameBatcher, host_arena

    batchers: Dict[int, Any] = {}

    def dispatch(records: List[Any], batch_size: int) -> None:
        b = batchers.get(batch_size)
        if b is None:
            b = batchers[batch_size] = FrameBatcher(
                batch_size, n_buffers=n_buffers, new_arena=new_arena or host_arena)
        out = None
        for rec in records:
            out = b.push_view(rec)
            if out is not None:
                consume(out)
        if out is None:  # a partial dispatch: pad and emit now, never hold
            # admitted frames for a later dispatch's fill
            tail = b.flush()
            if tail is not None:
                consume(tail)

    dispatch.batchers = batchers
    return dispatch
