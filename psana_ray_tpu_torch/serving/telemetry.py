"""Gateway accounting (registry source ``gateway``): SLO attainment a tenant.

The port's copy of ``psana_ray_tpu/serving/telemetry.py``. One counter
family for every shed path: ``admission`` (predicted sojourn over budget
at the front door), ``deadline`` (aged out in the gateway's queue, caught
at dequeue), ``stall`` (it would have fit the normal budget, but the stall
detector's escalation shrank it). So "how much was shed, and why" is one
query, and at every instant

    offered == completed + shed(admission) + shed(deadline)
             + shed(stall) + backlog

and after a drain ``offered == completed + shed_total``: a shed is loud
and counted, an admitted frame is never lost.

A tenant's row: offered, admitted, shed and completed counts, goodput
(completed within the SLO) and a latency reservoir whose p99 is the number
the SLO is written against; ``slo_attainment`` is goodput / completed.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from psana_ray_tpu_torch.utils.metrics import LatencyStats

PATH_ADMISSION = "admission"
PATH_DEADLINE = "deadline"
PATH_STALL = "stall"
SHED_PATHS = (PATH_ADMISSION, PATH_DEADLINE, PATH_STALL)


class _TenantStats:
    __slots__ = ("offered", "admitted", "shed", "completed", "goodput", "lat")

    def __init__(self):
        self.offered = 0
        self.admitted = 0
        self.shed = 0
        self.completed = 0
        self.goodput = 0
        self.lat = LatencyStats(reservoir_size=2048)


class GatewayTelemetry:
    """Counters + gauges for one :class:`~psana_ray_tpu_torch.serving.gateway.
    ServingGateway`. Registered in the default MetricsRegistry on
    ``attach`` (last registration under a name wins, so a restarted
    gateway takes over its series)."""

    def __init__(self, name: str = "gateway", register: bool = True):
        self._name = name
        self._register = register
        self._lock = threading.Lock()
        self._registered = False  # guarded-by: _lock
        self.offered_total = 0  # guarded-by: _lock
        self.admitted_total = 0  # guarded-by: _lock
        self.shed_total = 0  # guarded-by: _lock
        self._shed_by_path: Dict[str, int] = {
            p: 0 for p in SHED_PATHS
        }  # guarded-by: _lock
        self.completed_total = 0  # guarded-by: _lock
        self.goodput_total = 0  # guarded-by: _lock
        self.dispatched_batches = 0  # guarded-by: _lock
        self.dispatched_frames = 0  # guarded-by: _lock
        self.batch_last = 0  # guarded-by: _lock
        self.escalations = 0  # guarded-by: _lock
        self.restores = 0  # guarded-by: _lock
        self._tenants: Dict[str, _TenantStats] = {}  # guarded-by: _lock
        # the gateway, for the degraded/backlog gauges
        self._gw = None  # guarded-by: _lock

    def attach(self, gateway) -> None:
        with self._lock:
            self._gw = gateway
        if not self._register:
            return
        with self._lock:
            if self._registered:
                return
            self._registered = True
        try:
            from psana_ray_tpu_torch.obs import MetricsRegistry

            MetricsRegistry.default().register(self._name, self)
        except Exception:  # obs optional: serving must work without it
            pass

    def _tenant(self, tenant: str) -> _TenantStats:
        # guarded-by-caller: _lock
        ts = self._tenants.get(tenant)
        if ts is None:
            ts = self._tenants[tenant] = _TenantStats()
        return ts

    # -- the counter family ------------------------------------------------
    def admitted(self, tenant: str, n: int = 1) -> None:
        with self._lock:
            self.offered_total += n
            self.admitted_total += n
            ts = self._tenant(tenant)
            ts.offered += n
            ts.admitted += n

    def shed(self, path: str, tenant: str, n: int = 1,
             at_door: bool = False) -> None:
        """One shed event on ``path`` (admission/deadline/stall).
        ``at_door=True`` (admission-time paths) also counts the frames
        as offered — dequeue-path sheds were already offered+admitted
        when they came through the door."""
        if path not in SHED_PATHS:
            raise ValueError(f"unknown shed path {path!r} (want {SHED_PATHS})")
        with self._lock:
            self.shed_total += n
            self._shed_by_path[path] += n
            ts = self._tenant(tenant)
            ts.shed += n
            if at_door:
                self.offered_total += n
                ts.offered += n

    def completed(
        self,
        tenant: str,
        latency_s: float,
        in_slo: bool,
        exemplar: Optional[int] = None,
    ) -> None:
        """``exemplar`` (a sampled frame's trace id) is kept a latency
        bucket by the tenant's reservoir: the link from a bad p99 bucket
        to that frame's timeline across hosts."""
        with self._lock:
            self.completed_total += 1
            ts = self._tenant(tenant)
            ts.completed += 1
            if in_slo:
                self.goodput_total += 1
                ts.goodput += 1
        ts.lat.observe(latency_s, exemplar=exemplar)  # internally locked

    def dispatched(self, batch: int, n_frames: int) -> None:
        with self._lock:
            self.dispatched_batches += 1
            self.dispatched_frames += n_frames
            self.batch_last = batch

    def escalated(self) -> None:
        with self._lock:
            self.escalations += 1

    def restored(self) -> None:
        with self._lock:
            self.restores += 1

    # -- reads -------------------------------------------------------------
    def shed_by_path(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._shed_by_path)

    def tenant_goodput(self) -> Dict[str, int]:
        with self._lock:
            return {t: ts.goodput for t, ts in self._tenants.items()}

    def stats(self) -> dict:
        with self._lock:
            gw = self._gw
            out = {
                "offered_total": self.offered_total,
                "admitted_total": self.admitted_total,
                "shed_total": self.shed_total,
                "completed_total": self.completed_total,
                "goodput_total": self.goodput_total,
                "dispatched_batches": self.dispatched_batches,
                "dispatched_frames": self.dispatched_frames,
                "batch_last": self.batch_last,
                "escalations": self.escalations,
                "restores": self.restores,
                "slo_attainment": round(
                    self.goodput_total / self.completed_total, 4
                ) if self.completed_total else 1.0,
            }
            for p, n in self._shed_by_path.items():
                out[f"shed_{p}_total"] = n
            tenants = list(self._tenants.items())
        rates: Dict[str, float] = {}
        if gw is not None:
            out["degraded"] = 1 if gw.degraded else 0
            out["backlog"] = gw.backlog()
            try:
                # the offered rate a tenant: what the admission
                # predictor reads, exported so the history ring records
                # demand beside goodput
                rates = gw.offered_fps_by_tenant()
            except Exception:  # noqa: BLE001 — a mid-teardown gateway
                rates = {}
        for t, ts in tenants:
            lat = ts.lat.snapshot()
            out[t] = {
                "offered": ts.offered,
                "offered_fps": rates.get(t, 0.0),
                "admitted": ts.admitted,
                "shed": ts.shed,
                "completed": ts.completed,
                "goodput": ts.goodput,
                "slo_attainment": round(
                    ts.goodput / ts.completed, 4
                ) if ts.completed else 1.0,
                "p99_ms": lat.get("p99_ms", 0.0),
            }
            ex = ts.lat.exemplars()
            if ex:
                out[t]["exemplars"] = ex
        return out

    # obs registry source protocol
    def snapshot(self) -> dict:
        return self.stats()
