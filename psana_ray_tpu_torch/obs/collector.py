"""Federation: every process's metrics pulled into one store a peer.

The port's copy of ``psana_ray_tpu/obs/collector.py``. A
:class:`ClusterCollector` polls a fixed list of peers over the surfaces
they already serve:

- ``host:port`` / ``tcp://host:port``: a queue server (of either package)
  answers the 'N' RPC ``{"op": "metrics"}`` with its federation payload
  (:func:`psana_ray_tpu_torch.obs.registry.federation_payload`); a server
  that answers the op with ``{"ok": false}`` is marked **degraded**,
  loudly;
- ``http://host:port``: a CLI's ``--metrics_port`` endpoint, ``GET
  /federate``, or ``/healthz`` (degraded) where that route is missing.

Each pull lands in the peer's :class:`~psana_ray_tpu_torch.obs.timeseries.
TimeSeriesStore`, which ``python -m psana_ray_tpu_torch.obs.top`` renders.
After every sweep the collector evaluates its alerts over each store: the
gateway's error-budget burn, replication lag, a stall. An alert is a
flight-recorder event at each edge and an active-alert gauge of the
``collector`` registry source while it lasts. Pure stdlib.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

from psana_ray_tpu_torch.obs.flight import FLIGHT
from psana_ray_tpu_torch.obs.timeseries import DEFAULT_CAPACITY, TimeSeriesStore

__all__ = ["ClusterCollector", "PeerState", "parse_peer"]

PEER_UP = "up"
PEER_DEGRADED = "degraded"  # reachable, but answers no federation payload
PEER_DOWN = "down"

ALERT_SLO_BURN = "slo_burn"
ALERT_REPLICATION_LAG = "replication_lag"
ALERT_STALL = "stall"

# error-budget burn over the short window: (1 - attainment) / (1 - target);
# 1.0 spends the budget exactly, the default threshold twice as fast
DEFAULT_SLO_TARGET = 0.99
DEFAULT_BURN_THRESHOLD = 2.0
DEFAULT_BURN_WINDOW_S = 60.0
DEFAULT_REPL_LAG_RECORDS = 1000


def parse_peer(spec: str) -> Tuple[str, str]:
    """``spec`` -> (kind, address): ``tcp`` for ``host:port`` and
    ``tcp://host:port`` (a queue server), ``http`` for ``http://host:port``
    (a CLI's metrics endpoint)."""
    spec = spec.strip()
    if not spec:
        raise ValueError("empty peer spec")
    if spec.startswith("http://") or spec.startswith("https://"):
        return "http", spec.rstrip("/")
    if spec.startswith("tcp://"):
        spec = spec[len("tcp://"):]
    host, sep, port = spec.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"peer spec {spec!r} is not host:port / tcp://host:port / "
                         f"http://host:port")
    return "tcp", f"{host}:{port}"


class _Peer:
    """One peer: its pull, its store and its state."""

    def __init__(self, spec: str, capacity: int):
        self.kind, self.address = parse_peer(spec)
        self.label = self.address if self.kind == "tcp" else spec.rstrip("/")
        self.store = TimeSeriesStore(capacity)
        self.state = PEER_DOWN  # until the first pull
        self.host = ""
        self.pid = 0
        self.worker = None  # a --workers fleet's worker id
        self.profile = None  # the last profile summary
        self.last_pull_wall = 0.0
        self.last_error = ""
        self.pulls_ok = 0
        self.pulls_failed = 0
        self._client = None  # the kept TCP connection

    def _pull_tcp(self, timeout_s: float) -> dict:
        from psana_ray_tpu_torch.transport.tcp import TcpQueueClient

        if self._client is None:
            host, _, port = self.address.rpartition(":")
            # no reconnect envelope: a dead peer is down within one sweep
            self._client = TcpQueueClient(host, int(port), timeout_s=timeout_s,
                                          reconnect_tries=0)
        return self._client.cluster_rpc({"op": "metrics"})

    def _pull_http(self, timeout_s: float) -> dict:
        try:
            with urllib.request.urlopen(f"{self.address}/federate", timeout=timeout_s) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise
        # no /federate route: its /healthz snapshot, tagged only by address
        with urllib.request.urlopen(f"{self.address}/healthz", timeout=timeout_s) as resp:
            return {"ok": True, "_healthz_fallback": True,
                    "metrics": json.loads(resp.read().decode())}

    def drop_client(self) -> None:
        client, self._client = self._client, None
        if client is not None:
            try:
                client.disconnect()
            except Exception:  # noqa: BLE001 (failing already)
                pass

    def pull(self, timeout_s: float) -> dict:
        if self.kind == "tcp":
            return self._pull_tcp(timeout_s)
        return self._pull_http(timeout_s)


class PeerState:
    """One peer as the console renders it."""

    __slots__ = ("label", "kind", "state", "host", "pid", "worker", "age_s", "error", "profile")

    def __init__(self, peer: _Peer, now: float):
        self.label = peer.label
        self.kind = peer.kind
        self.state = peer.state
        self.host = peer.host
        self.pid = peer.pid
        self.worker = peer.worker
        self.profile = peer.profile
        self.age_s = (now - peer.last_pull_wall) if peer.last_pull_wall else -1.0
        self.error = peer.last_error


class ClusterCollector:
    """Poll the peers, keep their host-tagged series, raise the alerts.
    :meth:`poll_once` is one sweep, which tests and ``obs.top --once``
    drive themselves; :meth:`start` runs sweeps on a thread."""

    def __init__(
        self,
        peers: List[str],
        interval_s: float = 2.0,
        capacity: int = DEFAULT_CAPACITY,
        pull_timeout_s: float = 5.0,
        slo_target: float = DEFAULT_SLO_TARGET,
        burn_threshold: float = DEFAULT_BURN_THRESHOLD,
        burn_window_s: float = DEFAULT_BURN_WINDOW_S,
        repl_lag_records: int = DEFAULT_REPL_LAG_RECORDS,
        register: bool = True,
    ):
        if not peers:
            raise ValueError("collector needs at least one peer")
        self.interval_s = float(interval_s)
        self.pull_timeout_s = float(pull_timeout_s)
        self.slo_target = float(slo_target)
        self.burn_threshold = float(burn_threshold)
        self.burn_window_s = float(burn_window_s)
        self.repl_lag_records = int(repl_lag_records)
        self._lock = threading.Lock()
        self._peers: Dict[str, _Peer] = {}  # guarded-by: _lock
        for spec in peers:
            p = _Peer(spec, capacity)
            self._peers[p.label] = p
        self._sweeps = 0  # guarded-by: _lock
        self._alerts_fired = 0  # guarded-by: _lock
        self._active_alerts: Dict[Tuple[str, str], float] = {}  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if register:
            from psana_ray_tpu_torch.obs.registry import MetricsRegistry

            MetricsRegistry.default().register("collector", self)

    # -- one sweep ----------------------------------------------------------
    def poll_once(self, now: Optional[float] = None) -> Dict[str, str]:
        """Pull every peer once; ``{peer label: state}``. A peer that turns
        down or degraded leaves a flight-recorder event: one dead peer
        must not blind the pane."""
        now = time.time() if now is None else now
        with self._lock:
            peers = list(self._peers.values())
        states: Dict[str, str] = {}
        for peer in peers:
            prev = peer.state
            try:
                payload = peer.pull(self.pull_timeout_s)
            except Exception as e:  # noqa: BLE001 (a dead peer is data)
                peer.drop_client()
                peer.state = PEER_DOWN
                peer.last_error = repr(e)
                peer.pulls_failed += 1
            else:
                if payload.get("ok"):
                    metrics = payload.get("metrics")
                    peer.store.record(metrics if isinstance(metrics, dict) else {}, now=now)
                    peer.host = payload.get("host", peer.host) or peer.host
                    peer.pid = int(payload.get("pid", peer.pid) or 0)
                    # a kept connection answers from one worker: a stable tag
                    w = payload.get("worker")
                    peer.worker = int(w) if w is not None else None
                    prof = payload.get("profile")
                    peer.profile = prof if isinstance(prof, dict) else None
                    peer.last_pull_wall = now
                    peer.last_error = ""
                    peer.pulls_ok += 1
                    peer.state = PEER_DEGRADED if payload.get("_healthz_fallback") else PEER_UP
                else:
                    # 'N' answered, but not the metrics op
                    peer.state = PEER_DEGRADED
                    peer.last_error = str(payload.get("error", "refused"))
                    peer.pulls_failed += 1
            if peer.state != prev and peer.state != PEER_UP:
                FLIGHT.record("collector_peer_" + peer.state, peer=peer.label,
                              error=peer.last_error)
            states[peer.label] = peer.state
        with self._lock:
            self._sweeps += 1
        self._evaluate_alerts(now, peers)
        return states

    # -- alerts ---------------------------------------------------------------
    def _burn_rate(self, store: TimeSeriesStore) -> Optional[float]:
        """The error-budget burn over the window from the gateway's goodput
        and completed counters (None without a gateway)."""
        good = store.delta("gateway.goodput_total", self.burn_window_s)
        done = store.delta("gateway.completed_total", self.burn_window_s)
        if good is None or done is None or done <= 0:
            return None
        attainment = good / done
        budget = max(1e-6, 1.0 - self.slo_target)
        return (1.0 - attainment) / budget

    def _evaluate_alerts(self, now: float, peers: List[_Peer]) -> None:
        for peer in peers:
            store = peer.store
            burn = self._burn_rate(store)
            self._set_alert(peer.label, ALERT_SLO_BURN,
                            burn is not None and burn >= self.burn_threshold, now,
                            value=round(burn, 2) if burn is not None else None)
            lag = store.last("replication.lag_records")
            self._set_alert(peer.label, ALERT_REPLICATION_LAG,
                            lag is not None and lag >= self.repl_lag_records, now, value=lag)
            stalled = store.last("stalls.degraded")
            self._set_alert(peer.label, ALERT_STALL, bool(stalled), now, value=stalled)

    def _set_alert(self, peer: str, kind: str, firing: bool, now: float, value=None) -> None:
        key = (peer, kind)
        with self._lock:
            active = key in self._active_alerts
            if firing and not active:
                self._active_alerts[key] = now
                self._alerts_fired += 1
            elif not firing and active:
                del self._active_alerts[key]
            else:
                return
        if firing:  # one event an episode, as the stall detector
            FLIGHT.record("slo_alert", alert=kind, peer=peer, value=value)
        else:
            FLIGHT.record("slo_alert_cleared", alert=kind, peer=peer)

    # -- reads ------------------------------------------------------------------
    def peers(self) -> List[PeerState]:
        now = time.time()
        with self._lock:
            return [PeerState(p, now) for p in self._peers.values()]

    def store(self, label: str) -> Optional[TimeSeriesStore]:
        with self._lock:
            p = self._peers.get(label)
            return p.store if p is not None else None

    def stores(self) -> Dict[str, TimeSeriesStore]:
        with self._lock:
            return {label: p.store for label, p in self._peers.items()}

    def active_alerts(self) -> List[dict]:
        now = time.time()
        with self._lock:
            return [{"peer": peer, "alert": kind, "for_s": round(now - since, 1)}
                    for (peer, kind), since in sorted(self._active_alerts.items())]

    # -- the thread ---------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 (the pane outlives a bad sweep)
                pass

    def start(self) -> "ClusterCollector":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="cluster-collector")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        with self._lock:
            peers = list(self._peers.values())
        for p in peers:
            p.drop_client()

    def __enter__(self) -> "ClusterCollector":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- registry source -------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            peers = list(self._peers.values())
            sweeps = self._sweeps
            fired = self._alerts_fired
            active = len(self._active_alerts)
        return {
            "peers": len(peers),
            "peers_up": sum(1 for p in peers if p.state == PEER_UP),
            "peers_degraded": sum(1 for p in peers if p.state == PEER_DEGRADED),
            "peers_down": sum(1 for p in peers if p.state == PEER_DOWN),
            "sweeps_total": sweeps,
            "alerts_fired_total": fired,
            "alerts_active": active,
            "pulls_ok_total": sum(p.pulls_ok for p in peers),
            "pulls_failed_total": sum(p.pulls_failed for p in peers),
        }
