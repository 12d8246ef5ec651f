"""The controller: a gradient-free hill climber over the knob registry.

The port's copy of ``psana_ray_tpu/autotune/controller.py``, kept simple
on purpose:

- it reads only :class:`~psana_ray_tpu_torch.obs.timeseries.TimeSeriesStore`
  views (rate, EWMA, percentile over the bounded history rings); it never
  measures anything itself;
- it probes one knob at a time: a baseline over N ticks, one quantum step,
  a hold of N x cost ticks, then keep on improvement or revert on
  regression;
- hysteresis a knob group: a reverted group sits out a cooldown, so a
  noisy metric cannot make the controller oscillate a dial;
- guardrails come first: a shed-rate spike, the stall detector's degraded
  gauge or an SLO-burn alert reverts an open probe at once and freezes
  probing until the trip clears.

Everything is tick-driven and reads no clock of its own (``tick()``
consumes what the store holds), so tests drive a whole convergence by
feeding timed samples. Every decision leaves a flight breadcrumb, through
the registry (``autotune_actuate``, ``autotune_revert``,
``autotune_observe``) or here (``autotune_keep``, ``autotune_guardrail``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from psana_ray_tpu_torch.autotune.knobs import KnobRegistry
from psana_ray_tpu_torch.obs.flight import FLIGHT
from psana_ray_tpu_torch.obs.timeseries import TimeSeriesStore, default_history


@dataclasses.dataclass
class Objective:
    """What "better" means: the windowed rate of one counter key (fps),
    optionally penalized by a percentile of a latency-ish gauge key.

    ``score = rate(fps_key) - penalty_weight * percentile(penalty_key, q)``

    Returns None while the store lacks enough samples — the controller
    extends its measurement window instead of deciding on nothing."""

    fps_key: str
    window_s: float = 15.0
    penalty_key: Optional[str] = None
    penalty_weight: float = 0.0
    penalty_q: float = 0.99

    def score(self, store: TimeSeriesStore) -> Optional[float]:
        fps = store.rate(self.fps_key, self.window_s)
        if fps is None:
            return None
        out = fps
        if self.penalty_key and self.penalty_weight:
            p = store.percentile(self.penalty_key, self.penalty_q, self.window_s)
            if p is not None:
                out -= self.penalty_weight * p
        return out


@dataclasses.dataclass
class Guardrail:
    """A hard stop read from the same store: ``gauge_above`` trips when
    the latest sample of ``key`` exceeds ``threshold``; ``rate_above``
    trips on the windowed rate of a counter key (e.g. sheds/s). A key
    absent from this process's store never trips — the same guardrail
    list is safe on every CLI."""

    key: str
    mode: str  # "gauge_above" | "rate_above"
    threshold: float
    window_s: float = 10.0

    def tripped(self, store: TimeSeriesStore) -> bool:
        if self.mode == "gauge_above":
            v = store.last(self.key)
            return v is not None and v > self.threshold
        if self.mode == "rate_above":
            r = store.rate(self.key, self.window_s)
            return r is not None and r > self.threshold
        raise ValueError(f"unknown guardrail mode {self.mode!r}")


def default_guardrails() -> List[Guardrail]:
    """The guardrail set every CLI arms: the stall detector's degraded
    gauge, the gateway shed rate, and the collector's SLO-burn alert
    gauge — each a no-op in processes that don't export the key."""
    return [
        Guardrail("stalls.degraded", "gauge_above", 0.5),
        Guardrail("gateway.shed_total", "rate_above", 1.0),
        Guardrail("collector.alerts_active", "gauge_above", 0.5),
    ]


class _ProbeState:
    __slots__ = ("name", "saved", "applied", "scores", "hold")

    def __init__(self, name: str, saved: float, applied: float, hold: int):
        self.name = name
        self.saved = saved  # value to restore on revert
        self.applied = applied
        self.scores: List[float] = []
        self.hold = hold


class HillClimber:
    """One knob at a time: baseline -> step -> hold -> keep-or-revert.

    ``tick()`` is the only entry point; call it once per metrics sample
    (the daemon does, at its interval). It never sleeps and never reads
    the clock — the store's samples carry time. Returns a decision dict
    when a probe resolves (tests and the observe log read it), else
    None.
    """

    def __init__(
        self,
        registry: KnobRegistry,
        objective: Objective,
        store: Optional[TimeSeriesStore] = None,
        guardrails: Sequence[Guardrail] = (),
        hold_ticks: int = 3,
        settle_ticks: int = 2,
        min_rel_gain: float = 0.02,
        cooldown_ticks: int = 8,
        max_starved_ticks: int = 10,
    ):
        if hold_ticks < 1:
            raise ValueError("hold_ticks must be >= 1")
        self.registry = registry
        self.objective = objective
        self._store = store
        self.guardrails = list(guardrails)
        self.hold_ticks = int(hold_ticks)
        # scores are WINDOWED views: the first readings after any
        # actuation still average over pre-change samples, so they are
        # discarded (judging a probe on smeared data biases every
        # comparison toward "no change" — measured in test_autotune's
        # synthetic-surface convergence)
        self.settle_ticks = max(0, int(settle_ticks))
        self.min_rel_gain = float(min_rel_gain)
        self.cooldown_ticks = int(cooldown_ticks)
        self.max_starved_ticks = int(max_starved_ticks)
        # single-threaded state: only the daemon thread (or a test)
        # calls tick(); the registry serializes the shared surfaces
        self._tick = 0
        self._rotation = 0  # index into registry.eligible()
        self._direction: Dict[str, int] = {}  # knob -> +1/-1
        self._cooldown: Dict[str, int] = {}  # group -> tick it re-arms at
        self._baseline_scores: List[float] = []
        self._baseline: Optional[float] = None
        self._probe: Optional[_ProbeState] = None
        self._skip = 0  # settle countdown after an actuation
        self._starved = 0
        self._guard_frozen = False
        self.decisions = 0
        self.guardrail_trips = 0

    # -- helpers -----------------------------------------------------------
    def _resolve_store(self) -> Optional[TimeSeriesStore]:
        return self._store if self._store is not None else default_history()

    def _guard_tripped(self, store: TimeSeriesStore) -> Optional[Guardrail]:
        for g in self.guardrails:
            try:
                if g.tripped(store):
                    return g
            except Exception:  # a bad key must not kill the loop
                continue
        return None

    def _next_knob(self) -> Optional[str]:
        names = self.registry.eligible()
        if not names:
            return None
        for i in range(len(names)):
            name = names[(self._rotation + i) % len(names)]
            group = self.registry.knob(name).group
            if self._cooldown.get(group, 0) <= self._tick:
                self._rotation = (self._rotation + i + 1) % len(names)
                return name
        return None

    def _abort_probe(self, why: str) -> dict:
        probe, self._probe = self._probe, None
        try:
            self.registry.apply(probe.name, probe.saved, why="revert")
        except Exception:  # noqa: BLE001 — a dead target must not wedge the loop
            pass  # the knob keeps its probed value; cooldown still applies
        group = self.registry.knob(probe.name).group
        self._cooldown[group] = self._tick + self.cooldown_ticks
        self._direction[probe.name] = -self._direction.get(probe.name, 1)
        self._baseline = None
        self._baseline_scores = []
        self._skip = self.settle_ticks  # the revert is an actuation too
        self.decisions += 1
        return {
            "decision": "revert", "knob": probe.name, "why": why,
            "restored": probe.saved,
        }

    # -- the loop body -----------------------------------------------------
    def tick(self) -> Optional[dict]:
        self._tick += 1
        store = self._resolve_store()
        if store is None:
            return None

        guard = self._guard_tripped(store)
        if guard is not None:
            self.guardrail_trips += 1
            out = None
            if self._probe is not None:
                out = self._abort_probe(f"guardrail:{guard.key}")
            if not self._guard_frozen:
                # breadcrumb once per episode, not once per tick
                FLIGHT.record(
                    "autotune_guardrail", key=guard.key, mode=guard.mode,
                    threshold=guard.threshold,
                    reverted=out["knob"] if out else None,
                )
            self._guard_frozen = True
            # a trip invalidates the baseline: whatever we measured was
            # pre-incident
            self._baseline = None
            self._baseline_scores = []
            return out
        self._guard_frozen = False

        score = self.objective.score(store)
        if score is None:
            self._starved += 1
            if self._probe is not None and self._starved >= self.max_starved_ticks:
                return self._abort_probe("metrics-starved")
            return None
        self._starved = 0
        if self._skip > 0:
            # settle: this score's window still averages over
            # pre-actuation samples — discard it
            self._skip -= 1
            return None

        if self._probe is not None:
            probe = self._probe
            probe.scores.append(score)
            if len(probe.scores) < probe.hold:
                return None
            probe_score = sum(probe.scores) / len(probe.scores)
            baseline = self._baseline if self._baseline is not None else 0.0
            # additive-relative margin: sign-safe (a multiplicative
            # margin inverts for negative baselines — a penalized
            # objective can go negative under load); the epsilon keeps
            # a flat zero surface from "improving" on every step
            gain = probe_score - baseline
            if gain >= max(self.min_rel_gain * abs(baseline), 1e-9):
                # improvement held: keep, continue the same direction,
                # and the probe window seeds the next baseline
                self._probe = None
                self.registry.note_kept(probe.name)
                FLIGHT.record(
                    "autotune_keep", knob=probe.name, value=probe.applied,
                    baseline=round(baseline, 3), score=round(probe_score, 3),
                )
                self._baseline = probe_score
                self._baseline_scores = []
                self.decisions += 1
                return {
                    "decision": "keep", "knob": probe.name,
                    "value": probe.applied, "baseline": baseline,
                    "score": probe_score,
                }
            return self._abort_probe("regression")

        # no probe open: accumulate baseline, then open one
        self._baseline_scores.append(score)
        if len(self._baseline_scores) < self.hold_ticks:
            return None
        self._baseline = sum(self._baseline_scores) / len(self._baseline_scores)
        self._baseline_scores = []
        name = self._next_knob()
        if name is None:
            return None
        knob = self.registry.knob(name)
        cur = float(knob.get())
        direction = self._direction.setdefault(name, 1)
        target = knob.neighbor(cur, direction)
        if target == cur:
            # at a bound: flip and try the other way once
            self._direction[name] = direction = -direction
            target = knob.neighbor(cur, direction)
            if target == cur:
                return None  # degenerate single-value knob
        if self.registry.mode == "observe":
            # log the decision, actuate nothing, move on — the probe
            # cycle is meaningless when the dial never moved
            self.registry.apply(name, target, why="probe")
            self.decisions += 1
            return {"decision": "observe", "knob": name, "would_set": target}
        try:
            applied = self.registry.apply(name, target, why="probe")
        except Exception:  # noqa: BLE001 — an unactuatable knob sits out a round
            self._cooldown[knob.group] = self._tick + self.cooldown_ticks
            return None
        self._probe = _ProbeState(
            name, cur, applied, self.hold_ticks * knob.cost
        )
        self._skip = self.settle_ticks
        return None

    # -- obs ---------------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "ticks_total": self._tick,
            "decisions_total": self.decisions,
            "guardrail_trips_total": self.guardrail_trips,
            "probe_open": 1 if self._probe is not None else 0,
            "guard_frozen": 1 if self._guard_frozen else 0,
        }
