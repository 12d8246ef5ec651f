"""The per-process autotune daemon and the shared ``--autotune`` flags.

The port's copy of ``psana_ray_tpu/autotune/daemon.py``. One daemon
thread a controlled process ticks the
:class:`~psana_ray_tpu_torch.autotune.controller.HillClimber` at a bounded
interval. ``--autotune on`` actuates; ``--autotune observe`` runs the same
controller but logs its decisions without calling a setter (the audit
mode before trusting a new deployment); ``--autotune off`` (the default)
builds nothing: no thread, no cost.

The controller judges knobs by the measured history: where
``--history_interval 0`` left the process without a sampler,
:func:`configure_autotune_from_args` starts the default one.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

from psana_ray_tpu_torch.autotune.controller import (
    Guardrail,
    HillClimber,
    Objective,
    default_guardrails,
)
from psana_ray_tpu_torch.autotune.knobs import Knob, KnobRegistry

DEFAULT_INTERVAL_S = 2.0


class AutotuneDaemon:
    """Tick the controller on a daemon thread; an obs source wrapping
    the registry's knob table plus the controller's decision counters
    (registered as ``autotune``)."""

    def __init__(self, controller: HillClimber, interval_s: float = DEFAULT_INTERVAL_S):
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        self.controller = controller
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "AutotuneDaemon":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="autotune"
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.controller.tick()
            except Exception:  # noqa: BLE001 — tuning must outlive a bad knob
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "AutotuneDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- obs registry source ----------------------------------------------
    def snapshot(self) -> dict:
        out = self.controller.registry.snapshot()
        out.update(self.controller.snapshot())
        out["interval_s"] = self.interval_s
        return out


def add_autotune_args(parser) -> None:
    """The shared ``--autotune`` pair every long-running CLI exposes
    (one definition, like ``add_metrics_args``)."""
    parser.add_argument(
        "--autotune", choices=("off", "on", "observe"), default="off",
        help="close the loop on this process's pipeline knobs (stream/"
        "put windows, drain chunk/poll, prefetch depth, fsync batching, "
        "pool retention, wire codec): 'on' actuates a hill-climbing "
        "controller over the measured time-series history, reverting on "
        "regression or any guardrail trip; 'observe' runs the same "
        "controller but only LOGS what it would do; 'off' (default) "
        "builds nothing. A knob whose flag you set explicitly is "
        "excluded from control (your value is a decision)",
    )
    parser.add_argument(
        "--autotune_interval", type=float, default=DEFAULT_INTERVAL_S,
        help="controller tick interval in seconds (each tick takes one "
        "measurement; probes hold several ticks before judging)",
    )


def configure_autotune_from_args(
    args,
    knobs: Sequence[Optional[Knob]],
    objective: Objective,
    guardrails: Optional[Sequence[Guardrail]] = None,
    gateway=None,
    pinned: Optional[dict] = None,
) -> Optional[AutotuneDaemon]:
    """CLI entry: build registry + controller + daemon from the
    ``add_autotune_args`` flags. ``knobs`` may contain None entries
    (declined factories). ``pinned`` maps knob name -> reason for
    manually-set flags. ``gateway`` non-None defers the ``serving``
    knob group to its SloPolicy (single-writer rule). Returns the
    STARTED daemon, or None when ``--autotune off``."""
    mode = getattr(args, "autotune", "off") or "off"
    if mode == "off":
        return None
    registry = KnobRegistry(mode="observe" if mode == "observe" else "on")
    pinned = pinned or {}
    for knob in knobs:
        if knob is None:
            continue
        registry.register(knob, pinned_reason=pinned.get(knob.name))
    if gateway is not None:
        registry.note_gateway(gateway)
    # the controller reads the process history store; make sure one runs
    from psana_ray_tpu_torch.obs.timeseries import default_history, start_default_history

    if default_history() is None:
        start_default_history()
    controller = HillClimber(
        registry,
        objective,
        guardrails=default_guardrails() if guardrails is None else list(guardrails),
    )
    daemon = AutotuneDaemon(
        controller,
        interval_s=max(0.1, float(getattr(args, "autotune_interval", DEFAULT_INTERVAL_S))),
    )
    try:
        from psana_ray_tpu_torch.obs import MetricsRegistry

        MetricsRegistry.default().register("autotune", daemon)
    except Exception:  # obs optional: tuning must work without it
        pass
    return daemon.start()
