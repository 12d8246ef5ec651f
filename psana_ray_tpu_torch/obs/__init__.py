"""Observability: metrics export, stage timing, stall detection, per-frame
tracing and the flight recorder.

The port's copy of ``psana_ray_tpu/obs/``:

- :mod:`.registry` and :mod:`.exporter`: :class:`MetricsRegistry`
  aggregates the process's metrics objects and :class:`MetricsServer`
  serves them as Prometheus text (``--metrics_port`` on every program);
- :mod:`.stages`: the stage names; the record's hop stamps decompose
  end-to-end latency into per-stage histograms;
- :mod:`.stall`: :class:`StallDetector` turns queue counters into
  backpressure, consumer-stall and producer-idle events;
- :mod:`.tracing` and :mod:`.trace_merge`: sampled per-frame traces across
  producer, queue server and consumer, merged into one Perfetto timeline
  by ``python -m psana_ray_tpu_torch.obs.trace_merge``;
- :mod:`.flight`: the bounded event ring dumped on a stall, an exception
  or SIGUSR2;
- :mod:`.timeseries`: the process's bounded history of registry
  snapshots, whose tail every flight dump carries;
- :mod:`.profiling` and :mod:`.prof_merge`: the continuous profiler (each
  process's CPU by stage, its hot frames, its CPU a frame) and the merge
  of its spools, ``python -m psana_ray_tpu_torch.obs.prof_merge``;
- :mod:`.collector`, :mod:`.console` and :mod:`.top`: the federation
  collector and the console over it, ``python -m
  psana_ray_tpu_torch.obs.top``.

Names, defaults, spool lines, dump documents, Prometheus text and the
federation payload are the JAX package's; a serving gateway
(:mod:`psana_ray_tpu_torch.serving`) and the autotune daemon
(:mod:`psana_ray_tpu_torch.autotune`) register their ``gateway`` and
``autotune`` sources here. Everything here is pure stdlib and loads
lazily.
"""

import importlib

_EXPORTS = {
    "MetricsServer": "exporter",
    "add_metrics_args": "exporter",
    "start_metrics_server": "exporter",
    "MetricsRegistry": "registry",
    "snapshot_source": "registry",
    "federation_payload": "registry",
    "STAGE_BATCH": "stages",
    "STAGE_DEQUEUE": "stages",
    "STAGE_DEVICE_PUT": "stages",
    "STAGE_DISPATCH": "stages",
    "STAGE_E2E": "stages",
    "STAGE_ENQUEUE": "stages",
    "STAGE_QUEUE_DWELL": "stages",
    "STAGES": "stages",
    "observe_batch_stages": "stages",
    "observe_record_stages": "stages",
    "EVENT_BACKPRESSURE": "stall",
    "EVENT_CONSUMER_STALL": "stall",
    "EVENT_PRODUCER_IDLE": "stall",
    "StallDetector": "stall",
    "StallEvent": "stall",
    "FLIGHT": "flight",
    "FlightRecorder": "flight",
    "HistorySampler": "timeseries",
    "SeriesRing": "timeseries",
    "TimeSeriesStore": "timeseries",
    "add_history_args": "timeseries",
    "configure_history_from_args": "timeseries",
    "default_history": "timeseries",
    "TRACER": "tracing",
    "TraceContext": "tracing",
    "Tracer": "tracing",
    "add_trace_args": "tracing",
    "emit_batch_spans": "tracing",
    "exchange_anchors": "tracing",
    "obs_status_suffix": "tracing",
    "ClusterCollector": "collector",
    "FlameSampler": "profiling",
    "ProfTelemetry": "profiling",
    "StackTrie": "profiling",
    "add_profile_args": "profiling",
    "configure_profiling_from_args": "profiling",
    "default_profiler": "profiling",
    "profile_summary": "profiling",
    "profile_top": "profiling",
    "start_default_profiler": "profiling",
    "stop_default_profiler": "profiling",
}

__all__ = sorted([*_EXPORTS, "StageTimes", "configure_tracing_from_args"])


def __getattr__(name):
    if name == "StageTimes":
        from psana_ray_tpu_torch.utils.metrics import StageTimes

        return StageTimes
    if name == "configure_tracing_from_args":
        from psana_ray_tpu_torch.obs.tracing import configure_from_args

        return configure_from_args
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
