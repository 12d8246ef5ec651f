"""The continuous profiler: where each process's CPU goes, by stage.

The port's copy of ``psana_ray_tpu/obs/profiling/``:

- :mod:`.sampler`: the 97 Hz flame sampler folding every thread's stack
  into a bounded trie that allocates nothing once warm, each sample on-CPU
  or waiting;
- :mod:`.stagetag`: the stage a thread declares at the instrumentation
  points, so samples bill to enqueue, dequeue, batch, device_put and
  dispatch;
- :mod:`.costmodel`: the ``prof`` registry source: cpu_frac, each stage's
  on-CPU ms, CPU ns and Python bytes a frame;
- :mod:`.export`: collapsed stacks, speedscope and the spool, merged
  across processes by ``python -m psana_ray_tpu_torch.obs.prof_merge``.

One default sampler a process (:func:`start_default_profiler`,
:func:`default_profiler`); the CLI flags come from :func:`add_profile_args`
(``--profile_hz 0`` turns it off). :func:`profile_top` (the flight dump's
``profile_top``) and :func:`profile_summary` (the federation payload's
``profile``) give None while no sampler runs. Pure stdlib: a producer,
consumer or queue server process with the profiler on loads no torch.
"""

from __future__ import annotations

import argparse
import atexit
import threading
from typing import Optional

from psana_ray_tpu_torch.obs.profiling.costmodel import ProfTelemetry, wire_bytes
from psana_ray_tpu_torch.obs.profiling.export import (
    collapsed_lines,
    frame_label,
    load_spool,
    parse_collapsed,
    speedscope_doc,
    spool_doc,
    write_spool,
)
from psana_ray_tpu_torch.obs.profiling.sampler import DEFAULT_HZ, FlameSampler, StackTrie
from psana_ray_tpu_torch.obs.profiling.stagetag import (
    N_TAGS,
    TAG_BATCH,
    TAG_DEQUEUE,
    TAG_DEVICE_PUT,
    TAG_DISPATCH,
    TAG_ENQUEUE,
    TAG_NAMES,
    TAG_OF_STAGE,
    TAG_QUEUE_DWELL,
    TAG_UNTAGGED,
    current_tag,
    set_stage,
    stage_region,
    swap_stage,
)

__all__ = [
    "DEFAULT_HZ",
    "FlameSampler",
    "StackTrie",
    "ProfTelemetry",
    "wire_bytes",
    "stage_region",
    "set_stage",
    "swap_stage",
    "current_tag",
    "N_TAGS",
    "TAG_BATCH",
    "TAG_DEQUEUE",
    "TAG_DEVICE_PUT",
    "TAG_DISPATCH",
    "TAG_ENQUEUE",
    "TAG_NAMES",
    "TAG_OF_STAGE",
    "TAG_QUEUE_DWELL",
    "TAG_UNTAGGED",
    "collapsed_lines",
    "parse_collapsed",
    "speedscope_doc",
    "spool_doc",
    "write_spool",
    "load_spool",
    "frame_label",
    "default_profiler",
    "start_default_profiler",
    "stop_default_profiler",
    "profile_top",
    "profile_summary",
    "add_profile_args",
    "configure_profiling_from_args",
]

_default_lock = threading.Lock()
_default_sampler: Optional[FlameSampler] = None  # guarded-by: _default_lock
_atexit_armed = False  # guarded-by: _default_lock


def default_profiler() -> Optional[FlameSampler]:
    """The process's sampler, or None while profiling is off."""
    with _default_lock:
        return _default_sampler


def start_default_profiler(
    hz: float = DEFAULT_HZ,
    spool_dir: Optional[str] = None,
    process: str = "",
    registry=None,
    frames_fn=None,
    bytes_fn=None,
) -> FlameSampler:
    """Start (or return) the process's sampler, registered as the ``prof``
    source, with an atexit stop that writes the spool when ``spool_dir``
    is set. Idempotent: the first caller's settings hold. ``frames_fn``
    and ``bytes_fn`` replace the WIRE counters the cost model divides by."""
    global _default_sampler, _atexit_armed
    with _default_lock:
        if _default_sampler is None:
            _default_sampler = FlameSampler(
                hz=hz, process=process, spool_dir=spool_dir, registry=registry,
                frames_fn=frames_fn, bytes_fn=bytes_fn,
            ).start()
            if not _atexit_armed:
                _atexit_armed = True
                atexit.register(stop_default_profiler)
        return _default_sampler


def stop_default_profiler() -> None:
    """Stop and forget the process's sampler, writing its spool when one
    was asked for (also the atexit hook)."""
    global _default_sampler
    with _default_lock:
        sampler, _default_sampler = _default_sampler, None
    if sampler is not None:
        sampler.stop()


def profile_top(n: int = 16) -> Optional[dict]:
    """The ``n`` hottest frames and each stage's on-CPU ms of the running
    sampler (a flight dump's ``profile_top``); None when off."""
    s = default_profiler()
    if s is None:
        return None
    trie = s.trie
    return {
        "hz": s.hz,
        "samples": trie.samples_total,
        "on_cpu": trie.on_cpu_total,
        "waiting": trie.waiting_total,
        "hot": trie.hot_frames(n),
        "stage_cpu_ms": s.stage_cpu_ms(),
    }


def profile_summary(top_n: int = 5) -> Optional[dict]:
    """The process's summary in the federation payload, outside its
    numeric ``metrics`` (frame names are strings): CPU share, the cost a
    frame, the hottest frames with their share of the on-CPU samples.
    None when off."""
    s = default_profiler()
    if s is None:
        return None
    trie = s.trie
    tel = s.telemetry
    on = trie.on_cpu_total
    hot = []
    for h in trie.hot_frames(top_n):
        hot.append({"frame": h["frame"], "self": h["self"],
                    "pct": (100.0 * h["self"] / on) if on else 0.0})
    return {
        "hz": s.hz,
        "samples": trie.samples_total,
        "on_cpu": on,
        "cpu_frac": tel.cpu_frac,
        "cpu_ns_per_frame": tel.cpu_ns_per_frame,
        "py_bytes_per_frame": tel.py_bytes_per_frame,
        "hot": hot,
        "stage_cpu_ms": s.stage_cpu_ms(),
    }


def add_profile_args(parser) -> None:
    """``--profile_hz`` and ``--profile_dir``, as every long-running CLI of
    the JAX package takes them. A parser that already owns
    ``--profile_dir`` (the consumer's ``torch.profiler`` directory) keeps
    it: the spool goes into the same directory."""
    parser.add_argument(
        "--profile_hz", type=float, default=DEFAULT_HZ,
        help="continuous-profiler sample rate in Hz (flame sampler and per-frame cost "
             "model; feeds flight dumps, federation and `python -m "
             "psana_ray_tpu_torch.obs.prof_merge`); 0 = off",
    )
    try:
        parser.add_argument(
            "--profile_dir", default=None,
            help="write a per-process profile spool (<process>-<pid>.prof.json) here on "
                 "exit, mergeable with `python -m psana_ray_tpu_torch.obs.prof_merge` "
                 "(default: no spool)",
        )
    except argparse.ArgumentError:
        pass


def configure_profiling_from_args(args, process: str = "", frames_fn=None,
                                  bytes_fn=None) -> Optional[FlameSampler]:
    """Start the process's sampler from :func:`add_profile_args`'s flags
    (None with ``--profile_hz 0``). The port's programs pass their frame
    count as ``frames_fn`` and :func:`wire_bytes` as ``bytes_fn``: over
    TCP a relayed or received frame is no WIRE copy."""
    hz = getattr(args, "profile_hz", 0.0) or 0.0
    if hz <= 0:
        return None
    return start_default_profiler(hz=hz, spool_dir=getattr(args, "profile_dir", None),
                                  process=process, frames_fn=frames_fn, bytes_fn=bytes_fn)
