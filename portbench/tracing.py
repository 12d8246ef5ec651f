"""The traced run: ``torch.profiler`` over the window, read in memory.

:class:`Capture` starts the profiler during set-up (so that its own
start-up cost stays out of the window), marks the window's ends with
zero-length ranges at known host times, and at the end reads the
profiler's events without writing a trace file: the device's kernels,
copies and memsets, and the host ranges (the program's ``stage.*`` and
the benchmark's ``portbench.*``). The functions below reduce those
intervals; they are plain arithmetic, tested on synthetic traces.

Times inside a :class:`Trace` are seconds on the host's monotonic clock:
the profiler's clock is mapped onto it through the opening marker.
"""

from __future__ import annotations

import contextlib
import heapq
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_PREFIXES = ("stage.", "portbench.")
OPEN, CLOSE = "portbench.window.open", "portbench.window.close"


class Trace:
    """What a traced window holds: ``kernels`` and ``device_ops`` as
    ``(name, start, end)``, host ``ranges`` as ``(name, start, end)``, and
    the window ``[t0, t1]``."""

    def __init__(self, kernels, device_ops, ranges, t0: float, t1: float):
        self.kernels = kernels
        self.device_ops = device_ops
        self.ranges = ranges
        self.t0, self.t1 = t0, t1

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def matching(self, names: Sequence[str]) -> List[Tuple[str, float, float]]:
        """The kernels inside the window whose name holds one of ``names``."""
        return [k for k in self.kernels
                if any(n in k[0] for n in names) and k[1] >= self.t0 and k[2] <= self.t1]


class Capture:
    """``torch.profiler`` with every thread's host ranges and the card's
    activity, or nothing when ``enabled`` is false."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self._marks: Dict[str, float] = {}

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        try:  # the staging thread's ranges too
            from torch.profiler import _ExperimentalConfig

            cfg = _ExperimentalConfig(profile_all_threads=True)
            self._prof = profile(activities=acts, experimental_config=cfg)
        except (ImportError, TypeError):
            self._prof = profile(activities=acts)
        self._prof.start()

    def range(self, name: str):
        """A host range on the timeline (nothing when not enabled)."""
        if not self.enabled:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def mark(self, name: str) -> float:
        """A zero-length range named ``name`` now; returns the host time."""
        import torch

        with torch.profiler.record_function(name):
            t = time.monotonic()
        self._marks[name] = t
        return t

    def stop(self) -> Optional[Trace]:
        if self._prof is None:
            return None
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        kernels, ops, ranges, marks = [], [], [], {}
        for e in events:
            act = activity(e)
            if act in DEVICE_OPS:
                s = e.start_ns()
                ops.append((e.name(), s, s + e.duration_ns()))
                if act == "kernel":
                    kernels.append(ops[-1])
            elif act == "user_annotation":
                name = e.name()
                if name in (OPEN, CLOSE):
                    marks[name] = e.start_ns()
                elif name.startswith(RANGE_PREFIXES):
                    s = e.start_ns()
                    ranges.append((name, s, s + e.duration_ns()))
        if OPEN not in marks or CLOSE not in marks or OPEN not in self._marks:
            raise RuntimeError("the trace lacks the window's markers")
        # profiler ns -> host monotonic s, through the opening marker
        off = self._marks[OPEN] - marks[OPEN] * 1e-9

        def conv(rows):
            return sorted((n, s * 1e-9 + off, t * 1e-9 + off) for n, s, t in rows)

        return Trace(conv(kernels), conv(ops), conv(ranges), self._marks[OPEN],
                     marks[CLOSE] * 1e-9 + off)


def activity(e) -> str:
    """An event's kind, as the profiler's ``activity_type`` names it: from
    the event where the build has that method (PyTorch 2.13), else from
    its device and name (2.11): on the card ``Memcpy``/``Memset`` rows are
    copies and memsets, ranges of ours are the host ranges' shadows, the
    rest kernels; on the host, ranges of ours are annotations."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    import torch

    name = e.name()
    ours = name.startswith(RANGE_PREFIXES) or name in (OPEN, CLOSE)
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        if ours:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "user_annotation" if ours else "cpu_op"


def merged(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The union of ``intervals`` clipped to ``[lo, hi]``, as disjoint sorted
    intervals."""
    out: List[List[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: Sequence[Interval], lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` that some interval covers (not a sum)."""
    return sum(e - s for s, e in merged(intervals, lo, hi))


def idle_gaps(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    gaps, t = [], lo
    for s, e in merged(intervals, lo, hi):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    return gaps


def label_gaps(gaps: Sequence[Interval], ranges: Sequence[Tuple[str, float, float]]) -> List[str]:
    """For each gap, the names of the host ranges open at its midpoint,
    sorted and joined with ``+`` (``"no range"`` when none is)."""
    starts = sorted((s, e, n) for n, s, e in ranges)
    mids = [0.5 * (a + b) for a, b in gaps]
    out = [""] * len(gaps)
    active: list = []  # heap of (end, name) of the ranges begun so far
    j = 0
    for i in sorted(range(len(gaps)), key=mids.__getitem__):
        while j < len(starts) and starts[j][0] <= mids[i]:
            heapq.heappush(active, (starts[j][1], starts[j][2]))
            j += 1
        while active and active[0][0] <= mids[i]:
            heapq.heappop(active)
        names = sorted({n for _, n in active})
        out[i] = "+".join(names) if names else "no range"
    return out


def top_by_name(rows: Sequence[Tuple[str, float]], n: int = 10) -> List[list]:
    """``[[name, seconds], ...]``: seconds summed by name, the ``n`` largest."""
    acc: Dict[str, float] = defaultdict(float)
    for name, sec in rows:
        acc[name] += sec
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]


def breakdown(trace: Trace, name_len: int = 120) -> dict:
    """The window's device operations that took most time, and its idle
    time by what the host was doing."""
    lo, hi = trace.t0, trace.t1
    ops = [(n[:name_len], min(e, hi) - max(s, lo)) for n, s, e in trace.device_ops
           if e > lo and s < hi]
    gaps = idle_gaps([(s, e) for _, s, e in trace.device_ops], lo, hi)
    labels = label_gaps(gaps, trace.ranges)
    return {"device_ops": top_by_name(ops),
            "idle_gaps": top_by_name([(lab, b - a) for lab, (a, b) in zip(labels, gaps)])}
