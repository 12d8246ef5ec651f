"""Merge per-process profile spools into one CPU profile of the cluster.

The port's copy of ``psana_ray_tpu/obs/prof_merge.py``, writing the same
document. ``python -m psana_ray_tpu_torch.obs.prof_merge
<spool-dir-or-files...> [--out merged_prof.json] [--collapsed out.folded]
[--speedscope out.ss.json] [--trace <trace spools...>]`` reads the
``*.prof.json`` spools of :class:`~psana_ray_tpu_torch.obs.profiling.
sampler.FlameSampler` (one a process, of either package) and writes:

- the merged summary: each process's numbers, the cluster's hot frames
  (self on-CPU samples) and each stage's on-CPU ms summed;
- optionally one collapsed-stack file and one speedscope document, each
  stack prefixed ``process;stage;...``;
- with ``--trace`` (the tracer's ``*.trace.jsonl`` spools),
  ``trace_merge``'s Perfetto document with one ``cpu_frac`` counter track
  a profiled process on the same timeline.

A spool's monotonic ticks map to the wall clock by ``offset =
median(wall - mono)`` over its anchors, as ``trace_merge`` aligns.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional

from psana_ray_tpu_torch.obs import trace_merge
from psana_ray_tpu_torch.obs.trace_merge import _median

__all__ = ["load_spool", "clock_offset", "merge", "merged_collapsed", "merged_speedscope",
           "main"]


def load_spool(path: str) -> dict:
    """One ``*.prof.json`` spool, with its ``path``."""
    from psana_ray_tpu_torch.obs.profiling.export import load_spool as _load

    doc = _load(path)
    doc["path"] = path
    return doc


def clock_offset(spool: dict) -> float:
    """The spool's monotonic -> wall offset: the median over its anchors,
    the meta's start pair without any."""
    pairs = [(a["wall"], a["mono"]) for a in spool.get("anchors", [])]
    meta = spool.get("meta", {})
    if not pairs and "start_wall" in meta:
        pairs = [(meta["start_wall"], meta["start_mono"])]
    if not pairs:
        return 0.0
    return _median([w - m for w, m in pairs])


def _expand(paths: List[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "*.prof.json"))))
        else:
            out.append(p)
    return out


def _name(spool: dict) -> str:
    meta = spool.get("meta", {})
    return "%s:%s" % (meta.get("process", "proc"), meta.get("pid", "?"))


def merge(paths: List[str], trace_inputs: Optional[List[str]] = None,
          top_n: int = 32) -> dict:
    """The cluster profile of the spools under ``paths`` (files or
    directories); with ``trace_inputs``, laid over ``trace_merge.merge``'s
    document as ``cpu_frac`` counter tracks."""
    files = _expand(paths)
    if not files:
        raise FileNotFoundError(f"no profile spools found under {paths!r}")
    spools = [load_spool(p) for p in files]

    processes: List[dict] = []
    hot_agg: Dict[str, int] = {}
    stage_ms: Dict[str, float] = {}
    events: List[dict] = []

    if trace_inputs:
        doc = trace_merge.merge(trace_inputs)
        events = doc["traceEvents"]
    else:
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"tool": "psana_ray_tpu.obs.prof_merge"},
        }

    # counter tracks take pids from 1000, far above trace_merge's tracks
    for i, spool in enumerate(spools):
        meta = spool.get("meta", {})
        offset = clock_offset(spool)
        name = _name(spool)
        totals = spool.get("totals", {})
        processes.append(
            {
                "process": name,
                "spool": spool["path"],
                "hz": meta.get("hz", 0.0),
                "mono_to_wall_offset_s": offset,
                "samples": totals.get("samples", 0),
                "on_cpu": totals.get("on_cpu", 0),
                "waiting": totals.get("waiting", 0),
                "overflow": totals.get("overflow", 0),
                "stage_cpu_ms": spool.get("stage_cpu_ms", {}),
            }
        )
        for stage, ms in spool.get("stage_cpu_ms", {}).items():
            stage_ms[stage] = stage_ms.get(stage, 0.0) + float(ms)
        for row in spool.get("stacks", []):
            on = row.get("on", 0)
            frames = row.get("frames", [])
            if on and frames:
                # a count bills to the sampled leaf: the leaf's self time
                hot_agg[frames[-1]] = hot_agg.get(frames[-1], 0) + on
        pid = 1000 + i
        events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                       "args": {"name": f"prof {name}"}})
        for t, v in spool.get("cpu_series", []):
            events.append({"ph": "C", "name": "cpu_frac", "pid": pid, "tid": 0,
                           "ts": (t + offset) * 1e6, "args": {"cpu_frac": v}})

    events.sort(key=lambda e: (e.get("ts", 0.0), e.get("pid", 0)))
    hot = [{"frame": lbl, "self": cnt}
           for lbl, cnt in sorted(hot_agg.items(), key=lambda kv: (-kv[1], kv[0]))[:top_n]]
    doc["profile"] = {
        "processes": processes,
        "hot": hot,
        "stage_cpu_ms": stage_ms,
        "on_cpu_total": sum(p["on_cpu"] for p in processes),
        "samples_total": sum(p["samples"] for p in processes),
    }
    return doc


def merged_collapsed(paths: List[str]) -> List[str]:
    """One collapsed-stack file of the cluster, each stack prefixed with
    its process's name."""
    out: List[str] = []
    for path in _expand(paths):
        spool = load_spool(path)
        name = _name(spool)
        for row in spool.get("stacks", []):
            on = row.get("on", 0)
            if on <= 0:
                continue
            parts = [name, row.get("stage", "untagged")]
            parts.extend(row.get("frames", []))
            out.append("%s %d" % (";".join(parts), on))
    return out


def merged_speedscope(paths: List[str]) -> dict:
    """A speedscope document of the cluster (sampled, process-prefixed)."""
    frames: List[dict] = []
    index: Dict[str, int] = {}
    samples: List[List[int]] = []
    weights: List[int] = []

    def fid(label: str) -> int:
        i = index.get(label)
        if i is None:
            i = len(frames)
            index[label] = i
            frames.append({"name": label})
        return i

    total = 0
    for line in merged_collapsed(paths):
        stack_s, _, count_s = line.rpartition(" ")
        count = int(count_s)
        samples.append([fid(lbl) for lbl in stack_s.split(";")])
        weights.append(count)
        total += count
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": [
            {
                "type": "sampled",
                "name": "psana-ray-tpu cluster",
                "unit": "none",
                "startValue": 0,
                "endValue": total,
                "samples": samples,
                "weights": weights,
            }
        ],
        "exporter": "psana_ray_tpu.obs.prof_merge",
        "name": "psana-ray-tpu cluster",
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m psana_ray_tpu_torch.obs.prof_merge",
        description="merge per-process profile spools (*.prof.json) into a cluster CPU "
                    "profile; optionally overlay cpu_frac counter tracks onto the trace_merge "
                    "Perfetto doc",
    )
    p.add_argument("inputs", nargs="+",
                   help="profile spools (*.prof.json) or directories containing them")
    p.add_argument("--out", default="merged_prof.json", help="output path")
    p.add_argument("--collapsed", default=None, metavar="PATH",
                   help="also write cluster collapsed stacks (flamegraph.pl input)")
    p.add_argument("--speedscope", default=None, metavar="PATH",
                   help="also write a cluster speedscope JSON (speedscope.app)")
    p.add_argument("--trace", nargs="+", default=None, metavar="TRACE",
                   help="trace spools (*.trace.jsonl) or directories: merge them via "
                        "trace_merge and embed cpu_frac counter tracks alongside the frame "
                        "spans on the unified timeline")
    a = p.parse_args(argv)
    try:
        doc = merge(a.inputs, trace_inputs=a.trace)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    with open(a.out, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    prof = doc["profile"]
    print(f"merged {len(prof['processes'])} process profile(s), {prof['samples_total']} "
          f"sample(s) ({prof['on_cpu_total']} on-CPU) -> {a.out}")
    for pr in prof["processes"]:
        print(f"  {pr['process']}: {pr['samples']} samples @ {pr['hz']:g} Hz, "
              f"offset {pr['mono_to_wall_offset_s']:.3f}s, {pr['overflow']} overflow")
    for h in prof["hot"][:10]:
        print(f"  hot: {h['self']:>8} {h['frame']}")
    if a.collapsed:
        lines = merged_collapsed(a.inputs)
        with open(a.collapsed, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        print(f"collapsed stacks -> {a.collapsed} ({len(lines)} stacks)")
    if a.speedscope:
        with open(a.speedscope, "w", encoding="utf-8") as f:
            json.dump(merged_speedscope(a.inputs), f)
        print(f"speedscope profile -> {a.speedscope}")
    if a.trace:
        print("cpu_frac counter tracks embedded alongside trace spans "
              "(open --out in https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
