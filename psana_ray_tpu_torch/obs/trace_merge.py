"""Merge per-process trace spools into one Chrome trace-event JSON.

The port's copy of ``psana_ray_tpu/obs/trace_merge.py``.
``python -m psana_ray_tpu_torch.obs.trace_merge <spool-dir-or-files...>
[--out merged_trace.json] [--exemplar ID]`` reads the JSONL spools of
:class:`psana_ray_tpu_torch.obs.tracing.Tracer` (one a process: producer,
queue server, consumer, ...; the JAX package's spools too), estimates each
process's clock offset, and writes the Chrome trace-event format that
Perfetto (https://ui.perfetto.dev) loads: one track a process, a frame's
spans linked across tracks by its trace id (flow arrows).

Clock alignment, two layers:

- monotonic -> wall, a process: ``offset = median(wall - mono)`` over the
  spool's anchor pairs;
- wall -> the queue server's wall, a process: over the peer anchors (the
  TCP opcode 'A'), ``skew = median(local_wall_mid - peer_wall)``, bounded
  by the round trip; 0 for a process without exchanges.

One timeline: ``ts = mono + offset - skew``, in microseconds.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional

__all__ = ["load_spool", "merge", "main"]


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if not n:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def load_spool(path: str) -> dict:
    """Parse one spool: ``{"meta": {...}, "anchors": [...], "peers":
    [...], "spans": [...], "instants": [...]}``. Tolerates a truncated
    final line (the process may have died mid-write — that is exactly
    when these files matter)."""
    meta: dict = {}
    anchors: List[dict] = []
    peers: List[dict] = []
    spans: List[dict] = []
    instants: List[dict] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail write from a crashed process
            t = rec.get("t")
            if t == "m":
                meta = rec
            elif t == "a":
                anchors.append(rec)
            elif t == "p":
                peers.append(rec)
            elif t == "s":
                spans.append(rec)
            elif t == "i":
                instants.append(rec)
    return {
        "path": path,
        "meta": meta,
        "anchors": anchors,
        "peers": peers,
        "spans": spans,
        "instants": instants,
    }


def clock_offset(spool: dict) -> float:
    """monotonic -> wall offset for this process (median over anchors;
    falls back to the meta line's start pair)."""
    pairs = [(a["wall"], a["mono"]) for a in spool["anchors"]]
    meta = spool["meta"]
    if not pairs and "start_wall" in meta:
        pairs = [(meta["start_wall"], meta["start_mono"])]
    if not pairs:
        return 0.0
    return _median([w - m for w, m in pairs])


def clock_skew(spool: dict, offset: float) -> float:
    """This process's wallclock skew vs the queue server (0 without
    peer-anchor exchanges). Positive = this host's clock runs ahead."""
    ests = []
    for p in spool["peers"]:
        try:
            mid_mono = 0.5 * (p["send_mono"] + p["recv_mono"])
            ests.append((offset + mid_mono) - p["peer_wall"])
        except KeyError:
            continue
    return _median(ests) if ests else 0.0


def _expand(paths: List[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "*.trace.jsonl"))))
        else:
            out.append(p)
    return out


def merge(paths: List[str], only_trace: Optional[int] = None) -> dict:
    """Merge spool files (or directories of them) into a Chrome
    trace-event document (the ``json.dump``-ready dict).

    ``only_trace`` keeps one trace id: the ``--exemplar`` lookup, which
    resolves a latency bucket's retained exemplar to that frame's
    timeline across processes."""
    files = _expand(paths)
    if not files:
        raise FileNotFoundError(f"no trace spools found under {paths!r}")
    spools = [load_spool(p) for p in files]
    if only_trace is not None:
        for spool in spools:
            spool["spans"] = [
                s for s in spool["spans"] if s.get("id") == only_trace
            ]
            spool["instants"] = [
                i for i in spool["instants"] if i.get("id") == only_trace
            ]
    events: List[dict] = []
    flows: Dict[int, List[dict]] = {}  # trace_id -> [(ts, pid)] span starts
    summary = []
    for pid, spool in enumerate(spools, start=1):
        meta = spool["meta"]
        offset = clock_offset(spool)
        skew = clock_skew(spool, offset)
        name = (
            f"{meta.get('process', 'proc')} "
            f"{meta.get('host', '?')}:{meta.get('pid', '?')}"
        )
        summary.append(
            {
                "track": pid,
                "process": name,
                "spool": spool["path"],
                "spans": len(spool["spans"]),
                "instants": len(spool["instants"]),
                "mono_to_wall_offset_s": offset,
                "skew_vs_server_s": skew,
                "peer_anchor_exchanges": len(spool["peers"]),
            }
        )
        events.append(
            {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": name}}
        )
        base = offset - skew

        def us(mono: float, _base=base) -> float:
            return (mono + _base) * 1e6

        for s in spool["spans"]:
            tid = s.get("id", 0)
            ts = us(s["a"])
            events.append(
                {
                    "ph": "X", "name": s["n"], "cat": "frame",
                    "pid": pid, "tid": 0,
                    "ts": ts, "dur": max(0.0, us(s["b"]) - ts),
                    "args": {"trace_id": f"{tid:#x}"},
                }
            )
            flows.setdefault(tid, []).append({"ts": ts, "pid": pid})
        for i in spool["instants"]:
            tid = i.get("id", 0)
            events.append(
                {
                    "ph": "i", "name": i["n"], "cat": "frame", "s": "t",
                    "pid": pid, "tid": 0, "ts": us(i["a"]),
                    "args": {"trace_id": f"{tid:#x}"},
                }
            )
    # flow arrows: one chain per trace id through its span starts in
    # unified-time order — the cross-track "this frame went here next"
    # links Perfetto draws
    for tid, starts in flows.items():
        starts.sort(key=lambda e: e["ts"])
        if len(starts) < 2:
            continue
        for i, st in enumerate(starts):
            ph = "s" if i == 0 else ("f" if i == len(starts) - 1 else "t")
            evt = {
                "ph": ph, "id": tid, "name": "frame", "cat": "flow",
                "pid": st["pid"], "tid": 0, "ts": st["ts"],
            }
            if ph == "f":
                evt["bp"] = "e"  # bind to the enclosing slice
            events.append(evt)
    events.sort(key=lambda e: (e.get("ts", 0.0), e.get("pid", 0)))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        # the JAX package's tool name: both packages' merges write one document
        "otherData": {"tool": "psana_ray_tpu.obs.trace_merge", "tracks": summary},
    }


def exemplar_timeline(doc: dict) -> List[dict]:
    """The filtered merged doc's frame spans in unified-time order —
    one row per (process, span) with aligned start/duration, the
    human-readable half of ``--exemplar``."""
    tracks = {
        t["track"]: t["process"] for t in doc["otherData"]["tracks"]
    }
    rows = []
    for e in doc["traceEvents"]:
        if e.get("ph") in ("X", "i") and e.get("cat") == "frame":
            rows.append(
                {
                    "process": tracks.get(e["pid"], str(e["pid"])),
                    "span": e["name"],
                    "ts_us": e["ts"],
                    "dur_us": e.get("dur", 0.0),
                }
            )
    rows.sort(key=lambda r: r["ts_us"])
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m psana_ray_tpu_torch.obs.trace_merge",
        description="merge per-process trace spools into Chrome trace-event "
        "JSON (open in https://ui.perfetto.dev or TensorBoard)",
    )
    p.add_argument(
        "inputs", nargs="+",
        help="spool files (*.trace.jsonl) or directories containing them",
    )
    p.add_argument("--out", default="merged_trace.json", help="output path")
    p.add_argument(
        "--exemplar", default=None, metavar="TRACE_ID",
        help="resolve ONE trace id (hex 0x... or decimal — the form a "
        "latency histogram's exemplars dict retains) to its merged "
        "cross-host timeline: prints the span table and writes the "
        "filtered trace doc to --out",
    )
    a = p.parse_args(argv)
    only_trace = None
    if a.exemplar is not None:
        try:
            only_trace = int(a.exemplar, 0)
        except ValueError:
            print(f"error: --exemplar {a.exemplar!r} is not a trace id "
                  f"(want 0x... or decimal)", file=sys.stderr)
            return 2
    try:
        doc = merge(a.inputs, only_trace=only_trace)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if only_trace is not None:
        rows = exemplar_timeline(doc)
        if not rows:
            print(
                f"exemplar {only_trace:#x}: no spans in the given spools "
                f"(sampled out, or the wrong spool directory)",
                file=sys.stderr,
            )
            return 1
        print(f"exemplar {only_trace:#x}: {len(rows)} span(s) across "
              f"{len({r['process'] for r in rows})} process(es)")
        t0 = rows[0]["ts_us"]
        for r in rows:
            print(
                f"  +{(r['ts_us'] - t0) / 1e3:9.3f}ms "
                f"{r['span']:<12} {r['dur_us'] / 1e3:9.3f}ms  "
                f"[{r['process']}]"
            )
    with open(a.out, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    tracks = doc["otherData"]["tracks"]
    n_spans = sum(t["spans"] for t in tracks)
    print(f"merged {len(tracks)} process track(s), {n_spans} span(s) -> {a.out}")
    for t in tracks:
        print(
            f"  [{t['track']}] {t['process']}: {t['spans']} spans, "
            f"offset {t['mono_to_wall_offset_s']:.3f}s, "
            f"skew {t['skew_vs_server_s'] * 1e3:.3f}ms "
            f"({t['peer_anchor_exchanges']} anchor exchanges)"
        )
    print("open in Perfetto: https://ui.perfetto.dev -> Open trace file")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
