"""The profile's export formats: collapsed stacks, speedscope, the spool.

The port's copy of ``psana_ray_tpu/obs/profiling/export.py``, with the
same documents, so that either package's tools read the other's files:

- **collapsed**: ``stage;frame;frame count`` lines for ``flamegraph.pl``
  or ``inferno``;
- **speedscope**: the sampled-profile JSON of https://speedscope.app;
- **spool**: the trie's rows, the (wall, mono) clock anchors and the
  cpu_frac timeline, one a process as ``<dir>/<process>-<pid>.prof.json``,
  merged by ``python -m psana_ray_tpu_torch.obs.prof_merge``. It is
  written to a temporary name and renamed, so a reader never sees half.

The stage rides as the first frame of every collapsed and speedscope
stack.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "frame_label",
    "collapsed_lines",
    "parse_collapsed",
    "speedscope_doc",
    "spool_doc",
    "write_spool",
    "load_spool",
]

SPOOL_KIND = "psana_ray_tpu.prof_spool"  # the JAX package's, so both read both


def frame_label(code) -> str:
    """``file.py:qualname:lineno``, the display key of a frame."""
    name = getattr(code, "co_qualname", None) or code.co_name
    return "%s:%s:%d" % (os.path.basename(code.co_filename), name, code.co_firstlineno)


def collapsed_lines(trie, waiting: bool = False) -> List[str]:
    """Collapsed-stack lines of the on-CPU counts (``waiting``: the
    off-CPU ones)."""
    key = "off" if waiting else "on"
    out: List[str] = []
    for row in trie.rows():
        count = row[key]
        if count <= 0:
            continue
        parts = [row["stage"]]
        parts.extend(row["frames"])
        out.append("%s %d" % (";".join(parts), count))
    return out


def parse_collapsed(lines) -> List[Tuple[List[str], int]]:
    """The inverse of :func:`collapsed_lines`."""
    out: List[Tuple[List[str], int]] = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        stack_s, _, count_s = line.rpartition(" ")
        out.append((stack_s.split(";"), int(count_s)))
    return out


def speedscope_doc(trie, name: str = "psana-ray-tpu", waiting: bool = False) -> dict:
    """A speedscope "sampled" profile: a sample a distinct (stage, stack),
    weighted by its count."""
    key = "off" if waiting else "on"
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
    for row in trie.rows():
        count = row[key]
        if count <= 0:
            continue
        stack = [fid("stage: %s" % row["stage"])]
        stack.extend(fid(lbl) for lbl in row["frames"])
        samples.append(stack)
        weights.append(count)
        total += count
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": [
            {
                "type": "sampled",
                "name": name,
                "unit": "none",
                "startValue": 0,
                "endValue": total,
                "samples": samples,
                "weights": weights,
            }
        ],
        "exporter": "psana_ray_tpu.obs.profiling",
        "name": name,
    }


def spool_doc(sampler) -> dict:
    """A process's mergeable profile document."""
    trie = sampler.trie
    anchors = list(sampler.anchors)
    # an anchor at dump time bounds the clock drift of a long run
    anchors.append({"wall": time.time(), "mono": time.monotonic()})
    return {
        "kind": SPOOL_KIND,
        "version": 1,
        "meta": {
            "process": sampler.process,
            "pid": os.getpid(),
            "hz": sampler.hz,
            "start_wall": sampler.start_wall,
            "start_mono": sampler.start_mono,
        },
        "anchors": anchors,
        "totals": {
            "samples": trie.samples_total,
            "on_cpu": trie.on_cpu_total,
            "waiting": trie.waiting_total,
            "nodes": trie.n_nodes,
            "overflow": trie.overflow_total,
        },
        "stage_totals": trie.stage_totals(),
        "stage_cpu_ms": sampler.stage_cpu_ms(),
        "cpu_series": [[t, v] for t, v in sampler.telemetry.cpu_timeline()],
        "stacks": trie.rows(),
    }


def write_spool(sampler, directory: Optional[str] = None, path: Optional[str] = None) -> str:
    """Write ``sampler``'s spool to ``path`` or
    ``<directory>/<process>-<pid>.prof.json`` (a temporary name in the
    same directory, then a rename); returns the path."""
    if path is None:
        directory = directory or sampler.spool_dir or "."
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "%s-%d.prof.json" % (sampler.process, os.getpid()))
    doc = spool_doc(sampler)
    tmp = "%s.%d.%d.tmp" % (path, os.getpid(), threading.get_ident())
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load_spool(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("kind") != SPOOL_KIND:
        raise ValueError("%s is not a psana_ray_tpu profile spool" % path)
    return doc
