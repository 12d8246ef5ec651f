"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

Everything that belongs to a cell is found by name: ``BENCHMARK.json``
names the cell's configuration and traffic mix, ``configs/<config>.json``
holds the configuration's sizes and limits and ``configs/<config>.py``
how the program serves it, ``traffic/<traffic>.json`` the mix, and each
metric the cell reports is read by ``end_to_end/<metric>.py`` or
``metrics/<metric>.py`` (``read(run)`` returns a number, or None when
there is nothing to read).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "psana_ray_tpu")


def forbidden_modules(names=None) -> List[str]:
    """The loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``psana_ray_tpu_torch`` is not ``psana_ray_tpu``)."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A Python file under the benchmark's folder, loaded by its path."""
    name = "portbench._by_path." + str(path.relative_to(HERE)).replace("/", "_").replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reported(bench: dict, cell: str, kind: str) -> List[dict]:
    """The ``kind`` (``end_to_end`` or ``per_layer``) metrics that ``cell``
    reports: those whose ``workloads`` list it, or, without the key, every
    end-to-end metric and each per-layer metric whose end-to-end metric
    the cell reports."""
    e2e = {m["name"] for m in reported_e2e(bench, cell)}
    if kind == "end_to_end":
        return reported_e2e(bench, cell)
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def reported_e2e(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def merged(base: dict, over: Optional[dict]) -> dict:
    """``base`` with ``over``'s keys replaced, nested dicts merged."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Cell:
    """A cell's entries and files."""

    def __init__(self, bench: dict, name: str, overrides: Optional[dict] = None):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json; have {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        over = overrides or {}
        self.config = merged(load_json(REPO / conf["file"]), over.get("config"))
        self.module = load_module(REPO / conf["file"].replace(".json", ".py"))
        self.traffic = merged(load_json(HERE / "traffic" / f"{self.entry['traffic']}.json"),
                              over.get("traffic"))


class Run:
    """What a reader sees: the cell's configuration, traffic and module, the
    window with the program's record, and in a traced run the trace."""

    def __init__(self, cell: Cell, t_start: float):
        self.config, self.traffic, self.module = cell.config, cell.traffic, cell.module
        self.t_start = t_start
        self.window = None
        self.trace = None

    def traced_batches(self) -> List[Tuple[float, float]]:
        """``(dispatch, done)`` of each batch dispatched inside the traced
        window: the traced run synchronises the card at both ends, so each
        one's device work lies wholly inside."""
        t0, t1 = self.window.opened_at, self.window.closed_at
        return [(done - lat, done) for done, _, lat in self.window.batches
                if t0 < done - lat < t1]

    def costs(self, layer: str) -> list:
        """One batch's launches of ``layer`` as ``(bytes, operations)``."""
        return self.module.costs(self.config, self.traffic)[layer]


def read_metrics(run: Run, entries: List[dict], folder: str) -> Dict[str, dict]:
    out = {}
    for m in entries:
        value = load_module(HERE / folder / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides: Optional[dict] = None, controls: Tuple[str, ...] = ()
             ) -> Tuple[dict, Dict[str, dict], Dict[str, Dict[str, dict]]]:
    """Run ``name`` once; returns the result line's object, the numbers
    compared, each ``{"value", "limit"}``, and for each of ``controls`` (a
    rounding of :mod:`portbench.reference.precision`) the same numbers
    with the reference computed in that rounding in the program's place,
    on the same sampled frames."""
    import torch

    from portbench import generator, tracing, window as win
    from psana_ray_tpu_torch.transport.ring import RingBuffer

    cell = Cell(bench, name, overrides)
    run = Run(cell, t_start)
    cfg, traffic, mod = cell.config, cell.traffic, cell.module
    device = torch.device(device)
    cuda = device.type == "cuda"
    capture = tracing.Capture(trace)
    source = None

    def mark(name: str) -> float:
        """A traced window's end: the card drained, then the marker."""
        if not trace:
            return time.monotonic()
        if cuda:
            torch.cuda.synchronize()
        return capture.mark(name)

    def on_close() -> float:
        source.stop()
        return mark(tracing.CLOSE)

    steps = {"imports": time.monotonic() - t_start}  # set-up's parts, seconds

    def step(name: str) -> None:
        if cuda:
            torch.cuda.synchronize()
        steps[name] = time.monotonic() - t_start - sum(steps.values())

    data = generator.make_data(cfg["detector"], traffic, seed, device)
    step("data")
    tree = mod.make_tree(cfg, seed, device)
    step("weights")
    window = run.window = win.Window(seconds, traffic["warmup_batches"],
                                     lambda: mark(tracing.OPEN), on_close)
    sample = win.Sample(seed, traffic["sample_batches"])
    served = mod.Served(cfg, traffic, tree, data, device, win.recorder(window), window, sample,
                        capture)
    step("model")
    served.warm()
    step("warm_step")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    capture.start()
    ring = RingBuffer(maxsize=int(traffic["ring_slots"]))
    source = generator.Source(ring, data["pool"], data["energy"], traffic).start()
    try:
        served.run(ring)
    finally:
        source.stop()
        ring.close()
    n_put = source.join()
    if window.closed_at is None:
        raise RuntimeError(f"the stream ended before the window closed: {len(window.batches)} "
                           f"batches, {traffic['warmup_batches']} of them warm-up")
    if cuda:
        torch.cuda.synchronize()
    mem_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run.trace = capture.stop()

    metrics = read_metrics(run, reported(bench, name, "per_layer" if trace else "end_to_end"),
                           "metrics" if trace else "end_to_end")
    answered, written = served.answered(), served.written()
    steps["warmup_batches"] = window.t0 - t_start - sum(steps.values())
    info = {**window.summary(), **served.info(),
            "setup_parts_s": {k: round(v, 3) for k, v in steps.items()}}
    result_device = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": int(cell.entry["chips"]),
        "memory_peak_bytes": int(mem_peak),
    }
    extra = {}
    if run.trace is not None:
        t = run.trace
        result_device["busy_s"] = tracing.covered([(s, e) for _, s, e in t.device_ops], t.t0, t.t1)
        result_device["window_s"] = t.window_s
        extra["breakdown"] = tracing.breakdown(t)

    # the comparison: the program's state freed first, then the reference
    items = list(sample.items)
    served.release()
    del served
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = mod.check(cfg, traffic, tree, data, items, written, device)
    control_checks = {c: mod.check(cfg, traffic, tree, data, items, written, device, c)
                      for c in controls}
    missing = n_put - len(set(answered))
    checks["events_missing"] = {"value": float(missing), "limit": 0.0}
    checks["events_repeated"] = {"value": float(len(answered) - len(set(answered))), "limit": 0.0}
    checks["batches_compared"] = {"value": float(len(items)),
                                  "limit": float(traffic["sample_batches"]), "at_least": True}
    correct = all((c["value"] >= c["limit"]) if c.get("at_least") else (c["value"] <= c["limit"])
                  for c in checks.values())
    result = {"correct": bool(correct), "attempted": int(n_put),
              "failed": int(max(missing, 0)), "metrics": metrics, "device": result_device,
              **extra, "served": info}
    return result, checks, control_checks
