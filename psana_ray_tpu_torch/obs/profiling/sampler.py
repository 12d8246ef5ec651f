"""The continuous flame sampler: a bounded stack trie and a 97 Hz thread.

The port's copy of ``psana_ray_tpu/obs/profiling/sampler.py``. A daemon
thread wakes 97 times a second (prime, so it beats neither against the
kernel's 100 Hz accounting tick nor the 1 Hz history sampler), takes every
thread's Python stack with ``sys._current_frames()`` and folds each into a
bounded trie of preallocated ``array`` columns keyed by code object, so
that a warmed sampler allocates nothing and the profile stays a few hundred
KB however long the process runs.

- **On-CPU or waiting**: a thread's CPU time, read from
  ``/proc/self/task/<tid>/stat`` (utime + stime, one ``os.pread`` of a
  cached descriptor a thread a sample), tells whether it ran since its
  last sample; one that did not was waiting (GIL, select, a queue) and
  bills to the ``off`` column. The accounting is in clock ticks (10 ms),
  and a sample bills to the stack and tag of the moment it is taken: a
  thread that ran and then blocked shows the blocking frame as on-CPU.
  Where the process has no procfs every sample counts as on-CPU. A thread
  that ``threading.enumerate`` does not list (started by
  ``_thread.start_new_thread``, as pytest-xdist's receiver thread is) has
  no known native id and so no stat descriptor: its samples count as
  waiting, where the JAX sampler counts them on-CPU at every sample.
- **Stage tags**: each sample bills to the
  :mod:`~psana_ray_tpu_torch.obs.profiling.stagetag` tag its thread last
  declared.

A test pins the steady state of :meth:`StackTrie.sample` and
:meth:`FlameSampler._sample_once` with ``sys.getallocatedblocks``; a new
code object, trie path or thread grows in the cold helpers.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from array import array
from typing import Dict, List, Optional

from psana_ray_tpu_torch.obs.profiling.costmodel import ProfTelemetry
from psana_ray_tpu_torch.obs.profiling.stagetag import N_TAGS, TAG_NAMES, _TAGS, clear_thread

__all__ = ["StackTrie", "FlameSampler", "DEFAULT_HZ", "DEFAULT_MAX_NODES", "DEFAULT_MAX_DEPTH"]

#: 97 Hz: prime, off the 100 Hz tick and the 1 Hz samplers
DEFAULT_HZ = 97.0
DEFAULT_MAX_NODES = 8192
DEFAULT_MAX_DEPTH = 64


class StackTrie:
    """A bounded call-stack trie with preallocated count columns.

    Nodes are rows of parallel ``array`` columns (parent, key, on-CPU
    count, waiting count); a node's children are a dict keyed by
    ``id(code)``, which stays hit-only once every hot path is known. The
    trie is rooted at one node a stage tag (negative keys), so a (stage,
    stack) is one path. Past ``max_nodes`` a new path bills to its deepest
    known prefix and ``overflow_total`` counts it. One writer (the sampler
    thread); readers take no lock and may see a count one sample late."""

    __slots__ = (
        "_cap",
        "_max_depth",
        "_parent",
        "_key",
        "_on",
        "_off",
        "_kids",
        "_code",
        "_stack",
        "_stage_root",
        "_stage_on",
        "_stage_off",
        "_n",
        "samples_total",
        "on_cpu_total",
        "waiting_total",
        "overflow_total",
    )

    def __init__(self, max_nodes: int = DEFAULT_MAX_NODES, max_depth: int = DEFAULT_MAX_DEPTH):
        cap = max(int(max_nodes), N_TAGS + 1)
        self._cap = cap
        self._max_depth = max(int(max_depth), 4)
        self._parent = array("l", [-1]) * cap
        self._key = array("q", [0]) * cap
        self._on = array("q", [0]) * cap
        self._off = array("q", [0]) * cap
        self._kids: List[Dict[int, int]] = []
        self._code: Dict[int, object] = {}  # id(code) -> code: keeps the keys unique
        self._stack = array("q", [0]) * self._max_depth
        self._stage_on = array("q", [0]) * N_TAGS
        self._stage_off = array("q", [0]) * N_TAGS
        self._n = 0
        self.samples_total = 0
        self.on_cpu_total = 0
        self.waiting_total = 0
        self.overflow_total = 0
        # a root a stage tag, key -(tag + 1): never an id()
        self._stage_root = array("l", [0]) * N_TAGS
        for t in range(N_TAGS):
            self._stage_root[t] = self._grow(-1, -(t + 1))

    @property
    def n_nodes(self) -> int:
        return self._n

    def _grow(self, parent: int, key: int) -> int:
        """A new node (first sight of a (stage, prefix)); -1 when full."""
        n = self._n
        if n >= self._cap:
            return -1
        self._parent[n] = parent
        self._key[n] = key
        self._kids.append({})
        if parent >= 0:
            self._kids[parent][key] = n
        self._n = n + 1
        return n

    def sample(self, frame, on_cpu, tag):  # lint: sample-path
        """Fold one thread's stack (the sampler thread only)."""
        stack = self._stack
        code_of = self._code
        lim = self._max_depth
        depth = 0
        f = frame
        while f is not None and depth < lim:
            c = f.f_code
            k = id(c)
            if k not in code_of:
                code_of[k] = c
            stack[depth] = k
            depth += 1
            f = f.f_back
        node = self._stage_root[tag]
        kids = self._kids
        i = depth - 1  # the stack is leaf-first: fold it root-first
        while i >= 0:
            k = stack[i]
            nxt = kids[node].get(k, -1)
            if nxt < 0:
                nxt = self._grow(node, k)
                if nxt < 0:
                    self.overflow_total += 1
                    break  # the deepest prefix that fits takes the count
            node = nxt
            i -= 1
        if on_cpu:
            self._on[node] += 1
            self._stage_on[tag] += 1
            self.on_cpu_total += 1
        else:
            self._off[node] += 1
            self._stage_off[tag] += 1
            self.waiting_total += 1
        self.samples_total += 1

    # -- reads (exports, dumps, tests) ----------------------------------
    def _label(self, key: int) -> str:
        c = self._code.get(key)
        if c is None:
            return "?"
        name = getattr(c, "co_qualname", None) or c.co_name
        return "%s:%s:%d" % (os.path.basename(c.co_filename), name, c.co_firstlineno)

    def rows(self) -> List[dict]:
        """Every counted (stage, stack) as ``{"stage", "frames", "on",
        "off"}``, frames root-first."""
        out: List[dict] = []
        for node in range(self._n):
            on = self._on[node]
            off = self._off[node]
            if on == 0 and off == 0:
                continue
            frames: List[str] = []
            stage = TAG_NAMES[0]
            i = node
            while i >= 0:
                k = self._key[i]
                if k < 0:
                    stage = TAG_NAMES[-k - 1]
                else:
                    frames.append(self._label(k))
                i = self._parent[i]
            frames.reverse()
            out.append({"stage": stage, "frames": frames, "on": int(on), "off": int(off)})
        return out

    def hot_frames(self, n: int = 16) -> List[dict]:
        """The ``n`` frames with the most self on-CPU samples (a count
        bills to the sampled leaf, so a node's count is its self time)."""
        agg: Dict[str, int] = {}
        for node in range(self._n):
            on = self._on[node]
            k = self._key[node]
            if on and k >= 0:
                lbl = self._label(k)
                agg[lbl] = agg.get(lbl, 0) + int(on)
        top = sorted(agg.items(), key=lambda kv: (-kv[1], kv[0]))[:n]
        return [{"frame": lbl, "self": cnt} for lbl, cnt in top]

    def stage_totals(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for t in range(N_TAGS):
            on = int(self._stage_on[t])
            off = int(self._stage_off[t])
            if on or off:
                out[TAG_NAMES[t]] = {"on": on, "off": off}
        return out


class FlameSampler:
    """The profiler's daemon thread.

    ``start()`` spawns one thread that paces itself with a drift-corrected
    ``Event.wait``, samples every other live thread into a
    :class:`StackTrie` and about once a second ticks the cost model
    (:class:`ProfTelemetry`) and closes the descriptors of dead threads.
    ``stop()`` joins it and, with ``spool_dir``, writes the spool that
    ``python -m psana_ray_tpu_torch.obs.prof_merge`` reads. ``register``
    publishes the cost model as the ``prof`` registry source."""

    DEFAULT_HZ = DEFAULT_HZ

    def __init__(
        self,
        hz: float = DEFAULT_HZ,
        max_nodes: int = DEFAULT_MAX_NODES,
        max_depth: int = DEFAULT_MAX_DEPTH,
        process: str = "",
        spool_dir: Optional[str] = None,
        registry=None,
        register: bool = True,
        frames_fn=None,
        bytes_fn=None,
    ):
        self.hz = float(hz)
        if self.hz <= 0:
            raise ValueError("FlameSampler hz must be > 0 (use 0 at the CLI to disable)")
        self.period_s = 1.0 / self.hz
        self.process = process or os.path.basename(sys.argv[0] or "py")
        self.spool_dir = spool_dir
        self.trie = StackTrie(max_nodes=max_nodes, max_depth=max_depth)
        self.telemetry = ProfTelemetry(sampler=self, frames_fn=frames_fn, bytes_fn=bytes_fn)
        self._registry = registry
        self._register = register
        self._registered = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._own_ident = -1
        # ident -> [fd, last cpu ticks]: a list, updated in place
        self._threads: Dict[int, list] = {}
        self._procfs = os.path.isdir("/proc/self/task")  # per-thread CPU times readable
        self.start_wall = 0.0
        self.start_mono = 0.0
        self.anchors: List[dict] = []

    # -- lifecycle --------------------------------------------------------
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "FlameSampler":
        if self._thread is not None:
            return self
        self.start_wall = time.time()
        self.start_mono = time.monotonic()
        self.anchors.append({"wall": self.start_wall, "mono": self.start_mono})
        self._stop.clear()
        if self._register and not self._registered:
            try:
                if self._registry is None:
                    from psana_ray_tpu_torch.obs.registry import MetricsRegistry

                    self._registry = MetricsRegistry.default()
                self._registry.register("prof", self.telemetry)
                self._registered = True
            except Exception:  # noqa: BLE001 (the profiler works without the registry)
                pass
        t = threading.Thread(target=self._run, name="prof-sampler", daemon=True)
        self._thread = t
        t.start()
        return self

    def stop(self, write_spool: bool = True) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=2.0)
        self._thread = None
        self.telemetry.tick_cost_model()
        if self._registered and self._registry is not None:
            try:
                self._registry.unregister("prof")
            except Exception:  # noqa: BLE001
                pass
            self._registered = False
        self._close_fds()
        if write_spool and self.spool_dir:
            try:
                from psana_ray_tpu_torch.obs.profiling.export import write_spool

                write_spool(self, directory=self.spool_dir)
            except Exception:  # noqa: BLE001 (a lost spool must not fail the exit)
                pass

    def rearm_after_fork(self, process: Optional[str] = None) -> "FlameSampler":
        """Make a sampler inherited across ``os.fork`` valid in the child:
        the parent's thread does not exist there, and the cached procfs
        descriptors describe the parent's threads (still readable after
        the fork, so they would bill the parent's CPU). Both are reset and
        the sampler starts again, under ``process`` when given.
        ``queue_server --workers`` starts each worker's sampler after the
        fork, so it never needs this."""
        self._thread = None
        self._stop.clear()
        self._close_fds()
        self._registered = False  # the child's registry is a copy
        if process:
            self.process = process
        return self.start()

    def _close_fds(self) -> None:
        for info in self._threads.values():
            if info[0] >= 0:
                try:
                    os.close(info[0])
                except OSError:
                    pass
        self._threads.clear()

    # -- the sampling loop ------------------------------------------------
    def _run(self):  # lint: sample-path
        self._own_ident = threading.get_ident()
        period = self.period_s
        nxt = time.monotonic() + period
        last_house = 0.0
        while True:
            now = time.monotonic()
            delay = nxt - now
            if delay < 0.0:
                nxt = now + period  # fell behind: re-anchor
                delay = 0.0
            if self._stop.wait(delay):
                break
            self._sample_once()
            nxt += period
            now = time.monotonic()
            if now - last_house >= 1.0:
                last_house = now
                self._housekeep(now)

    def _sample_once(self):  # lint: sample-path
        frames = sys._current_frames()
        trie = self.trie
        own = self._own_ident
        tags = _TAGS
        for ident in frames:
            if ident == own:
                continue
            tag = tags.get(ident, 0)
            if tag < 0 or tag >= N_TAGS:
                tag = 0
            trie.sample(frames[ident], self._thread_on_cpu(ident), tag)
        # the snapshot holds this frame, whose locals hold the snapshot:
        # drop it, or every sample leaves a cycle for the collector
        frames = None

    def _thread_on_cpu(self, ident):  # lint: sample-path
        """Did this thread's CPU time advance since its last sample? One
        pread of its cached stat descriptor (procfs rebuilds the file at
        offset 0)."""
        info = self._threads.get(ident)
        if info is None:
            info = self._register_thread(ident)
        fd = info[0]
        if fd < 0:
            # without procfs: on-CPU rather than a guess; a thread alone
            # without a descriptor: its CPU is unknown, not ours to bill
            return not self._procfs
        try:
            data = os.pread(fd, 512, 0)
        except OSError:
            info[0] = -1  # the thread ended between the snapshot and the read
            return True
        j = data.rfind(b")") + 2  # the comm field may hold spaces
        parts = data[j:].split()
        ticks = int(parts[11]) + int(parts[12])  # utime + stime
        prev = info[1]
        info[1] = ticks
        return ticks > prev

    # -- cold helpers (first sight, once a second) -------------------------
    def _register_thread(self, ident) -> list:
        nid = -1
        for t in threading.enumerate():
            if t.ident == ident:
                nid = getattr(t, "native_id", None) or -1
                break
        fd = -1
        if nid > 0:
            try:
                fd = os.open("/proc/self/task/%d/stat" % nid, os.O_RDONLY)
            except OSError:
                fd = -1
        info = [fd, 0]
        self._threads[ident] = info
        return info

    def _housekeep(self, now: float) -> None:
        try:
            self.telemetry.tick_cost_model(now)
        except Exception:  # noqa: BLE001
            pass
        self._gc_threads()

    def _gc_threads(self) -> None:
        live = sys._current_frames()
        dead = [i for i in self._threads if i not in live]
        live = None  # the same cycle as in _sample_once
        for ident in dead:
            info = self._threads.pop(ident, None)
            if info is not None and info[0] >= 0:
                try:
                    os.close(info[0])
                except OSError:
                    pass
            clear_thread(ident)

    # -- reads --------------------------------------------------------------
    def untracked_threads(self) -> List[int]:
        """Idents of the threads sampled so far that have no procfs
        descriptor, and so count as waiting at every sample."""
        return [ident for ident, info in list(self._threads.items()) if info[0] < 0]

    def stage_cpu_ms(self) -> Dict[str, float]:
        """On-CPU milliseconds a stage (samples times the period)."""
        period_ms = 1000.0 / self.hz
        out: Dict[str, float] = {}
        for name, t in self.trie.stage_totals().items():
            out[name] = t["on"] * period_ms
        return out
