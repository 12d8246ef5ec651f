"""The knob registry: every dial the controller may turn, declared.

The port's copy of ``psana_ray_tpu/autotune/knobs.py``. A :class:`Knob`
is a named, bounded, quantized dial with a live getter and setter. The
registry (one a controlled process) is what the controller iterates, what
the ``autotune`` registry source snapshots, and where the single-writer
rules live:

- **manual pin**: a knob whose CLI flag the operator set is registered
  pinned; the operator's value is a decision, not a default, and the
  controller never overrides it;
- **gateway deference**: while a serving gateway is bound in the process
  the ``serving`` group (batch sizing) leaves the rotation:
  :class:`~psana_ray_tpu_torch.serving.policy.SloPolicy` closes that loop
  at each dispatch, and two controllers writing one dial oscillate.

Setters are bounded: they run on the controller's thread, an assignment
under a lock or one bounded wire exchange, never a sleep or an unbounded
wait. The factories of the standard knobs below let each CLI wire one
with one call; a factory returns ``None`` where its target cannot be
turned live (an shm queue has no put window).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

from psana_ray_tpu_torch.obs.flight import FLIGHT

# actuation sides (documentation + telemetry, not behavior)
SIDE_CLIENT = "client"
SIDE_SERVER = "server"
SIDE_CONSUMER = "consumer"

# the group SloPolicy owns while a gateway is bound (see note_gateway)
GROUP_SERVING = "serving"


class Knob:
    """One tunable: bounds, quantum, cost-of-change, live get/set.

    ``cost`` scales how long the controller holds a probe of this knob
    before judging it (a codec flip perturbs a whole connection; a poll
    interval is nearly free). ``values`` (optional) declares a discrete
    menu — e.g. ``(0, 1)`` for the wire-codec on/off dial — and
    overrides lo/hi/step stepping with next/previous-in-menu.
    """

    __slots__ = (
        "name", "group", "side", "lo", "hi", "step", "cost",
        "get", "set", "values",
    )

    def __init__(
        self,
        name: str,
        group: str,
        side: str,
        lo: float,
        hi: float,
        step: float,
        get: Callable[[], float],
        set: Callable[[float], None],
        cost: int = 1,
        values: Optional[Sequence[float]] = None,
    ):
        if not name:
            raise ValueError("knob needs a name")
        if values is None and (step <= 0 or hi < lo):
            raise ValueError(f"knob {name}: want lo <= hi and step > 0")
        self.name = name
        self.group = group
        self.side = side
        self.lo = float(lo)
        self.hi = float(hi)
        self.step = float(step)
        self.cost = max(1, int(cost))
        self.get = get
        self.set = set
        self.values = tuple(values) if values is not None else None

    def clamp(self, value: float) -> float:
        """Quantize ``value`` to the step grid anchored at ``lo`` and
        clip into [lo, hi]; discrete knobs snap to the nearest menu
        entry."""
        if self.values is not None:
            return min(self.values, key=lambda v: abs(v - value))
        if value <= self.lo:
            return self.lo
        if value >= self.hi:
            return self.hi
        q = round((value - self.lo) / self.step)
        return min(self.hi, self.lo + q * self.step)

    def clip(self, value: float) -> float:
        """Bounds only, NO grid snap — what a REVERT uses: the saved
        pre-probe value may legitimately sit off the probe grid (an
        operator default), and restoring it must be exact."""
        if self.values is not None:
            return min(self.values, key=lambda v: abs(v - value))
        return min(self.hi, max(self.lo, value))

    def neighbor(self, value: float, direction: int) -> float:
        """The next value one probe step away in ``direction`` (+1/-1),
        clamped — equal to ``value`` at a bound (the controller flips
        direction on that)."""
        if self.values is not None:
            vals = sorted(self.values)
            try:
                i = vals.index(self.clamp(value))
            except ValueError:
                i = 0
            j = min(len(vals) - 1, max(0, i + (1 if direction >= 0 else -1)))
            return vals[j]
        return self.clamp(value + (self.step if direction >= 0 else -self.step))


class _KnobStats:
    __slots__ = ("actuations", "reverts", "kept", "min_seen", "max_seen")

    def __init__(self):
        self.actuations = 0
        self.reverts = 0
        self.kept = 0  # probes that held their improvement
        self.min_seen: Optional[float] = None
        self.max_seen: Optional[float] = None


class KnobRegistry:
    """The controlled process's knob set + the ``autotune`` obs source.

    Registration order is the controller's probe rotation order. The
    registry owns actuation accounting (per-knob actuations / reverts /
    held-improvement counts, min/max actuated values) and the exclusion
    state (manual pins, gateway-owned groups) — the controller asks
    ``eligible()`` and calls ``apply()``; it never touches a setter
    directly, so every actuation is counted and breadcrumbed in exactly
    one place."""

    def __init__(self, mode: str = "on"):
        if mode not in ("on", "observe"):
            raise ValueError(f"mode must be on|observe, got {mode!r}")
        self.mode = mode
        self._lock = threading.Lock()
        self._knobs: Dict[str, Knob] = {}  # guarded-by: _lock
        self._order: List[str] = []  # guarded-by: _lock
        self._pinned: Dict[str, str] = {}  # name -> reason  # guarded-by: _lock
        self._excluded_groups: Dict[str, str] = {}  # guarded-by: _lock
        self._stats: Dict[str, _KnobStats] = {}  # guarded-by: _lock
        self._observed = 0  # observe-mode decisions logged  # guarded-by: _lock

    # -- population --------------------------------------------------------
    def register(self, knob: Optional[Knob], pinned_reason: Optional[str] = None):
        """Add a knob (None is a no-op, so factories can decline).
        ``pinned_reason`` registers it excluded — the manual-flag rule."""
        if knob is None:
            return None
        with self._lock:
            if knob.name in self._knobs:
                raise ValueError(f"knob {knob.name!r} already registered")
            self._knobs[knob.name] = knob
            self._order.append(knob.name)
            self._stats[knob.name] = _KnobStats()
            if pinned_reason:
                self._pinned[knob.name] = pinned_reason
        return knob

    def pin(self, name: str, reason: str) -> None:
        with self._lock:
            if name not in self._knobs:
                raise KeyError(name)
            self._pinned[name] = reason

    def note_gateway(self, gateway=None) -> None:
        """A serving gateway is bound in this process: its
        :class:`SloPolicy` is the single writer of batch sizing, so the
        ``serving`` knob group leaves the controller's rotation."""
        with self._lock:
            self._excluded_groups[GROUP_SERVING] = "slo-policy owns batch sizing"
        FLIGHT.record("autotune_defer", group=GROUP_SERVING, to="slo-policy")

    def exclude_group(self, group: str, reason: str) -> None:
        with self._lock:
            self._excluded_groups[group] = reason

    # -- controller surface ------------------------------------------------
    def eligible(self) -> List[str]:
        """Probe rotation: registered order minus pins and excluded
        groups."""
        with self._lock:
            return [
                n
                for n in self._order
                if n not in self._pinned
                and self._knobs[n].group not in self._excluded_groups
            ]

    def knob(self, name: str) -> Knob:
        with self._lock:
            return self._knobs[name]

    def current(self, name: str) -> float:
        return float(self.knob(name).get())

    def apply(self, name: str, value: float, why: str = "probe") -> float:
        """Actuate one knob (clamped + quantized). In observe mode the
        setter is NOT called — the decision is logged and counted so an
        operator can audit what the controller would do. Returns the
        value that is now (or would now be) in effect. Every call
        leaves a flight breadcrumb: tuning is never silent."""
        knob = self.knob(name)
        # probes land on the quantum grid; reverts restore the saved
        # value EXACTLY (it may sit off-grid — an operator default)
        target = knob.clip(value) if why == "revert" else knob.clamp(value)
        cur = float(knob.get())
        if self.mode == "observe":
            with self._lock:
                self._observed += 1
            FLIGHT.record(
                "autotune_observe", knob=name, current=cur, would_set=target,
                why=why,
            )
            return cur
        knob.set(target)
        with self._lock:
            st = self._stats[name]
            st.actuations += 1
            if why == "revert":
                st.reverts += 1
            st.min_seen = target if st.min_seen is None else min(st.min_seen, target)
            st.max_seen = target if st.max_seen is None else max(st.max_seen, target)
        FLIGHT.record(
            "autotune_revert" if why == "revert" else "autotune_actuate",
            knob=name, frm=cur, to=target, why=why,
        )
        return target

    def note_kept(self, name: str) -> None:
        with self._lock:
            self._stats[name].kept += 1

    # -- obs registry source ----------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            out: dict = {
                "mode": self.mode,
                "knobs_total": len(self._knobs),
                "pinned_total": len(self._pinned),
                "observed_total": self._observed,
            }
            for name, knob in self._knobs.items():
                st = self._stats[name]
                try:
                    cur = float(knob.get())
                except Exception:  # a dead target must not kill the scrape
                    cur = float("nan")
                out[name] = {
                    "current": cur,
                    "lo": knob.lo,
                    "hi": knob.hi,
                    "pinned": 1 if name in self._pinned else 0,
                    "actuations_total": st.actuations,
                    "reverts_total": st.reverts,
                    "kept_total": st.kept,
                    "min_actuated": st.min_seen if st.min_seen is not None else knob.lo,
                    "max_actuated": st.max_seen if st.max_seen is not None else knob.hi,
                }
            return out


# ---------------------------------------------------------------------------
# standard knob factories — each returns None when the target can't be
# actuated live (the registry's register(None) no-op absorbs it)
# ---------------------------------------------------------------------------

def put_window_knob(client: Any, lo: int = 4, hi: int = 256) -> Optional[Knob]:
    """Windowed-PUT depth on a TCP/cluster client (producer side)."""
    if not hasattr(client, "set_put_window"):
        return None
    return Knob(
        "put_window", group="transport", side=SIDE_CLIENT,
        lo=lo, hi=hi, step=max(1, lo),
        get=lambda: float(getattr(client, "put_window", lo)),
        set=lambda v: client.set_put_window(int(v)),
        cost=1,
    )


def stream_window_knob(client: Any, lo: int = 8, hi: int = 512) -> Optional[Knob]:
    """Stream credit window on a subscribed TCP/cluster client — the
    live resize rides a window-resize 'M' on the streamed connection
    ('K' replenish sizing follows from the new budget)."""
    if not hasattr(client, "set_stream_window"):
        return None
    return Knob(
        "stream_window", group="transport", side=SIDE_CLIENT,
        lo=lo, hi=hi, step=8,
        get=lambda: float(getattr(client, "stream_window", lo)),
        set=lambda v: client.set_stream_window(int(v)),
        cost=2,
    )


def drain_chunk_knob(control: Any, lo: int = 1, hi: int = 256) -> Knob:
    """``batches_from_queue`` pop size (frames per drain round trip) via
    a live :class:`~psana_ray_tpu_torch.infeed.batcher.DrainControl`. Group
    ``serving``: defers to SloPolicy when a gateway is bound."""
    return Knob(
        "drain_chunk", group=GROUP_SERVING, side=SIDE_CONSUMER,
        lo=lo, hi=hi, step=max(1, lo),
        get=lambda: float(control.chunk),
        set=lambda v: setattr(control, "chunk", int(v)),
        cost=1,
    )


def drain_poll_knob(
    control: Any, lo: float = 0.001, hi: float = 0.05
) -> Knob:
    """``batches_from_queue`` starvation poll interval via DrainControl."""
    return Knob(
        "drain_poll_s", group="drain", side=SIDE_CONSUMER,
        lo=lo, hi=hi, step=lo,
        get=lambda: float(control.poll_s),
        set=lambda v: setattr(control, "poll_s", float(v)),
        cost=1,
    )


def prefetch_depth_knob(pipeline: Any, lo: int = 1, hi: int = 8) -> Optional[Knob]:
    """InfeedPipeline / DevicePrefetcher staging depth. The pipeline's
    own ``set_prefetch_depth`` enforces the batch-arena aliasing bound
    (``batcher_buffers >= depth + 4``), so the knob's hi is clipped
    there, not here."""
    if not hasattr(pipeline, "set_prefetch_depth"):
        return None
    return Knob(
        "prefetch_depth", group="infeed", side=SIDE_CONSUMER,
        lo=lo, hi=hi, step=1,
        get=lambda: float(getattr(pipeline, "prefetch_depth", lo)),
        set=lambda v: pipeline.set_prefetch_depth(int(v)),
        cost=2,
    )


def fsync_batch_knob(
    log: Any, lo: int = 8, hi: int = 1024, name: str = "fsync_batch_n"
) -> Optional[Knob]:
    """Segment-log appends per fsync (queue server, durable queues).
    ``name`` lets the server register one dial PER NAMED QUEUE
    (``fsync_batch_n:<ns>/<queue>``) — each durable log tunes to its
    own producer cadence instead of inheriting the default queue's."""
    if not hasattr(log, "set_fsync_batch_n"):
        return None
    return Knob(
        name, group="durability", side=SIDE_SERVER,
        lo=lo, hi=hi, step=8,
        get=lambda: float(log.fsync_batch_n),
        set=lambda v: log.set_fsync_batch_n(int(v)),
        cost=2,
    )


def ram_items_knob(
    queue: Any, lo: int = 8, hi: int = 4096, name: str = "ram_items"
) -> Optional[Knob]:
    """RAM-resident records before spill on a DurableRingBuffer.
    ``name`` allows per-named-queue registration, like
    :func:`fsync_batch_knob`."""
    if not hasattr(queue, "set_ram_items"):
        return None
    return Knob(
        name, group="durability", side=SIDE_SERVER,
        lo=lo, hi=hi, step=8,
        get=lambda: float(queue.ram_items),
        set=lambda v: queue.set_ram_items(int(v)),
        cost=2,
    )


def workers_knob(
    current: int = 1, lo: int = 1, hi: Optional[int] = None
) -> Optional[Knob]:
    """Data-plane width (``--workers``) as a RECOMMENDATION-ONLY dial.

    A forked worker fleet cannot resize live: the rendezvous partition
    map and each durable log's single-owner contract are fixed at fork
    time, so an in-place width change would strand queue state. The
    setter therefore records the controller's preferred width (flight
    breadcrumb + autotune snapshot) for the operator's next restart
    instead of actuating. Declines on a single-core box — there is no
    parallel width to buy, and recommending one would be noise."""
    import os

    ncpu = os.cpu_count() or 1
    if ncpu <= 1:
        return None
    top = int(hi) if hi else ncpu
    state = {"want": float(max(1, current))}

    def _set(v: float) -> None:
        want = int(v)
        if want != int(state["want"]):
            FLIGHT.record(
                "workers_recommend", want=want, running=int(current)
            )
        state["want"] = float(want)

    return Knob(
        "workers", group="data_plane", side=SIDE_SERVER,
        lo=lo, hi=top, step=1,
        get=lambda: state["want"], set=_set, cost=4,
    )


def bufpool_retention_knob(pool: Any, lo: int = 1, hi: int = 64) -> Optional[Knob]:
    """BufferPool per-class retention floor (min_per_class)."""
    if not hasattr(pool, "set_min_per_class"):
        return None
    return Knob(
        "bufpool_min_per_class", group="memory", side=SIDE_CONSUMER,
        lo=lo, hi=hi, step=1,
        get=lambda: float(pool.min_per_class),
        set=lambda v: pool.set_min_per_class(int(v)),
        cost=1,
    )


def wire_codec_knob(client: Any) -> Optional[Knob]:
    """Wire compression on/off for a client connection: 1 advertises
    every codec this build implements and renegotiates, 0 renegotiates
    down to raw. High cost-of-change — a codec flip perturbs the whole
    connection, so the controller holds it longest. The ``--wire_codec
    auto`` connect-time probe makes the INITIAL call; this knob lets
    the controller re-make it from measured throughput while the link
    is live."""
    if not hasattr(client, "renegotiate_codec"):
        return None
    from psana_ray_tpu_torch.transport.codec import available_codecs

    names = available_codecs()
    if not names:
        return None

    def _get() -> float:
        return 1.0 if getattr(client, "codec_name", None) else 0.0

    def _set(v: float) -> None:
        client.renegotiate_codec(names if v >= 0.5 else None)

    return Knob(
        "wire_codec_on", group="codec", side=SIDE_CLIENT,
        lo=0.0, hi=1.0, step=1.0, get=_get, set=_set,
        cost=4, values=(0.0, 1.0),
    )
