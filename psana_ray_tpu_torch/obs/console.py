"""The live operator console over the federated metrics history.

The port's copy of ``psana_ray_tpu/obs/console.py``. ``python -m
psana_ray_tpu_torch.obs.top --peers host:port,http://host:port`` polls a
:class:`~psana_ray_tpu_torch.obs.collector.ClusterCollector` and renders
one pane over the fleet: a row a peer (queue servers over the 'N' metrics
RPC, the CLIs over ``/federate``; either package's) with fps, queue depth,
stream credits, the codec's ratio, the gateway's shed rate, replication
lag, CPU% (the profiler's ``cpu_frac``), BUSY% (the event loop's
``busy_frac``) and the hottest frame, an fps sparkline from the history,
and the active alerts. The shed column reads a process's ``gateway``
source (a :class:`~psana_ray_tpu_torch.serving.ServingGateway`'s).

Plain ANSI (home and clear between frames, no curses); ``--once`` prints
one frame without escapes, for scripts and tests.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

from psana_ray_tpu_torch.obs.collector import PEER_UP, ClusterCollector

__all__ = ["sparkline", "peer_row", "render", "main"]

_SPARK = "▁▂▃▄▅▆▇█"

# a CLI's frame counter; a queue server's fps is the sum of its queues'
# get rates (frames leaving the relay)
_FRAME_COUNTER_KEYS = (
    "producer.frames_total",
    "consumer.frames_total",
    "sfx.frames_total",
    "gateway.completed_total",
)


def sparkline(values: List[float], width: int = 24) -> str:
    """The last ``width`` values as a sparkline (empty and flat safe)."""
    vals = [v for v in values[-width:] if v == v]  # no NaNs
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK[0] * len(vals)
    span = hi - lo
    return "".join(_SPARK[min(len(_SPARK) - 1, int((v - lo) / span * len(_SPARK)))]
                   for v in vals)


def _fmt(v: Optional[float], digits: int = 1) -> str:
    if v is None:
        return "-"
    if abs(v) >= 1000:
        return f"{v:,.0f}"
    return f"{v:.{digits}f}"


def _sum_rates(store, suffix: str, prefix: str, window_s: float) -> Optional[float]:
    total = None
    for key in store.keys():
        if key.startswith(prefix) and key.endswith(suffix):
            r = store.rate(key, window_s)
            if r is not None:
                total = (total or 0.0) + max(0.0, r)
    return total


def _rates(pts) -> List[float]:
    return [(b[1] - a[1]) / (b[0] - a[0]) for a, b in zip(pts, pts[1:]) if b[0] > a[0]]


def peer_row(label: str, state, store, window_s: float = 30.0,
             profile: Optional[dict] = None) -> dict:
    """One display row from a peer's store (None: the peer never published
    that number). ``profile`` is its federated profile summary: CPU% takes
    its ``cpu_frac``, else the ``prof.cpu_frac`` series."""
    fps = None
    fps_key = None
    for key in _FRAME_COUNTER_KEYS:
        r = store.rate(key, window_s)
        if r is not None:
            fps, fps_key = max(0.0, r), key
            break
    if fps is None:
        fps = _sum_rates(store, ".gets", "queue_server.", window_s)
        fps_key = "queue_server.*.gets" if fps is not None else None
    depth = None
    for key in store.keys():
        if key.endswith(".depth") or key.endswith(".queue.depth"):
            depth = (depth or 0.0) + (store.last(key) or 0.0)
    # the sparkline: successive rates of the frame counter over the ring
    spark_vals: List[float] = []
    if fps_key and fps_key != "queue_server.*.gets":
        spark_vals = _rates(store.series(fps_key))
    elif fps_key:  # a queue server: its first queue's gets
        for key in sorted(store.keys()):
            if key.startswith("queue_server.") and key.endswith(".gets"):
                spark_vals = _rates(store.series(key))
                break
    cpu_frac = None
    hot = ""
    if isinstance(profile, dict):
        cpu_frac = profile.get("cpu_frac")
        hot_list = profile.get("hot") or []
        if hot_list:
            top = hot_list[0]
            hot = f"{top.get('frame', '?')} {top.get('pct', 0.0):.0f}%"
    if cpu_frac is None:
        cpu_frac = store.last("prof.cpu_frac")
    # the loop's duty cycle: a --workers peer row is one worker
    busy = store.last("evloop.busy_frac_ewma") or store.last("evloop.busy_frac")
    return {
        "label": label,
        "state": state,
        "fps": fps,
        "depth": depth,
        "credit": store.last("stream.credit_window"),
        "ratio": store.last("wire_codec.ratio_in") or store.last("wire_codec.ratio_out"),
        "shed_rate": store.rate("gateway.shed_total", window_s),
        "lag": store.last("replication.lag_records"),
        "spark": sparkline(spark_vals),
        "cpu_pct": None if cpu_frac is None else 100.0 * cpu_frac,
        "busy_pct": None if busy is None else 100.0 * busy,
        "hot": hot,
    }


def render(collector: ClusterCollector, window_s: float = 30.0,
           now: Optional[float] = None) -> str:
    """One frame of the console as plain text."""
    now = time.time() if now is None else now
    peers = collector.peers()
    up = sum(1 for p in peers if p.state == PEER_UP)
    alerts = collector.active_alerts()
    lines = [
        f"psana-ray obs.top — {len(peers)} peer(s), {up} up, "
        f"{len(alerts)} alert(s) active   "
        f"{time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(now))}",
        f"{'PEER':<28} {'ST':<9} {'HOST:PID':<18} {'FPS':>9} "
        f"{'DEPTH':>7} {'CREDIT':>7} {'RATIO':>6} {'SHED/s':>7} "
        f"{'LAG':>6} {'CPU%':>5} {'BUSY%':>5}  FPS HISTORY",
    ]
    for p in sorted(peers, key=lambda p: p.label):
        store = collector.store(p.label)
        row = peer_row(p.label, p.state, store, window_s, profile=getattr(p, "profile", None))
        hostpid = f"{p.host}:{p.pid}" if p.host else "-"
        wid = getattr(p, "worker", None)
        if wid is not None:
            hostpid += f"/w{wid}"
        hot = f"  hot: {row['hot']}" if row["hot"] else ""
        lines.append(
            f"{row['label']:<28.28} {row['state']:<9} {hostpid:<18.18} "
            f"{_fmt(row['fps']):>9} {_fmt(row['depth'], 0):>7} "
            f"{_fmt(row['credit'], 0):>7} {_fmt(row['ratio'], 2):>6} "
            f"{_fmt(row['shed_rate']):>7} {_fmt(row['lag'], 0):>6} "
            f"{_fmt(row['cpu_pct'], 0):>5} {_fmt(row['busy_pct'], 0):>5}  "
            f"{row['spark']}{hot}"
        )
        if p.state != PEER_UP and p.error:
            lines.append(f"  └─ {p.error[:100]}")
    if alerts:
        lines.append("alerts:")
        for a in alerts:
            lines.append(f"  ! {a['alert']} on {a['peer']} (active {a['for_s']}s)")
    snap = collector.snapshot()
    lines.append(
        f"sweeps={snap['sweeps_total']} pulls_ok={snap['pulls_ok_total']} "
        f"pulls_failed={snap['pulls_failed_total']} "
        f"alerts_fired={snap['alerts_fired_total']}"
    )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m psana_ray_tpu_torch.obs.top",
        description="live federated console over queue servers ('N' metrics RPC) and CLI "
                    "metrics endpoints (/federate)",
    )
    p.add_argument("--peers", required=True,
                   help="comma-separated peer list: host:port (queue server) and/or "
                        "http://host:port (a CLI's --metrics_port endpoint)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh/poll interval in seconds")
    p.add_argument("--window", type=float, default=30.0,
                   help="rate window in seconds for the fps/shed columns")
    p.add_argument("--once", action="store_true",
                   help="two quick sweeps, one plain frame to stdout, exit 0 — for scripts and "
                        "tests (no ANSI escapes)")
    p.add_argument("--settle", type=float, default=0.3,
                   help="--once only: gap between the two sweeps (rates need two samples)")
    a = p.parse_args(argv)
    peers = [s for s in a.peers.split(",") if s.strip()]
    collector = ClusterCollector(peers, interval_s=a.interval)
    try:
        if a.once:
            collector.poll_once()
            time.sleep(max(0.0, a.settle))
            collector.poll_once()
            print(render(collector, window_s=a.window))
            return 0
        collector.poll_once()
        while True:
            time.sleep(a.interval)
            collector.poll_once()
            frame = render(collector, window_s=a.window)
            sys.stdout.write("\x1b[H\x1b[2J" + frame + "\n")
            sys.stdout.flush()
    except KeyboardInterrupt:
        return 0
    finally:
        collector.stop()


if __name__ == "__main__":
    raise SystemExit(main())
