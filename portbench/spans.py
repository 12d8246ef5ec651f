"""The program's own ranges in a traced window: what the ``program_span``
readers of ``metrics/`` share.

The port opens ``stage.*`` ranges inside its serving loop
(``psana_ray_tpu_torch.obs.stages``): a step's ``stage.dispatch`` with its
``stage.calib``, ``stage.model`` and ``stage.peaks`` launches, the host
blocked on the card (``stage.sync``, inside a dispatch or a drain), the
SFX drain (``stage.drain``), the batcher's copies (``stage.batch``) and the
consumer's wait for a staged batch (``stage.wait_staged``). A range counts
for the window when it starts inside ``(opened_at, closed_at]``. One range
lies inside another when its interval does: the program opens a range and
the ranges nested in it on one thread. Every function returns None where
the window holds no range of a name it reads (a program that does not
open it), so a reader reports nothing rather than a number of something
else.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def ranges(run, name: str) -> List[Tuple[float, float]]:
    """``(start, end)`` of each range named ``name`` that starts inside the
    traced window; empty without a trace."""
    if run.trace is None:
        return []
    lo, hi = run.window.opened_at, run.window.closed_at
    return [(s, e) for n, s, e in run.trace.ranges if n == name and lo < s <= hi]


def self_seconds(run, outer: str, inner: str) -> Optional[List[float]]:
    """For each ``outer`` range of the window, its seconds less those of the
    ``inner`` ranges inside it; None unless the window holds both."""
    outs, ins = ranges(run, outer), ranges(run, inner)
    if not outs or not ins:
        return None
    return [(e - s) - sum(ie - i_s for i_s, ie in ins if s <= i_s and ie <= e) for s, e in outs]


def mean_ms(seconds: Optional[List[float]]) -> Optional[float]:
    """The mean of ``seconds`` in ms; None for None or none."""
    return 1e3 * sum(seconds) / len(seconds) if seconds else None


def ms_per(run, name: str, count: int) -> Optional[float]:
    """The window's seconds of ``name`` ranges over ``count`` (a number of
    batches), in ms; None without such a range or a batch to divide by."""
    rows = ranges(run, name)
    return 1e3 * sum(e - s for s, e in rows) / count if rows and count > 0 else None


def batches_staged(run) -> int:
    """Batches the staging thread finished inside the traced window."""
    w = run.window
    return len(w.host_between(w.opened_at, w.closed_at))


def batches_done(run) -> int:
    """Batches whose result reached the host inside the traced window."""
    w = run.window
    return sum(1 for done, _, _ in w.batches if w.opened_at < done <= w.closed_at)
