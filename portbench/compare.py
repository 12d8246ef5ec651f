"""The comparison that decides ``correct``: the numbers a cell compares
with the plain reference, each against its limit.

- ``calib_err``: the calibrated frames, the largest ``|got - ref| /
  (|ref| + 1 ADU)`` over every pixel compared (one ADU: well under the
  read noise, so a wrong background shows and a bright pixel is judged by
  its relative error);
- ``*_rel_err``: the largest ``|got - ref|`` over the largest ``|ref|``
  of every value compared (the repo's measure of a bf16 network);
- ``peak_mismatch``: the peak lists written, against the reference's
  definition of peaks (``reference/peaks.py``) applied to the same
  batch's logits as the program computed them: the peaks written that it
  does not give, and those it gives that were not written (among equal
  scores at the event's cap, any choice). Exact: its limit is 0. The
  logits themselves are held to the reference by ``logits_rel_err``.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

import numpy as np
import torch

from portbench.reference import peaks as ref_peaks


class Max:
    """A running maximum."""

    def __init__(self):
        self.value = 0.0

    def add(self, x) -> None:
        x = float(x)
        self.value = x if x != x else max(self.value, x)  # NaN sticks


class RelErr:
    """``max |got - ref|`` over ``max |ref|``, accumulated."""

    def __init__(self):
        self.num, self.den = Max(), Max()

    def add(self, got: torch.Tensor, ref: torch.Tensor) -> None:
        self.num.add((got.float() - ref.float()).abs().max())
        self.den.add(ref.float().abs().max())

    @property
    def value(self) -> float:
        n, d = self.num.value, self.den.value
        return n / d if d > 0 else float("inf")


def calib_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float(((got.float() - ref).abs() / (ref.abs() + 1.0)).max())


def peak_mismatch(logits: torch.Tensor, ys, xs, scores, peaks_cfg: Dict) -> int:
    """One event's written peaks (raw coordinates, ``y = panel * H +
    y_panel``) against the peaks of its logits ``[P, H, W]``: how many
    differ."""
    cy, cx, cs = ref_peaks.event_peaks(logits, peaks_cfg["threshold"], peaks_cfg["min_distance"],
                                       peaks_cfg["max_peaks"], None)
    wmax = peaks_cfg["writer_max_peaks"]

    def entries(y, x, s):
        return Counter(zip(np.asarray(y, np.float64).astype(np.int64).tolist(),
                           np.asarray(x, np.float64).astype(np.int64).tolist(),
                           np.asarray(s, np.float32).tolist()))

    got, want = entries(ys, xs, scores), entries(cy, cx, cs)
    if len(cs) <= wmax:
        return sum(((got - want) + (want - got)).values())
    cut = float(np.float32(cs[wmax - 1]))
    above = Counter({e: n for e, n in want.items() if e[2] > cut})
    at_cut = {e for e in want if e[2] == cut}
    got_above = Counter({e: n for e, n in got.items() if e[2] > cut})
    got_at = [e for e, n in got.items() for _ in range(n) if e[2] == cut]
    below = sum(n for e, n in got.items() if e[2] < cut)
    return (sum(((got_above - above) + (above - got_above)).values()) + below
            + sum(e not in at_cut for e in got_at)
            + abs(len(got_at) - (wmax - sum(above.values()))))
