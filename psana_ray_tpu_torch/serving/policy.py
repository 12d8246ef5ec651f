"""SLO policy: the measured latency/throughput frontier as a control law.

The port's copy of ``psana_ray_tpu/serving/policy.py``. A table of
operating points (batch size, device time) becomes the two decisions the
gateway makes at each dispatch:

- **which batch size**: the largest operating point the backlog can fill
  (idle: B1, no batching tax; loaded: the largest, most throughput), never
  one whose device time alone busts the SLO;
- **whether to admit**: the predicted fair-share queue wait plus device
  time against the SLO budget (shrunk while the stall detector says the
  system is degraded: shed at the door instead of serving everyone late).

The table is seeded by the caller (on the card: the times measured there)
and refined online: each dispatch's measured wall time feeds an EWMA a
batch size, so the policy follows the machine it runs on.

Threading: the EWMA table has one writer (the gateway's dispatch loop);
readers see whole float values, so the policy holds no lock of its own;
the gateway's lock orders the decisions that matter.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

# (batch, device_ms): the JAX package's default table, figures of its own
# reference device, kept so both packages decide alike when no table is
# given; a caller on the card seeds the times measured there, and the
# online EWMA refines every point.
DEFAULT_OPERATING_POINTS: Tuple[Tuple[int, float], ...] = (
    (1, 0.89),
    (2, 1.43),
    (4, 2.45),
    (8, 4.33),
)


class SloPolicy:
    """Batch-size choice + admission arithmetic under a p99 latency SLO.

    ``slo_ms`` is the end-to-end (admission -> dispatch-complete) p99
    target for ADMITTED work. ``shed_margin`` is the fraction of that
    budget admission may fill (headroom for prediction error);
    ``degraded_margin`` replaces it while the gateway is escalated by
    the stall detector — a smaller budget sheds more at the door, which
    is the point: shed loudly instead of serving everyone late.
    """

    def __init__(
        self,
        slo_ms: float = 25.0,
        operating_points: Optional[Sequence[Tuple[int, float]]] = None,
        shed_margin: float = 0.9,
        degraded_margin: float = 0.5,
        ewma: float = 0.2,
    ):
        pts = sorted(operating_points or DEFAULT_OPERATING_POINTS)
        if not pts:
            raise ValueError("need at least one (batch, device_ms) point")
        self._service_ms: Dict[int, float] = {}
        last_b = 0
        for b, ms in pts:
            b = int(b)
            if b <= last_b:
                raise ValueError(f"batch sizes must be ascending, got {pts}")
            if ms <= 0:
                raise ValueError(f"device_ms must be positive, got {ms}")
            self._service_ms[b] = float(ms)
            last_b = b
        self._batches = sorted(self._service_ms)
        if slo_ms <= 0:
            raise ValueError("slo_ms must be positive")
        if not 0 < degraded_margin <= shed_margin <= 1.0:
            raise ValueError(
                "want 0 < degraded_margin <= shed_margin <= 1.0, got "
                f"{degraded_margin}/{shed_margin}"
            )
        self.slo_ms = float(slo_ms)
        self.shed_margin = float(shed_margin)
        self.degraded_margin = float(degraded_margin)
        self._ewma = float(ewma)

    # -- the frontier ------------------------------------------------------
    @property
    def max_batch(self) -> int:
        return self._batches[-1]

    @property
    def min_batch(self) -> int:
        return self._batches[0]

    def batch_sizes(self) -> Tuple[int, ...]:
        return tuple(self._batches)

    def _fit(self, n: int) -> int:
        """Smallest operating point that can carry ``n`` frames (padded),
        the largest point when ``n`` exceeds them all."""
        for b in self._batches:
            if b >= n:
                return b
        return self._batches[-1]

    def service_ms(self, batch: int) -> float:
        """Device time for a dispatch carrying ``batch`` frames (the
        operating point it pads up to)."""
        return self._service_ms[self._fit(max(1, batch))]

    def per_frame_ms(self, batch: int) -> float:
        b = self._fit(max(1, batch))
        return self._service_ms[b] / b

    def capacity_fps(self) -> float:
        """Best sustained throughput on the frontier (the largest
        point's, unless the EWMA has learned otherwise)."""
        return max(b / ms * 1000.0 for b, ms in self._service_ms.items())

    # -- decisions ---------------------------------------------------------
    def choose_batch(self, backlog: int) -> int:
        """Largest operating point the backlog can fill — B1 when idle
        (latency), the largest under load (throughput) — stepping down if a
        point's device time ALONE exceeds the SLO (a misconfigured
        table must not admit work it can never serve in time)."""
        want = max(1, int(backlog))
        chosen = self._batches[0]
        for b in self._batches:
            if b <= want and self._service_ms[b] <= self.slo_ms:
                chosen = b
        return chosen

    def budget_ms(self, degraded: bool = False) -> float:
        """The admission budget: how much predicted sojourn a new frame
        may carry and still be admitted."""
        return self.slo_ms * (
            self.degraded_margin if degraded else self.shed_margin
        )

    def predict_sojourn_ms(
        self, queue_len: int, weight: int, active_weight_total: int
    ) -> float:
        """Queue wait + device time a frame admitted NOW would see — the
        admission estimate.

        Batch-quantized: the frame completes when its BATCH completes,
        so it waits ``ceil(position / B)`` dispatches of its own tenant,
        each costing the max operating point, interleaved per the WDRR
        share ``weight / active_weight_total``.

        ``active_weight_total`` is where the measured per-tenant arrival
        rates enter: the gateway sums the weights of every tenant that is
        backlogged or offering at a live rate. A tenant whose queue is
        empty for the moment but whose offered rate is hot will take its
        WDRR turns during this frame's wait; an estimate from the backlog
        alone would under-predict by that tenant's share."""
        b = self.max_batch
        svc = self.service_ms(b)
        share = weight / max(weight, active_weight_total)
        batches_ahead = (queue_len + 1 + b - 1) // b
        return batches_ahead * svc / share

    def observe_service(self, batch: int, measured_ms: float) -> None:
        """Feed one dispatch's measured wall time back into the table
        (single writer: the gateway dispatch loop)."""
        if measured_ms <= 0:
            return
        b = self._fit(max(1, batch))
        cur = self._service_ms[b]
        self._service_ms[b] = cur + self._ewma * (measured_ms - cur)

    def snapshot(self) -> dict:
        return {
            "slo_ms": self.slo_ms,
            "service_ms": {
                str(b): round(ms, 4) for b, ms in self._service_ms.items()
            },
            "capacity_fps": round(self.capacity_fps(), 1),
        }
