"""Exponential backoff with jitter: the producer's backpressure policy.

The port's copy of ``psana_ray_tpu/transport/backoff.py``, with the
reference's envelope: base 0.1 s, cap 2.0 s, uniform jitter in [0, 0.5) s,
and the retry counter frozen once the cap is reached."""

from __future__ import annotations

import random
import time
from typing import Callable, Optional


class BackoffPolicy:
    def __init__(
        self,
        base_s: float = 0.1,
        cap_s: float = 2.0,
        jitter_s: float = 0.5,
        sleep: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
    ):
        self.base_s = base_s
        self.cap_s = cap_s
        self.jitter_s = jitter_s
        self._sleep = sleep
        self._rng = rng or random.Random()
        self._retries = 0

    def delay(self) -> float:
        """The next delay, without sleeping."""
        d = min(self.cap_s, self.base_s * (2**self._retries))
        return d + self._rng.uniform(0, self.jitter_s)

    def wait(self) -> float:
        """Sleep the next delay and advance the counter; returns the delay."""
        d = self.delay()
        self._sleep(d)
        if self.base_s * (2**self._retries) < self.cap_s:  # frozen once capped
            self._retries += 1
        return d

    def reset(self):
        self._retries = 0

    @property
    def retries(self) -> int:
        return self._retries
