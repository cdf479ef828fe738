"""Jittered exponential backoff, the one retry-delay policy (a copy of
``ray_tpu/util/backoff.py``; ``cluster/rpc.py`` dials with it).

A fixed retry sleep turns N waiting callers into a synchronized herd: all
of them re-poll in the same tick, serialize on the server, fail together
and sleep in phase again. Exponential growth spreads the re-polls over
time, jitter decorrelates the herd, and the cap bounds the worst-case
added latency.
"""

from __future__ import annotations

import random
import time
from typing import Optional


class ExponentialBackoff:
    """Iterative jittered-exponential delay source.

    ``next_delay()`` returns ``base * multiplier**n`` capped at ``cap``,
    scattered uniformly over ``[(1 - jitter) * d, d]`` (full-ish jitter:
    never longer than the deterministic ladder, so worst-case retry
    latency stays the un-jittered bound). A seeded ``rng`` makes the
    sequence reproducible (chaos tests); the default shares the module
    RNG."""

    def __init__(
        self,
        base: float = 0.05,
        cap: float = 2.0,
        multiplier: float = 2.0,
        jitter: float = 0.5,
        rng: Optional[random.Random] = None,
    ):
        if base <= 0:
            raise ValueError("base must be > 0")
        if cap < base:
            raise ValueError("cap must be >= base")
        if multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")
        if not (0.0 <= jitter <= 1.0):
            raise ValueError("jitter must be in [0, 1]")
        self.base = base
        self.cap = cap
        self.multiplier = multiplier
        self.jitter = jitter
        self._rng = rng
        self._attempt = 0

    @property
    def attempt(self) -> int:
        return self._attempt

    def reset(self) -> None:
        self._attempt = 0

    def next_delay(self) -> float:
        d = min(self.cap, self.base * (self.multiplier ** self._attempt))
        self._attempt += 1
        if self.jitter > 0.0:
            lo = d * (1.0 - self.jitter)
            r = self._rng.random() if self._rng is not None else random.random()
            d = lo + (d - lo) * r
        return d

    def sleep(self, floor: float = 0.0) -> float:
        """Sleep the next jittered delay, never less than ``floor`` (a
        server-provided retry_after hint wins over a smaller ladder
        rung). Returns the slept duration."""
        d = max(float(floor), self.next_delay())
        time.sleep(d)
        return d
