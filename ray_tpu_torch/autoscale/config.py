"""Configuration for the SLO closed-loop pool autoscaler (counterpart of
``ray_tpu/autoscale/config.py``).

One config object covers the whole loop: per-pool replica bounds, the
hysteresis windows that keep a yellow blip from flapping the pool, the
cooldowns that space consecutive actions, and the prefill-sizing target
utilization. Everything is plain data — the policy consuming it is a
pure function of (signals, config, clock), so every window is unit-
testable without a cluster.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

# Canonical pool names: match the serve controller's role tags and the
# telemetry plane's autoscaler_hints mapping (TTFT -> prefill, TPOT -> decode).
POOL_PREFILL = "prefill"
POOL_DECODE = "decode"


@dataclass
class PoolLimits:
    """Replica bounds for one pool.

    ``min_replicas=0`` opts the pool into scale-to-zero; a pool with a
    floor >= 1 is never drained below it regardless of idleness.
    """

    min_replicas: int = 0
    max_replicas: int = 4

    def __post_init__(self):
        if self.min_replicas < 0:
            raise ValueError("min_replicas must be >= 0")
        if self.max_replicas < max(1, self.min_replicas):
            raise ValueError("max_replicas must be >= max(1, min_replicas)")


@dataclass
class AutoscaleConfig:
    """Tuning for the PoolAutoscaler decision ladder.

    Hysteresis: a pool scales up only after ``breach_ticks`` CONSECUTIVE
    breached (yellow/red) observations and scales down only after
    ``green_ticks`` consecutive green ones — a single yellow blip, or a
    green blip in a red run, resets the opposing streak and holds.
    Cooldowns additionally space actions in wall time so the controller
    can never outrun the pool's own reaction to the last action.
    """

    pools: Dict[str, PoolLimits] = field(
        default_factory=lambda: {
            POOL_PREFILL: PoolLimits(),
            POOL_DECODE: PoolLimits(),
        }
    )
    # consecutive breached ticks before a scale-up fires
    breach_ticks: int = 2
    # consecutive green ticks before a scale-down fires
    green_ticks: int = 5
    scale_up_cooldown_s: float = 5.0
    scale_down_cooldown_s: float = 20.0
    # a zero-min pool with NO traffic and NO SLO data for this long is
    # drained to zero (cold-started back via fabric weight streaming)
    idle_to_zero_s: float = 30.0
    # prefill-pool sizing target: keep sum(arrival_rate x prefill_span)
    # per replica at this fraction of capacity (M/M/c style headroom)
    prefill_target_utilization: float = 0.6
    # replicas added/removed per decision (beyond the sized floor)
    max_step: int = 1
    # controller loop period
    interval_s: float = 1.0
    # signals older than this (GCS-side staleness) are treated as dark
    max_signal_age_s: float = 30.0

    def __post_init__(self):
        if self.breach_ticks < 1 or self.green_ticks < 1:
            raise ValueError("breach_ticks and green_ticks must be >= 1")
        if not 0.0 < self.prefill_target_utilization <= 1.0:
            raise ValueError("prefill_target_utilization must be in (0, 1]")
        if self.max_step < 1:
            raise ValueError("max_step must be >= 1")

    def limits(self, pool: str) -> PoolLimits:
        return self.pools.get(pool) or PoolLimits()
