"""Pure decision ladder for the SLO closed-loop pool autoscaler (counterpart
of ``ray_tpu/autoscale/policy.py``).

The policy is deterministic state-machine code: given one tick's
``PoolSignals`` (derived from the GCS telemetry rollup — SLO grades +
``autoscaler_hints``, queue depth, prefill-span distribution, pending
lease demand) and an explicit clock, it emits exactly one ``Decision``
per pool. No I/O, no threads, no wall clock — every hysteresis window,
cooldown, sizing rule and scale-to-zero eligibility check is unit-
testable with a hand-rolled ``now``.

Ladder order (first match wins):

1. GCS dark -> HOLD, and RESET both streaks: a telemetry blackout is
   not evidence of anything, and recovery must re-earn consecutive
   ticks before any action (no flap on recovery).
2. Pool at zero + traffic -> COLD_START (fabric weight streaming, no
   checkpoint path).
3. Breach streak >= breach_ticks (+ up-cooldown) -> SCALE_UP, with the
   prefill pool additionally floored at the span-distribution sizing.
   Breaches accumulate only while the pool has offered load — cumulative
   histograms keep a grade hot long after traffic stops, and capacity is
   never added for zero demand. The prefill sizing rule also acts as a
   FEEDFORWARD term: when the measured span distribution says the pool
   is under-provisioned for the offered load (sized > target for
   breach_ticks consecutive ticks), it scales to the sized count
   without waiting for the cumulative p95 to degrade (whose detection
   lag grows with history).
4. Zero-min pool idle past idle_to_zero_s (+ down-cooldown) ->
   SCALE_TO_ZERO (always via graceful drain).
5. Green streak >= green_ticks (+ down-cooldown) -> SCALE_DOWN, never
   below max(min_replicas, sized floor, 1-while-traffic).
6. Otherwise HOLD (with the reason telling which window is pending).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

from ray_tpu_torch.autoscale.config import AutoscaleConfig, POOL_PREFILL

# grade strings mirror ray_tpu_torch.obs.telemetry (kept literal so this
# module stays importable without the telemetry plane)
GRADE_GREEN = "green"
GRADE_YELLOW = "yellow"
GRADE_RED = "red"
GRADE_NO_DATA = "no_data"

ACTION_HOLD = "hold"
ACTION_SCALE_UP = "scale_up"
ACTION_SCALE_DOWN = "scale_down"
ACTION_SCALE_TO_ZERO = "scale_to_zero"
ACTION_COLD_START = "cold_start"

ACTIONS = (
    ACTION_HOLD,
    ACTION_SCALE_UP,
    ACTION_SCALE_DOWN,
    ACTION_SCALE_TO_ZERO,
    ACTION_COLD_START,
)


@dataclass
class PoolSignals:
    """One tick's observed state for one pool."""

    grade: str = GRADE_NO_DATA
    # the telemetry plane's autoscaler_hints flag already mapped to this pool
    # (TTFT -> prefill, TPOT / queue_wait -> decode)
    breach: bool = False
    queue_depth: float = 0.0
    arrival_rate_per_s: float = 0.0
    # measured mean prefill span (s) from the merged distribution; only
    # the prefill pool carries it
    span_mean_s: Optional[float] = None
    running: int = 0
    target: Optional[int] = None
    # parked lease specs from the seed demand feed (ONE brain: pending
    # placement-group/lease demand is an input here, not a second loop)
    pending_demand: int = 0

    @property
    def has_traffic(self) -> bool:
        return (
            self.arrival_rate_per_s > 0.0
            or self.queue_depth > 0.0
            or self.pending_demand > 0
        )


@dataclass
class Decision:
    """One pool's action for one tick. ``target`` is the new desired
    replica count for any non-HOLD action."""

    pool: str
    action: str = ACTION_HOLD
    target: Optional[int] = None
    reason: str = ""

    @property
    def is_scale_action(self) -> bool:
        return self.action != ACTION_HOLD


@dataclass
class _PoolState:
    breach_streak: int = 0
    green_streak: int = 0
    sized_streak: int = 0
    idle_since: Optional[float] = None
    last_scale_up: float = float("-inf")
    last_scale_down: float = float("-inf")


def size_prefill_pool(
    arrival_rate_per_s: float,
    span_mean_s: Optional[float],
    target_utilization: float,
    max_replicas: Optional[int] = None,
) -> Optional[int]:
    """Replicas needed so offered prefill load (arrival rate x mean
    prefill span = mean busy servers, Little's law) sits at
    ``target_utilization`` per replica. None when the distribution has
    no data yet."""
    if span_mean_s is None or span_mean_s <= 0 or arrival_rate_per_s <= 0:
        return None
    offered = arrival_rate_per_s * span_mean_s
    n = max(1, math.ceil(offered / target_utilization))
    if max_replicas is not None:
        n = min(n, max_replicas)
    return n


def span_mean_from_histogram(hist: Optional[dict]) -> Optional[float]:
    """Mean from a merged-histogram dict ({"sum", "count", ...}) as the
    telemetry plane ships them; None below one observation."""
    if not hist:
        return None
    count = int(hist.get("count") or 0)
    if count <= 0:
        return None
    return float(hist.get("sum", 0.0)) / count


class PoolPolicy:
    """Per-pool hysteresis state + the decision ladder.

    Single-threaded by design: one controller loop owns it. All time is
    the caller's ``now`` (monotonic seconds)."""

    def __init__(self, config: AutoscaleConfig):
        self.config = config
        self._state: Dict[str, _PoolState] = {}

    def state(self, pool: str) -> _PoolState:
        st = self._state.get(pool)
        if st is None:
            st = self._state[pool] = _PoolState()
        return st

    def decide(
        self,
        pool: str,
        sig: PoolSignals,
        now: float,
        *,
        gcs_dark: bool = False,
    ) -> Decision:
        cfg = self.config
        lim = cfg.limits(pool)
        st = self.state(pool)

        # 1. dark control plane: a blackout is never evidence. HOLD and
        # reset streaks so recovery must re-earn consecutive ticks.
        if gcs_dark:
            st.breach_streak = 0
            st.green_streak = 0
            st.sized_streak = 0
            st.idle_since = None
            return Decision(pool, ACTION_HOLD, reason="gcs-dark: holding")

        target = sig.target if sig.target is not None else sig.running

        # streaks: breach and green are mutually exclusive; no_data
        # resets the breach streak (no breach evidence) and freezes the
        # green streak (no green evidence either). A breach counts only
        # while the pool has offered load: grades come from CUMULATIVE
        # histograms, so a bad stretch keeps the grade hot long after
        # traffic stops — capacity is never added for zero demand.
        if sig.breach and sig.has_traffic:
            st.breach_streak += 1
            st.green_streak = 0
        elif sig.grade == GRADE_GREEN:
            st.green_streak += 1
            st.breach_streak = 0
        else:
            st.breach_streak = 0

        # idle clock for scale-to-zero: runs while the pool sees no
        # traffic (windowed arrival rate, queue depth, pending demand).
        # Grades are computed from CUMULATIVE histograms, so "grade is
        # green" only says traffic once flowed — it never goes back to
        # no_data and must not keep an idle pool warm.
        if sig.has_traffic:
            st.idle_since = None
        elif st.idle_since is None:
            st.idle_since = now

        sized = None
        if pool == POOL_PREFILL:
            sized = size_prefill_pool(
                sig.arrival_rate_per_s, sig.span_mean_s,
                cfg.prefill_target_utilization, lim.max_replicas,
            )
        if sized is not None and sized > target and sig.has_traffic:
            st.sized_streak += 1
        else:
            st.sized_streak = 0

        # 2. cold start: pool parked at zero, work has arrived
        if target <= 0 and sig.has_traffic:
            want = max(1, lim.min_replicas, sized or 0)
            st.idle_since = None
            st.last_scale_up = now
            st.breach_streak = 0
            return Decision(
                pool, ACTION_COLD_START, target=want,
                reason=f"cold-start: traffic at zero replicas -> {want}",
            )

        up_ready = now - st.last_scale_up >= cfg.scale_up_cooldown_s
        down_ready = now - st.last_scale_down >= cfg.scale_down_cooldown_s

        # 3. scale up on a sustained breach
        if st.breach_streak >= cfg.breach_ticks and target < lim.max_replicas:
            if not up_ready:
                return Decision(
                    pool, ACTION_HOLD,
                    reason="breach sustained but scale-up cooldown active",
                )
            want = min(lim.max_replicas, max(target + cfg.max_step, sized or 0))
            if want > target:
                st.last_scale_up = now
                st.breach_streak = 0
                return Decision(
                    pool, ACTION_SCALE_UP, target=want,
                    reason=f"{sig.grade} breach x{cfg.breach_ticks}: "
                           f"{target} -> {want}",
                )

        # 3b. feedforward prefill sizing: the measured span distribution
        # says the pool is under-provisioned for the offered load —
        # scale to the sized count without waiting for the SLO to
        # degrade (cumulative-p95 breach detection lags by design; the
        # sizing rule is the feedforward term, breach hysteresis the
        # feedback term).
        if (
            st.sized_streak >= cfg.breach_ticks
            and 0 < target < lim.max_replicas
            and up_ready
        ):
            want = min(lim.max_replicas, sized)
            if want > target:
                st.last_scale_up = now
                st.sized_streak = 0
                st.breach_streak = 0
                return Decision(
                    pool, ACTION_SCALE_UP, target=want,
                    reason=f"span-sized {sized} > target {target} "
                           f"x{cfg.breach_ticks}: feedforward",
                )

        # 4. scale to zero: opted-in pool idle past the window
        if (
            lim.min_replicas == 0
            and target > 0
            and st.idle_since is not None
            and now - st.idle_since >= cfg.idle_to_zero_s
        ):
            if not down_ready:
                return Decision(
                    pool, ACTION_HOLD,
                    reason="idle-to-zero ready but scale-down cooldown active",
                )
            st.last_scale_down = now
            st.green_streak = 0
            st.idle_since = None
            return Decision(
                pool, ACTION_SCALE_TO_ZERO, target=0,
                reason=f"idle {cfg.idle_to_zero_s:g}s: drain {target} -> 0",
            )

        # 5. scale down after a sustained green run — via graceful drain,
        # never below the sized floor or (while serving) one replica
        floor = max(lim.min_replicas, sized or 0, 1 if sig.has_traffic else 0)
        floor = max(floor, 1) if target > 0 else floor
        if st.green_streak >= cfg.green_ticks and target > floor:
            if not down_ready:
                return Decision(
                    pool, ACTION_HOLD,
                    reason="green sustained but scale-down cooldown active",
                )
            want = max(floor, target - cfg.max_step)
            st.last_scale_down = now
            st.green_streak = 0
            return Decision(
                pool, ACTION_SCALE_DOWN, target=want,
                reason=f"green x{cfg.green_ticks}: drain {target} -> {want}",
            )

        # 6. hold, and say which window is pending
        if sig.breach:
            why = f"breach streak {st.breach_streak}/{cfg.breach_ticks}"
        elif sig.grade == GRADE_GREEN:
            why = f"green streak {st.green_streak}/{cfg.green_ticks}"
        elif st.idle_since is not None:
            why = f"idle {now - st.idle_since:.1f}/{cfg.idle_to_zero_s:g}s"
        else:
            why = "no data"
        return Decision(pool, ACTION_HOLD, reason=why)
