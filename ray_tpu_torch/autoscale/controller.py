"""PoolAutoscaler: the SLO closed loop (counterpart of
``ray_tpu/autoscale/controller.py``).

One daemon loop per cluster: fetch the GCS signal rollup (ONE
``autoscale_signals`` RPC — per-model SLO grades + ``autoscaler_hints``,
pool rollups, queue depth, the measured prefill-span distribution, and
the pending lease demand), map it to per-pool ``PoolSignals``, run the
pure decision ladder, and drive the actuator. The hint mapping is applied
verbatim: TTFT prices the prefill pool, TPOT the decode pool, queue-wait
overall capacity (attributed to decode, where admission lives).

Failure posture: any fetch failure — connection refused, STALL_GCS
chaos, a blacked-out GCS — degrades every pool to HOLD for the tick
(``gcs_dark``), and the policy resets its streaks so recovery must
re-earn consecutive evidence before acting. A telemetry blackout can
never trigger a scale action.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.autoscale import metrics as as_metrics
from ray_tpu_torch.autoscale.config import AutoscaleConfig, POOL_DECODE, POOL_PREFILL
from ray_tpu_torch.autoscale.policy import (
    ACTION_COLD_START,
    ACTION_SCALE_DOWN,
    ACTION_SCALE_TO_ZERO,
    ACTION_SCALE_UP,
    GRADE_NO_DATA,
    Decision,
    PoolPolicy,
    PoolSignals,
)
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.autoscale.controller")

_GRADE_ORDER = {"no_data": 0, "green": 1, "yellow": 2, "red": 3}

_UP_ACTIONS = (ACTION_SCALE_UP, ACTION_COLD_START)
_DOWN_ACTIONS = (ACTION_SCALE_DOWN, ACTION_SCALE_TO_ZERO)


def _worst(*grades: str) -> str:
    out = GRADE_NO_DATA
    for g in grades:
        if _GRADE_ORDER.get(g, 0) > _GRADE_ORDER.get(out, 0):
            out = g
    return out


def signals_from_payload(
    payload: dict, pools: tuple = (POOL_PREFILL, POOL_DECODE)
) -> Dict[str, PoolSignals]:
    """Map one ``autoscale_signals`` GCS payload to per-pool signals,
    merging across model tags (worst grade wins, any tag's hint
    breaches)."""
    slo = (payload.get("slo") or {}).get("model_tags") or {}
    rollup = payload.get("pools") or {}
    util = payload.get("utilization") or {}
    span = payload.get("prefill_span") or {}
    pending = int(payload.get("pending_demand") or 0)
    queue_depth = float(util.get("queue_depth") or 0.0)
    arrival = float(span.get("arrival_rate_per_s") or 0.0)

    breach = {POOL_PREFILL: False, POOL_DECODE: False}
    grade = {POOL_PREFILL: GRADE_NO_DATA, POOL_DECODE: GRADE_NO_DATA}
    for entry in slo.values():
        hints = entry.get("autoscaler_hints") or {}
        if hints.get("scale_prefill"):
            breach[POOL_PREFILL] = True
        if hints.get("scale_decode") or hints.get("shed_or_add_capacity"):
            breach[POOL_DECODE] = True
        grade[POOL_PREFILL] = _worst(
            grade[POOL_PREFILL], (entry.get("ttft") or {}).get("grade", GRADE_NO_DATA)
        )
        grade[POOL_DECODE] = _worst(
            grade[POOL_DECODE],
            (entry.get("tpot") or {}).get("grade", GRADE_NO_DATA),
            (entry.get("queue_wait") or {}).get("grade", GRADE_NO_DATA),
        )

    out: Dict[str, PoolSignals] = {}
    for pool in pools:
        pr = rollup.get(pool) or {}
        out[pool] = PoolSignals(
            grade=grade.get(pool, GRADE_NO_DATA),
            breach=breach.get(pool, False),
            queue_depth=queue_depth,
            arrival_rate_per_s=arrival,
            span_mean_s=(
                span.get("mean_s") if pool == POOL_PREFILL else None
            ),
            running=int(pr.get("replicas_running") or 0),
            target=(
                int(pr["replicas_target"])
                if pr.get("replicas_target") is not None else None
            ),
            pending_demand=pending,
        )
    return out


def _hold_cause(reason: str) -> str:
    if "gcs-dark" in reason:
        return "gcs_dark"
    if "cooldown" in reason:
        return "cooldown"
    if "streak" in reason or "idle" in reason:
        return "hysteresis"
    return "steady"


class PoolAutoscaler:
    """The closed-loop controller.

    ``gcs``: anything with ``.call(method, payload, timeout=...)`` (an
    RpcClient / ReconnectingRpcClient — the STALL_GCS chaos hook on
    ``gcs.call`` covers every fetch); alternatively pass
    ``fetch_signals`` directly (benches running against an in-process
    TelemetryStore). ``actuator``: a ``PoolActuator``; its
    ``pool_state()`` is authoritative for running/target counts when it
    tracks the pools itself."""

    def __init__(
        self,
        config: AutoscaleConfig,
        actuator: Any,
        gcs: Any = None,
        fetch_signals: Optional[Callable[[], dict]] = None,
        thresholds: Optional[dict] = None,
        rpc_timeout_s: float = 5.0,
        log_len: int = 256,
    ):
        if gcs is None and fetch_signals is None:
            raise ValueError("PoolAutoscaler needs a gcs client or fetch_signals")
        self.config = config
        self.actuator = actuator
        self._gcs = gcs
        self._fetch = fetch_signals
        self._thresholds = dict(thresholds or {})
        self._rpc_timeout_s = rpc_timeout_s
        self.policy = PoolPolicy(config)
        self._lock = threading.Lock()
        self._log: deque = deque(maxlen=log_len)
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.num_ticks = 0
        self.num_dark_ticks = 0
        self.num_scale_actions = 0
        self.gcs_dark = False

    # -- signal plane ---------------------------------------------------------

    def fetch_signals(self) -> dict:
        if self._fetch is not None:
            return self._fetch()
        return self._gcs.call(
            "autoscale_signals",
            {"thresholds": self._thresholds} if self._thresholds else {},
            timeout=self._rpc_timeout_s,
        )

    def _signals_dark(self, payload: dict) -> bool:
        """Fresh-enough check: reporters exist but ALL are staler than
        the window -> the fleet is partitioned from the GCS; grades built
        from that snapshot are history, not state."""
        staleness = payload.get("staleness") or {}
        if not staleness:
            return False
        vals = [v for v in staleness.values() if v is not None]
        return bool(vals) and min(vals) > self.config.max_signal_age_s

    # -- one tick -------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> Dict[str, Decision]:
        now = time.monotonic() if now is None else now
        payload: dict = {}
        dark = False
        try:
            payload = self.fetch_signals()
            dark = self._signals_dark(payload)
        except Exception as e:  # noqa: BLE001 — any fetch failure = dark
            dark = True
            logger.warning("signal fetch failed (holding): %s", e)
        self.gcs_dark = dark
        self.num_ticks += 1
        if dark:
            self.num_dark_ticks += 1

        pools = tuple(self.config.pools)
        sigs = signals_from_payload(payload, pools) if not dark else {
            p: PoolSignals() for p in pools
        }
        # the actuator's own view of running/target wins when present
        # (an in-process pool has no GCS rollup)
        try:
            state = self.actuator.pool_state() or {}
        except Exception:  # noqa: BLE001
            state = {}
        for pool, st in state.items():
            if pool in sigs:
                sigs[pool].running = int(st.get("replicas_running", 0))
                sigs[pool].target = int(st.get("replicas_target", 0))

        decisions: Dict[str, Decision] = {}
        for pool in pools:
            d = self.policy.decide(pool, sigs[pool], now, gcs_dark=dark)
            decisions[pool] = d
            self._record(d, sigs[pool], now, dark)
            if d.is_scale_action:
                self.num_scale_actions += 1
                try:
                    self.actuator.apply(d)
                except Exception:
                    logger.exception(
                        "actuator failed applying %s on %s", d.action, pool
                    )
        return decisions

    def _record(self, d: Decision, sig: PoolSignals, now: float,
                dark: bool) -> None:
        try:
            as_metrics.decisions_counter().inc(
                tags={"pool": d.pool, "action": d.action}
            )
            if d.action in _UP_ACTIONS:
                as_metrics.scale_ups_counter().inc(tags={"pool": d.pool})
            elif d.action in _DOWN_ACTIONS:
                as_metrics.scale_downs_counter().inc(tags={"pool": d.pool})
            else:
                as_metrics.holds_counter().inc(
                    tags={"cause": _hold_cause(d.reason)}
                )
            if d.target is not None:
                as_metrics.pool_target_gauge().set(
                    d.target, tags={"pool": d.pool}
                )
            as_metrics.gcs_dark_gauge().set(1.0 if dark else 0.0)
        except Exception:  # noqa: BLE001 — observability must not break the loop
            pass
        with self._lock:
            self._log.append({
                "t": now,
                "pool": d.pool,
                "action": d.action,
                "target": d.target,
                "reason": d.reason,
                "gcs_dark": dark,
                "grade": sig.grade,
            })
        if d.is_scale_action:
            logger.info("%s: %s -> %s (%s)", d.pool, d.action, d.target,
                        d.reason)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "PoolAutoscaler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="ray_tpu_torch-pool-autoscaler", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop_evt.wait(self.config.interval_s):
            try:
                self.tick()
            except Exception:
                logger.exception("autoscaler tick failed")

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- introspection --------------------------------------------------------

    def decision_log(self) -> list:
        with self._lock:
            return list(self._log)

    def status(self) -> dict:
        try:
            pools = self.actuator.pool_state()
        except Exception:  # noqa: BLE001
            pools = {}
        recent = self.decision_log()[-len(self.config.pools):]
        return {
            "pools": pools,
            "gcs_dark": self.gcs_dark,
            "num_ticks": self.num_ticks,
            "num_dark_ticks": self.num_dark_ticks,
            "num_scale_actions": self.num_scale_actions,
            "recent_decisions": recent,
        }
