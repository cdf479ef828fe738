"""Autoscaler observability: the ``ray_tpu_autoscale_`` series
(counterpart of ``ray_tpu/autoscale/metrics.py``, same names,
descriptions, tags, boundaries and aggregation kinds).

Built per call like ``obs/slo.py``; ``register_metrics`` forces
registration for the registry parity checks. Only the cold start records
today; the controller's series wait for the controller (ROADMAP.md Queue 1,
item 6, part 8).
"""

from __future__ import annotations

from ray_tpu_torch.obs.telemetry import (
    AGG_MAX,
    cluster_counter,
    cluster_gauge,
    cluster_histogram,
)
from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

# cold starts are dominated by engine bring-up + one fabric weight
# stream: sub-second for tiny models, tens of seconds at size
_COLD_START_BOUNDARIES = [0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120, 300]


def decisions_counter() -> Counter:
    return cluster_counter(
        "autoscale_decisions_total",
        description="autoscaler decisions by pool and action "
        "(hold / scale_up / scale_down / scale_to_zero / cold_start)",
        tag_keys=("pool", "action"),
    )


def scale_ups_counter() -> Counter:
    return cluster_counter(
        "autoscale_scale_ups_total",
        description="scale-up actions applied (cold starts included), "
        "by pool",
        tag_keys=("pool",),
    )


def scale_downs_counter() -> Counter:
    return cluster_counter(
        "autoscale_scale_downs_total",
        description="scale-down actions applied (always via graceful "
        "drain; scale-to-zero included), by pool",
        tag_keys=("pool",),
    )


def holds_counter() -> Counter:
    return cluster_counter(
        "autoscale_holds_total",
        description="ticks the controller explicitly held, by cause "
        "(gcs_dark / hysteresis / cooldown / steady)",
        tag_keys=("cause",),
    )


def cold_start_histogram() -> Histogram:
    return cluster_histogram(
        "autoscale_cold_start_seconds",
        description="seconds from cold-start decision to a replica "
        "serving with fabric-streamed weights (no checkpoint path)",
        boundaries=_COLD_START_BOUNDARIES,
        tag_keys=("pool",),
    )


def pool_target_gauge() -> Gauge:
    return cluster_gauge(
        "autoscale_pool_target",
        description="the controller's current desired replica count "
        "per pool",
        tag_keys=("pool",),
    )


def gcs_dark_gauge() -> Gauge:
    return cluster_gauge(
        "autoscale_gcs_dark",
        description="1 while the controller cannot fetch fresh signals "
        "from the GCS (decisions degrade to HOLD), else 0",
        agg=AGG_MAX,
    )


def register_metrics() -> None:
    """Force the autoscaler's metrics to register and their aggregation
    kinds to be declared."""
    decisions_counter()
    scale_ups_counter()
    scale_downs_counter()
    holds_counter()
    cold_start_histogram()
    pool_target_gauge()
    gcs_dark_gauge()
