"""Aggregation kinds of the cluster metrics plane (counterpart of the
first part of ``ray_tpu/obs/telemetry.py``).

A metric declares how it aggregates across reporters (``sum`` / ``max``
/ ``merge``), so a telemetry store needs no imports of the instrumented
modules. Only the declaration helpers are here; the reporter and the
store (``TelemetryReporter`` / ``TelemetryStore``) ship snapshots to the
cluster's control store and wait for the cluster runtime (ROADMAP.md
Queue 1, B8).
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram, _fq

AGG_SUM = "sum"      # cluster value = sum over reporters (capacity, totals)
AGG_MAX = "max"      # cluster value = max over reporters (worst-case view)
AGG_MERGE = "merge"  # histograms: bucket-wise vector addition
VALID_AGGREGATIONS = frozenset({AGG_SUM, AGG_MAX, AGG_MERGE})

_AGGREGATIONS: dict[str, str] = {}


def declare_aggregation(name: str, kind: str) -> None:
    """Declare how a metric aggregates across reporters (names qualified
    as the registry qualifies them)."""
    if kind not in VALID_AGGREGATIONS:
        raise ValueError(
            f"aggregation kind {kind!r} not in {sorted(VALID_AGGREGATIONS)}"
        )
    _AGGREGATIONS[_fq(name)] = kind


def aggregation_kind(name: str, metric_type: Optional[str] = None) -> Optional[str]:
    """The declared kind, else the per-type default: counters sum,
    histograms merge; gauges have none (sum or max is the owner's call)."""
    k = _AGGREGATIONS.get(_fq(name))
    if k is not None:
        return k
    if metric_type == "counter":
        return AGG_SUM
    if metric_type == "histogram":
        return AGG_MERGE
    return None


def cluster_counter(name: str, description: str = "",
                    tag_keys: Optional[tuple] = None,
                    agg: str = AGG_SUM) -> Counter:
    declare_aggregation(name, agg)
    return Counter(name, description=description, tag_keys=tag_keys)


def cluster_gauge(name: str, description: str = "",
                  tag_keys: Optional[tuple] = None,
                  agg: str = AGG_SUM) -> Gauge:
    declare_aggregation(name, agg)
    return Gauge(name, description=description, tag_keys=tag_keys)


def cluster_histogram(name: str, description: str = "",
                      boundaries: Optional[list] = None,
                      tag_keys: Optional[tuple] = None) -> Histogram:
    declare_aggregation(name, AGG_MERGE)
    return Histogram(name, description=description, boundaries=boundaries,
                     tag_keys=tag_keys)
