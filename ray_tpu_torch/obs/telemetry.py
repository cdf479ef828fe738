"""Aggregation kinds of the cluster metrics plane (counterpart of the
first part of ``ray_tpu/obs/telemetry.py``).

A metric declares how it aggregates across reporters (``sum`` / ``max``
/ ``merge``), so a telemetry store needs no imports of the instrumented
modules. Here are the declaration helpers and the SLO grading
(``SLOThresholds``, ``grade_value``, ``evaluate_slo`` over merged TTFT,
TPOT and queue-wait histograms: the fleet's canary ladder grades a
replica with it, counterpart of ``ray_tpu/obs/telemetry.py:153-295``).
The reporter and the store (``TelemetryReporter`` / ``TelemetryStore``)
ship snapshots to the cluster's control store and wait for the cluster
runtime (ROADMAP.md Queue 1, B8).
"""

from __future__ import annotations

import dataclasses
import math
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


# -- SLO evaluation -----------------------------------------------------------


def bucket_percentile(boundaries: list, buckets: list, q: float) -> Optional[float]:
    """Nearest-rank percentile estimate from a bucket vector: the UPPER
    boundary of the bucket holding the rank-q observation (the +Inf bucket
    reports the last finite boundary, the best known lower bound)."""
    total = sum(buckets)
    if total <= 0:
        return None
    rank = max(1, math.ceil(q / 100.0 * total))
    cum = 0
    for i, n in enumerate(buckets):
        cum += n
        if cum >= rank:
            return float(boundaries[i]) if i < len(boundaries) else float(boundaries[-1])
    return float(boundaries[-1])


GRADE_GREEN = "green"
GRADE_YELLOW = "yellow"
GRADE_RED = "red"
GRADE_NO_DATA = "no_data"
_GRADE_ORDER = {GRADE_NO_DATA: 0, GRADE_GREEN: 1, GRADE_YELLOW: 2, GRADE_RED: 3}

# the three merged histograms the evaluator grades, by registry name
SLO_HISTOGRAMS = {
    "ttft": _fq("llm_ttft_seconds"),
    "tpot": _fq("llm_tpot_seconds"),
    "queue_wait": _fq("llm_queue_wait_seconds"),
}


@dataclasses.dataclass
class SLOThresholds:
    """Green thresholds at ``percentile``; yellow up to ``yellow_factor`` x
    threshold, red beyond. Defaults sized for a CPU smoke model; a serving
    deployment passes its own."""

    ttft_p_s: float = 2.0
    tpot_p_s: float = 0.2
    queue_wait_p_s: float = 1.0
    percentile: float = 95.0
    yellow_factor: float = 2.0
    min_count: int = 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "SLOThresholds":
        if not d:
            return cls()
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def grade_value(value: Optional[float], threshold: float, yellow_factor: float) -> str:
    if value is None:
        return GRADE_NO_DATA
    if value <= threshold:
        return GRADE_GREEN
    if value <= threshold * yellow_factor:
        return GRADE_YELLOW
    return GRADE_RED


def evaluate_slo(histograms: dict, thresholds: Optional[SLOThresholds] = None) -> dict:
    """Grade every model tag from merged SLO histograms.

    ``histograms``: {registry_name: {model_tag: {"boundaries", "buckets",
    "sum", "count"}}}. Per tag: each signal's count, percentile, p50,
    threshold and grade, the worst grade, and which pool a breached signal
    points at (TTFT the prefill pool, TPOT the decode pool, queue wait
    admission)."""
    th = thresholds or SLOThresholds()
    limits = {"ttft": th.ttft_p_s, "tpot": th.tpot_p_s, "queue_wait": th.queue_wait_p_s}
    tags: set = set()
    for name in SLO_HISTOGRAMS.values():
        tags.update((histograms.get(name) or {}).keys())
    out: dict = {"thresholds": th.to_dict(), "model_tags": {}}
    for tag in sorted(tags):
        entry: dict = {}
        worst = GRADE_NO_DATA
        for short, name in SLO_HISTOGRAMS.items():
            h = (histograms.get(name) or {}).get(tag)
            count = int(h["count"]) if h else 0
            p = None
            if h and count >= th.min_count:
                p = bucket_percentile(h["boundaries"], h["buckets"], th.percentile)
            g = grade_value(p, limits[short], th.yellow_factor)
            entry[short] = {
                "count": count,
                f"p{th.percentile:g}": p,
                "p50": bucket_percentile(h["boundaries"], h["buckets"], 50.0) if h else None,
                "threshold_s": limits[short],
                "grade": g,
            }
            if _GRADE_ORDER[g] > _GRADE_ORDER[worst]:
                worst = g
        entry["grade"] = worst
        entry["autoscaler_hints"] = {
            "scale_prefill": entry["ttft"]["grade"] in (GRADE_YELLOW, GRADE_RED),
            "scale_decode": entry["tpot"]["grade"] in (GRADE_YELLOW, GRADE_RED),
            "shed_or_add_capacity": entry["queue_wait"]["grade"] in (GRADE_YELLOW, GRADE_RED),
        }
        out["model_tags"][tag] = entry
    return out
