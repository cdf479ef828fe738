"""Process-wide metrics: Counter / Gauge / Histogram and the Prometheus
export (counterpart of ``ray_tpu/util/metrics.py``).

One registry for this package, separate from the reference's even in a
process that imports both. Names, types, tag keys and histogram
boundaries follow the reference's, so the two packages' Prometheus texts
compare line for line. ``snapshot_meta`` is the restart-detection header
``/v1/stats`` carries; ``snapshot_registry`` the serializable snapshot the
telemetry plane (``obs/telemetry.py``) ships to the GCS.
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from bisect import bisect_right
from typing import Callable, Optional, Sequence

_REGISTRY_LOCK = threading.Lock()
_REGISTRY: dict[str, "Metric"] = {}

# Process-epoch id: a restarted process re-registers every counter at 0, so
# a consumer can tell "the counter went backwards" from "the process
# restarted".
PROCESS_EPOCH = uuid.uuid4().hex[:12]

# Monotonic per-process snapshot sequence: a consumer can ignore a delayed
# or re-ordered snapshot without comparing wall clocks.
_SNAPSHOT_SEQ = itertools.count(1)

DEFAULT_HISTOGRAM_BOUNDARIES = [
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 50, 100,
]


def _fq(name: str) -> str:
    return name if name.startswith("ray_tpu_") else f"ray_tpu_{name}"


class Metric:
    """Named metric with optional tag keys; one time series per observed
    tag-value combination. A second instance of the same name and type
    shares the first one's storage."""

    TYPE = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not name:
            raise ValueError("metric name required")
        self.name = _fq(name)
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self._series: dict[tuple, float] = {}
        self._lock = threading.Lock()
        with _REGISTRY_LOCK:
            existing = _REGISTRY.get(self.name)
            if existing is not None:
                if existing.TYPE != self.TYPE:
                    raise ValueError(
                        f"metric {self.name!r} already registered as {existing.TYPE}"
                    )
                self._series = existing._series
                self._lock = existing._lock
                if isinstance(self, Histogram):
                    self._buckets = existing._buckets
                    self._sums = existing._sums
                    self._counts = existing._counts
                    self.boundaries = existing.boundaries
                return
            _REGISTRY[self.name] = self

    def _key(self, tags: Optional[dict]) -> tuple:
        tags = tags or {}
        unknown = set(tags) - set(self.tag_keys)
        if unknown:
            raise ValueError(f"unknown tag keys: {sorted(unknown)}")
        return tuple(tags.get(k, "") for k in self.tag_keys)

    def series(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._series)

    def remove_series(self, tags: Optional[dict] = None) -> None:
        """Retract one tag combination entirely: a gauge of a deleted
        entity (a Serve deployment's replica count) must not go on
        exporting its last value."""
        k = self._key(tags)
        with self._lock:
            self._series.pop(k, None)
            if isinstance(self, Histogram):
                self._buckets.pop(k, None)
                self._sums.pop(k, None)
                self._counts.pop(k, None)


class Counter(Metric):
    TYPE = "counter"

    def inc(self, value: float = 1.0, tags: Optional[dict] = None) -> None:
        if value < 0:
            raise ValueError("counters only increase")
        k = self._key(tags)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + value


class Gauge(Metric):
    TYPE = "gauge"

    def set(self, value: float, tags: Optional[dict] = None) -> None:
        k = self._key(tags)
        with self._lock:
            self._series[k] = float(value)

    def inc(self, value: float = 1.0, tags: Optional[dict] = None) -> None:
        k = self._key(tags)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + value

    def dec(self, value: float = 1.0, tags: Optional[dict] = None) -> None:
        self.inc(-value, tags)


class Histogram(Metric):
    TYPE = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Optional[Sequence[str]] = None):
        # set before Metric.__init__: its same-name branch replaces these
        # with the registered instance's storage
        self.boundaries = sorted(boundaries or DEFAULT_HISTOGRAM_BOUNDARIES)
        self._buckets: dict[tuple, list] = {}
        self._sums: dict[tuple, float] = {}
        self._counts: dict[tuple, int] = {}
        super().__init__(name, description, tag_keys)

    def observe(self, value: float, tags: Optional[dict] = None) -> None:
        k = self._key(tags)
        with self._lock:
            buckets = self._buckets.setdefault(k, [0] * (len(self.boundaries) + 1))
            buckets[bisect_right(self.boundaries, value)] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._counts[k] = self._counts.get(k, 0) + 1

    def hist_data(self) -> dict:
        """tags tuple -> (bucket counts, sum, count); the last bucket is +Inf."""
        with self._lock:
            return {
                k: (list(b), self._sums.get(k, 0.0), self._counts.get(k, 0))
                for k, b in self._buckets.items()
            }


def registry_snapshot() -> list[Metric]:
    with _REGISTRY_LOCK:
        return list(_REGISTRY.values())


def snapshot_meta() -> dict:
    """Timestamp + epoch header of a snapshot: ``ts_monotonic`` orders one
    process's snapshots, ``ts_wall`` places them on a timeline, ``epoch``
    detects process restarts, ``seq`` re-ordered or duplicated ones."""
    return {
        "epoch": PROCESS_EPOCH,
        "seq": next(_SNAPSHOT_SEQ),
        "ts_monotonic": time.monotonic(),
        "ts_wall": time.time(),
    }


def snapshot_registry(series_filter: Optional[Callable[[str, dict], bool]] = None) -> dict:
    """Serializable point-in-time snapshot of the whole registry: counters
    as monotonic totals, histograms as full bucket vectors, so a consumer
    that misses snapshots loses freshness, never counts.
    ``series_filter(name, tags_dict) -> bool`` narrows it to the series a
    reporter owns (a node daemon ships only its own node's gauges)."""
    out = snapshot_meta()
    out["metrics"] = []
    for m in registry_snapshot():
        entry: dict = {
            "name": m.name,
            "type": m.TYPE,
            "description": m.description,
            "tag_keys": list(m.tag_keys),
        }
        series: list[dict] = []
        if isinstance(m, Histogram):
            entry["boundaries"] = list(m.boundaries)
            for k, (buckets, total, count) in m.hist_data().items():
                if series_filter is not None and not series_filter(m.name, dict(zip(m.tag_keys, k))):
                    continue
                series.append({"tags": list(k), "buckets": list(buckets),
                               "sum": total, "count": count})
        else:
            for k, v in m.series().items():
                if series_filter is not None and not series_filter(m.name, dict(zip(m.tag_keys, k))):
                    continue
                series.append({"tags": list(k), "value": v})
        if series:
            entry["series"] = series
            out["metrics"].append(entry)
    return out


def clear_registry() -> None:
    """Test hook."""
    with _REGISTRY_LOCK:
        _REGISTRY.clear()


def _escape_label_value(v) -> str:
    """Prometheus exposition escaping: backslash, double quote and newline,
    else one tag value corrupts every line after it in the scrape."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_tags(keys: Sequence[str], vals: tuple, extra: str = "") -> str:
    # empty values are emitted (`k=""`), so a series tagged {model: ""}
    # never collides with an untagged sibling
    parts = [f'{k}="{_escape_label_value(v)}"' for k, v in zip(keys, vals)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_text() -> str:
    """Render the whole registry in the Prometheus exposition format."""
    lines = []
    for m in registry_snapshot():
        lines.append(f"# HELP {m.name} {m.description}")
        lines.append(f"# TYPE {m.name} {m.TYPE}")
        if isinstance(m, Histogram):
            for k, (buckets, total, count) in m.hist_data().items():
                cum = 0
                for b, n in zip(m.boundaries, buckets):
                    cum += n
                    le = f'le="{b}"'
                    lines.append(f"{m.name}_bucket{_fmt_tags(m.tag_keys, k, le)} {cum}")
                cum += buckets[-1]
                le_inf = 'le="+Inf"'
                lines.append(f"{m.name}_bucket{_fmt_tags(m.tag_keys, k, le_inf)} {cum}")
                lines.append(f"{m.name}_sum{_fmt_tags(m.tag_keys, k)} {total}")
                lines.append(f"{m.name}_count{_fmt_tags(m.tag_keys, k)} {count}")
        else:
            for k, v in m.series().items():
                lines.append(f"{m.name}{_fmt_tags(m.tag_keys, k)} {v}")
    return "\n".join(lines) + "\n"
