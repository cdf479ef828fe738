"""Process-wide metrics (counterpart of ``ray_tpu/util/metrics.py``).

Only what the serving front end reads is here: ``Counter`` (admission's
``llm_admission_rejected_total``) on this package's own registry, which is
separate from the reference's even in a process that imports both, and
``snapshot_meta``, the restart-detection header ``/v1/stats`` carries. The
gauges, histograms and Prometheus export come with the engine metrics
(ROADMAP.md, Queue 1, B4c).
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from typing import Optional, Sequence

_REGISTRY_LOCK = threading.Lock()
_REGISTRY: dict[str, "Metric"] = {}

# Process-epoch id: a restarted process re-registers every counter at 0, so
# a consumer can tell "the counter went backwards" from "the process
# restarted".
PROCESS_EPOCH = uuid.uuid4().hex[:12]

# Monotonic per-process snapshot sequence: a consumer can ignore a delayed
# or re-ordered snapshot without comparing wall clocks.
_SNAPSHOT_SEQ = itertools.count(1)


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


class Counter(Metric):
    TYPE = "counter"

    def inc(self, value: float = 1.0, tags: Optional[dict] = None) -> None:
        if value < 0:
            raise ValueError("counters only increase")
        k = self._key(tags)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + value


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
