"""Admission control for the OpenAI serving front end: shed load before the
queue does it for you (counterpart of ``ray_tpu/llm/admission.py``).

The ``llm_queue_wait_seconds`` histogram the engine records per finished
request (``obs/slo.py``) prices both the shedding decision and the
Retry-After hint. Two triggers:

 * queue depth: ``max_queue_depth`` or more requests already waiting in
   the engine -> 429 (the engine would only park the new arrival behind
   them);
 * measured queue-wait SLO: the recent mean queue_wait (a windowed delta
   over the histogram) exceeds ``target_queue_wait_s`` while the queue is
   at least ``min_queue_depth`` deep -> 429 below the depth cap too,
   because the SLO is already burning.

Draining (maintenance) turns every new request into a 503 with
Retry-After while in-flight requests finish. Rejections are counted in
``llm_admission_rejected_total{model,code,tenant}`` (tenant empty outside
a multi-tenant fleet).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Optional

from ray_tpu_torch.util.metrics import Counter


@dataclasses.dataclass
class AdmissionConfig:
    # waiting-queue depth at which new requests shed (-1 = unbounded)
    max_queue_depth: int = -1
    # recent mean queue_wait above this sheds (0 = SLO trigger disabled)
    target_queue_wait_s: float = 0.0
    # SLO shedding needs this much queue to act on (a briefly-slow lone
    # request must not flip the app into rejecting everything)
    min_queue_depth: int = 2
    # histogram delta window for "recent" queue_wait
    window_s: float = 10.0
    retry_after_floor_s: float = 0.1
    retry_after_cap_s: float = 30.0
    drain_retry_after_s: float = 5.0

    def __post_init__(self):
        if self.retry_after_cap_s < self.retry_after_floor_s:
            raise ValueError("retry_after_cap_s < retry_after_floor_s")


def rejected_counter() -> Counter:
    return Counter(
        "llm_admission_rejected_total",
        description="serving admission control: requests shed with 429 "
        "(overload) or 503 (draining), attributable per tenant (empty "
        "tenant = pre-fleet single-tenant serving)",
        tag_keys=("model", "code", "tenant"),
    )


def register_metrics() -> None:
    rejected_counter()


class AdmissionController:
    """Per-LLMServer admission decisions; thread-safe, observability-fed."""

    def __init__(self, config: Optional[AdmissionConfig] = None,
                 model_tag: str = "engine"):
        from collections import deque

        self.config = config or AdmissionConfig()
        self.model_tag = model_tag
        self.draining = False
        self._lock = threading.Lock()
        # (t, cum_sum, cum_count) snapshots of the queue_wait histogram,
        # kept just long enough to window a delta over window_s. The
        # computed mean is TTL-cached so the histogram walk + snapshot
        # churn run a few times per second REGARDLESS of request rate —
        # admission cost must not grow with the very load it sheds
        self._snaps: "deque[tuple[float, float, int]]" = deque()
        self._cached_mean: tuple[float, Optional[float]] = (0.0, None)
        self.num_rejected_429 = 0
        self.num_rejected_503 = 0

    MEAN_CACHE_TTL_S = 0.25

    # -- drain ----------------------------------------------------------------

    def start_drain(self) -> None:
        self.draining = True

    # -- the observability loop: queue_wait priced from the SLO histogram -----

    def _queue_wait_cum(self) -> tuple[float, int]:
        """Cumulative (sum_s, count) of llm_queue_wait_seconds for this
        model across the process registry."""
        try:
            from ray_tpu_torch.obs import slo

            data = slo.queue_wait_histogram().hist_data()
        except Exception:  # noqa: BLE001 — metrics must not break admission
            return (0.0, 0)
        total, count = 0.0, 0
        for key, (_buckets, s, n) in data.items():
            if key and key[0] == self.model_tag:
                total += s
                count += n
        return (total, count)

    def recent_queue_wait_mean(self) -> Optional[float]:
        """Mean queue_wait over roughly the last window_s, from histogram
        snapshot deltas (TTL-cached); None until a request landed."""
        now = time.monotonic()
        with self._lock:
            t_cache, cached = self._cached_mean
            if now - t_cache < self.MEAN_CACHE_TTL_S:
                return cached
        cum_sum, cum_count = self._queue_wait_cum()
        with self._lock:
            self._snaps.append((now, cum_sum, cum_count))
            horizon = now - self.config.window_s
            # keep ONE snapshot at/behind the horizon as the delta base
            while len(self._snaps) >= 2 and self._snaps[1][0] <= horizon:
                self._snaps.popleft()
            _t0, s0, n0 = self._snaps[0]
            if cum_count > n0:
                mean: Optional[float] = (cum_sum - s0) / (cum_count - n0)
            elif cum_count > 0:
                # nothing finished inside the window: lifetime fallback
                mean = cum_sum / cum_count
            else:
                mean = None
            self._cached_mean = (now, mean)
        return mean

    def estimate_retry_after(self, num_waiting: int, num_running: int) -> float:
        """Price the hint from measured behavior: the queue ahead of a
        retry is ~num_waiting deep and drains at ~mean queue_wait per
        admission wave (scaled by how loaded decode is)."""
        cfg = self.config
        per = self.recent_queue_wait_mean()
        if per is None or per <= 0:
            per = cfg.target_queue_wait_s or 0.5
        est = per * (1.0 + num_waiting / max(1, num_running))
        return min(cfg.retry_after_cap_s, max(cfg.retry_after_floor_s, est))

    # -- the decision ---------------------------------------------------------

    def check(self, *, num_waiting: int, num_running: int) -> Optional[dict]:
        """None = admit; otherwise an OpenAI-style error payload carrying
        ``code`` (429/503) and ``retry_after`` seconds (the HTTP proxy
        maps these onto the status line and Retry-After header)."""
        cfg = self.config
        if self.draining:
            with self._lock:
                self.num_rejected_503 += 1
            self._count("503")
            return self._payload(
                503, "service_unavailable_error",
                "server is draining; retry against another replica",
                cfg.drain_retry_after_s,
            )
        reason = None
        # num_waiting > 0 guard: depth 0 means "no waiting queue", not
        # "reject even when idle" — an idle engine always admits
        if (cfg.max_queue_depth >= 0 and num_waiting > 0
                and num_waiting >= cfg.max_queue_depth):
            reason = (
                f"queue depth {num_waiting} >= max_queue_depth="
                f"{cfg.max_queue_depth}"
            )
        elif cfg.target_queue_wait_s > 0 and num_waiting >= cfg.min_queue_depth:
            mean = self.recent_queue_wait_mean()
            if mean is not None and mean > cfg.target_queue_wait_s:
                reason = (
                    f"recent mean queue_wait {mean:.3f}s > SLO "
                    f"{cfg.target_queue_wait_s}s at depth {num_waiting}"
                )
        if reason is None:
            return None
        with self._lock:
            self.num_rejected_429 += 1
        self._count("429")
        return self._payload(
            429, "rate_limit_error", f"overloaded: {reason}",
            self.estimate_retry_after(num_waiting, num_running),
        )

    def _payload(self, code: int, err_type: str, message: str,
                 retry_after: float) -> dict:
        return {
            "error": {
                "message": message,
                "type": err_type,
                "code": code,
                "retry_after": round(float(retry_after), 3),
            }
        }

    def _count(self, code: str) -> None:
        try:
            rejected_counter().inc(
                # the reference's schema; tenant stays empty until the
                # fleet is ported
                tags={"model": self.model_tag, "code": code, "tenant": ""}
            )
        except Exception:  # noqa: BLE001
            pass

    def stats(self) -> dict:
        return {
            "draining": self.draining,
            "rejected_429": self.num_rejected_429,
            "rejected_503": self.num_rejected_503,
            "recent_queue_wait_mean_s": self.recent_queue_wait_mean(),
        }


def retry_after_header(payload: dict) -> Optional[str]:
    """Retry-After header value for a rejection payload (whole seconds,
    rounded up — RFC 7231 delta-seconds)."""
    err = payload.get("error") if isinstance(payload, dict) else None
    if not isinstance(err, dict):
        return None
    ra = err.get("retry_after")
    if ra is None:
        return None
    return str(int(math.ceil(float(ra))))
