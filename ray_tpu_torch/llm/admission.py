"""Admission control for the OpenAI serving front end: shed load before the
queue does it for you (counterpart of ``ray_tpu/llm/admission.py``).

One trigger is ported: queue depth. More than ``max_queue_depth`` requests
already waiting in the engine -> 429 with a Retry-After hint. The
reference's second trigger, the measured queue-wait SLO, reads the
``llm_queue_wait_seconds`` histogram that the engine's trace spans fill;
those spans are not ported (ROADMAP.md, Queue 1, B4c), so
``target_queue_wait_s > 0`` is refused rather than shedding on no data,
and Retry-After is priced as the reference prices it before any history.

Draining (maintenance) turns every new request into a 503 with
Retry-After while in-flight requests finish. Rejections are counted in
``llm_admission_rejected_total{model,code,tenant}`` (``util/metrics.py``).
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Optional

from ray_tpu_torch.util.metrics import Counter


@dataclasses.dataclass
class AdmissionConfig:
    # waiting-queue depth at which new requests shed (-1 = unbounded)
    max_queue_depth: int = -1
    # recent mean queue_wait above this sheds (0 = SLO trigger disabled;
    # anything else is refused until B4c, which also brings the trigger's
    # min_queue_depth and window_s)
    target_queue_wait_s: float = 0.0
    retry_after_floor_s: float = 0.1
    retry_after_cap_s: float = 30.0
    drain_retry_after_s: float = 5.0

    def __post_init__(self):
        if self.retry_after_cap_s < self.retry_after_floor_s:
            raise ValueError("retry_after_cap_s < retry_after_floor_s")
        if self.target_queue_wait_s > 0:
            raise NotImplementedError(
                "AdmissionConfig.target_queue_wait_s: the queue-wait SLO trigger reads "
                "the engine's queue-wait histogram, whose trace spans are not ported to "
                "ray_tpu_torch yet (ROADMAP.md, Queue 1, B4c)"
            )


def rejected_counter() -> Counter:
    return Counter(
        "llm_admission_rejected_total",
        description="serving admission control: requests shed with 429 "
        "(overload) or 503 (draining), attributable per tenant (empty "
        "tenant = single-tenant serving)",
        tag_keys=("model", "code", "tenant"),
    )


class AdmissionController:
    """Per-LLMServer admission decisions; thread-safe."""

    # the reference's Retry-After estimate before any queue-wait history
    NO_HISTORY_WAIT_S = 0.5

    def __init__(self, config: Optional[AdmissionConfig] = None,
                 model_tag: str = "engine"):
        self.config = config or AdmissionConfig()
        self.model_tag = model_tag
        self.draining = False
        self._lock = threading.Lock()
        self.num_rejected_429 = 0
        self.num_rejected_503 = 0

    def start_drain(self) -> None:
        self.draining = True

    def estimate_retry_after(self, num_waiting: int, num_running: int) -> float:
        """The queue ahead of a retry is ~num_waiting deep and drains at
        ~one queue_wait per admission wave (scaled by how loaded decode is)."""
        cfg = self.config
        est = self.NO_HISTORY_WAIT_S * (1.0 + num_waiting / max(1, num_running))
        return min(cfg.retry_after_cap_s, max(cfg.retry_after_floor_s, est))

    def check(self, *, num_waiting: int, num_running: int) -> Optional[dict]:
        """None = admit; otherwise an OpenAI-style error payload carrying
        ``code`` (429/503) and ``retry_after`` seconds."""
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
        # num_waiting > 0: depth 0 means "no waiting queue", not "reject
        # even when idle" — an idle engine always admits
        if not (cfg.max_queue_depth >= 0 and num_waiting > 0
                and num_waiting >= cfg.max_queue_depth):
            return None
        with self._lock:
            self.num_rejected_429 += 1
        self._count("429")
        return self._payload(
            429, "rate_limit_error",
            f"overloaded: queue depth {num_waiting} >= max_queue_depth="
            f"{cfg.max_queue_depth}",
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
        rejected_counter().inc(
            # the reference's schema; tenant stays empty until the fleet is ported
            tags={"model": self.model_tag, "code": code, "tenant": ""}
        )

    def stats(self) -> dict:
        return {
            "draining": self.draining,
            "rejected_429": self.num_rejected_429,
            "rejected_503": self.num_rejected_503,
            # no queue-wait history until the engine's spans are ported (B4c)
            "recent_queue_wait_mean_s": None,
        }


def retry_after_header(payload: dict) -> Optional[str]:
    """Retry-After header value for a rejection payload (whole seconds,
    rounded up: RFC 7231 delta-seconds)."""
    err = payload.get("error") if isinstance(payload, dict) else None
    if not isinstance(err, dict):
        return None
    ra = err.get("retry_after")
    if ra is None:
        return None
    return str(int(math.ceil(float(ra))))
