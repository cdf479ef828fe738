"""Serving SLO metrics: TTFT / TPOT / queue-wait / e2e histograms
(counterpart of ``ray_tpu/obs/slo.py``; names, tags and boundaries are
the reference's).

The two latencies serving users feel (TTFT, TPOT) plus the two the
scheduler needs (queue_wait prices admission, e2e prices the whole
path), exported through this package's ``util/metrics`` registry
(``prometheus_text()``). The engine records them once per finished
request (``LLMEngine._obs_finalize``), the disaggregated orchestrator
once per KV handoff.

Metric objects are constructed per call rather than cached: same-name
re-registration shares storage in util/metrics, and re-constructing
means a test's ``clear_registry()`` can never strand a stale cached
instance writing to storage the exporter no longer renders. These fire
once per REQUEST (and once per dispatch), not per token — the registry
lock is not a hot-path cost here.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.util.metrics import Counter, Histogram

# TTFT/queue-wait: sub-ms on a CPU smoke model, seconds under a first
# pass's graph captures or heavy admission queueing.
_TTFT_BOUNDARIES = [
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5,
    10, 30,
]
# TPOT: per-token decode latency, from sub-ms to a dispatch-bound CPU
# step's tens of ms.
_TPOT_BOUNDARIES = [
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1,
]
_E2E_BOUNDARIES = [
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120,
]
_DISPATCH_BOUNDARIES = [
    0.00001, 0.00005, 0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1,
]


def ttft_histogram() -> Histogram:
    return Histogram(
        "llm_ttft_seconds",
        description="serving SLO: time to first token (request arrival -> "
        "first sampled token), seconds",
        boundaries=_TTFT_BOUNDARIES,
        tag_keys=("model",),
    )


def tpot_histogram() -> Histogram:
    return Histogram(
        "llm_tpot_seconds",
        description="serving SLO: time per output token after the first "
        "(decode steady state), seconds",
        boundaries=_TPOT_BOUNDARIES,
        tag_keys=("model",),
    )


def prefill_span_histogram() -> Histogram:
    return Histogram(
        "llm_prefill_span_seconds",
        description="prefill service span (first prefill dispatch -> "
        "first sampled token), seconds — the per-request prefill cost "
        "the r20 autoscaler sizes the prefill pool from",
        boundaries=_TTFT_BOUNDARIES,
        tag_keys=("model",),
    )


def queue_wait_histogram() -> Histogram:
    return Histogram(
        "llm_queue_wait_seconds",
        description="serving SLO: request arrival -> first prefill dispatch "
        "(admission queue wait), seconds",
        boundaries=_TTFT_BOUNDARIES,
        tag_keys=("model",),
    )


def e2e_histogram() -> Histogram:
    return Histogram(
        "llm_e2e_seconds",
        description="serving SLO: request arrival -> finish, seconds",
        boundaries=_E2E_BOUNDARIES,
        tag_keys=("model", "finish_reason"),
    )


_KV_TRANSFER_BOUNDARIES = [
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1,
    2.5, 5,
]


def kv_transfer_histogram() -> Histogram:
    return Histogram(
        "llm_kv_transfer_seconds",
        description="disaggregated serving: prefill-side export -> "
        "decode-side import complete for one KV handoff, seconds, by "
        "transport backend (inproc/rpc/device)",
        boundaries=_KV_TRANSFER_BOUNDARIES,
        tag_keys=("model", "backend"),
    )


def kv_transfer_bytes_counter():
    return Counter(
        "llm_kv_transfer_bytes_total",
        description="disaggregated serving: KV page bytes moved "
        "prefill -> decode, by transport backend (inproc/rpc/device)",
        tag_keys=("model", "backend"),
    )


def router_dispatch_histogram() -> Histogram:
    return Histogram(
        "serve_router_dispatch_seconds",
        description="serve: router time to place one request on a replica "
        "(refresh + pick + submit), seconds",
        boundaries=_DISPATCH_BOUNDARIES,
        tag_keys=("app", "deployment"),
    )


def register_all() -> None:
    """Force-register every SLO metric (scripts/check_metrics.py hook —
    lazy construction would otherwise hide them from the static pass)."""
    ttft_histogram()
    tpot_histogram()
    prefill_span_histogram()
    queue_wait_histogram()
    e2e_histogram()
    router_dispatch_histogram()
    kv_transfer_histogram()
    kv_transfer_bytes_counter()


def record_request_slo(
    model: str,
    *,
    ttft_s: Optional[float],
    tpot_s: Optional[float],
    queue_wait_s: Optional[float],
    e2e_s: float,
    finish_reason: str,
    prefill_span_s: Optional[float] = None,
) -> None:
    """One finished request's SLO observations. Observability must never
    break serving: failures are swallowed."""
    try:
        tags = {"model": model}
        if ttft_s is not None:
            ttft_histogram().observe(ttft_s, tags=tags)
        if tpot_s is not None:
            tpot_histogram().observe(tpot_s, tags=tags)
        if queue_wait_s is not None:
            queue_wait_histogram().observe(queue_wait_s, tags=tags)
        if prefill_span_s is not None:
            prefill_span_histogram().observe(prefill_span_s, tags=tags)
        e2e_histogram().observe(
            e2e_s, tags={"model": model, "finish_reason": finish_reason or ""}
        )
    except Exception:  # noqa: BLE001
        pass


def record_kv_transfer(model: str, backend: str, *, seconds: float,
                       nbytes: int) -> None:
    """One completed KV handoff (disaggregated serving), labelled by
    the transport backend that carried it (inproc/rpc/device)."""
    try:
        tags = {"model": model, "backend": backend}
        kv_transfer_histogram().observe(seconds, tags=tags)
        kv_transfer_bytes_counter().inc(max(0, int(nbytes)), tags=tags)
    except Exception:  # noqa: BLE001
        pass


def record_dispatch(app: str, deployment: str, seconds: float) -> None:
    try:
        router_dispatch_histogram().observe(
            seconds, tags={"app": app, "deployment": deployment}
        )
    except Exception:  # noqa: BLE001
        pass
