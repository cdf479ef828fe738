"""kvfetch observability (counterpart of ``ray_tpu/llm/kvfetch/metrics.py``,
the same names, descriptions, tags and boundaries): the prefetch, fetch and
spill-queue series. Construct-per-call like ``kvtier/metrics.py``.
"""

from __future__ import annotations

_PREFETCH_PHASES = ("started", "completed", "wasted")


def prefetch_counter(phase: str):
    """One counter family per prefetch phase: started (task queued at
    admission), completed (consumed by the request's prefill), wasted
    (the request aborted/finished before its prefetch was consumed).
    Counters aggregate by SUM."""
    from ray_tpu_torch.obs.telemetry import cluster_counter

    if phase not in _PREFETCH_PHASES:
        raise ValueError(f"unknown prefetch phase {phase!r}")
    return cluster_counter(
        f"llm_kvtier_prefetch_{phase}_total",
        description=f"KV prefix prefetches {phase} "
        "(prefetch-at-admission, ray_tpu.llm.kvfetch)",
        tag_keys=("model",),
    )


def fetch_bytes_counter():
    """Bytes of KV pages pulled from REMOTE engines over the fetch
    plane, labelled by transport backend like the KV transfer metrics
    (local / device / rpc)."""
    from ray_tpu_torch.obs.telemetry import cluster_counter

    return cluster_counter(
        "llm_kvtier_fetch_bytes_total",
        description="KV page bytes pulled from remote engines for "
        "cross-engine prefix resurrection, by fetch backend",
        tag_keys=("backend",),
    )


def fetch_corrupt_counter():
    """Fetched blocks that failed the requester-side seal/token verify
    — dropped and recomputed, never scattered."""
    from ray_tpu_torch.obs.telemetry import cluster_counter

    return cluster_counter(
        "llm_kvtier_fetch_corrupt_dropped_total",
        description="remotely fetched KV blocks dropped because the "
        "requester-side verify failed (fell back to recompute)",
        tag_keys=("model",),
    )


def spill_queue_gauge():
    """Evicted blocks captured on-device awaiting the spill worker's
    batched gather. SUM across engines: the fleet's in-flight spill
    backlog."""
    from ray_tpu_torch.obs.telemetry import cluster_gauge

    return cluster_gauge(
        "llm_kvtier_spill_queue_depth",
        description="evicted KV blocks queued for the async batched "
        "device->host spill gather",
        tag_keys=("model",),
    )


def prefetch_lead_histogram():
    """Seconds between a prefetch landing (blocks staged/resident) and
    the request's admission consuming it — how far ahead of the prefill
    the prefetch ran. Histograms aggregate by bucket merge."""
    from ray_tpu_torch.obs.telemetry import cluster_histogram

    return cluster_histogram(
        "llm_kvtier_prefetch_lead_seconds",
        description="lead time between prefetch completion and the "
        "request's prefill admission consuming it",
        tag_keys=("model",),
        boundaries=[0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                    2.5, 5.0, 10.0],
    )


def register_metrics() -> None:
    """Register the lazily built series (a registry listing sees them)."""
    for phase in _PREFETCH_PHASES:
        prefetch_counter(phase)
    fetch_bytes_counter()
    fetch_corrupt_counter()
    spill_queue_gauge()
    prefetch_lead_histogram()
