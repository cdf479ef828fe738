"""Fleet-plane metrics: adapter residency churn, canary outcomes, and
per-tenant routing volume (counterpart of ``ray_tpu/fleet/metrics.py``,
same names, descriptions, tags and aggregation kinds). All
cluster-aggregated (SUM for counters, SUM for gauges) and declared via the
telemetry helpers; built per call like ``obs/slo.py``.
"""

from __future__ import annotations


def adapter_load_counter():
    """Adapter loads into an engine slot, by model. Together with the
    eviction counter it prices slot-budget pressure: a high evict/load
    ratio means max_loras is too small for the working set."""
    from ray_tpu_torch.obs.telemetry import cluster_counter

    return cluster_counter(
        "fleet_adapter_loads_total",
        description="LoRA adapters loaded into an engine slot by the "
        "fleet manager, by base model",
        tag_keys=("model",),
    )


def adapter_evict_counter():
    from ray_tpu_torch.obs.telemetry import cluster_counter

    return cluster_counter(
        "fleet_adapter_evictions_total",
        description="LoRA adapters LRU-evicted from an engine slot to "
        "make room, by base model",
        tag_keys=("model",),
    )


def canary_counter():
    """Canary rollouts by terminal outcome (promoted / rolled_back /
    aborted): the fleet's weight-rollout audit trail."""
    from ray_tpu_torch.obs.telemetry import cluster_counter

    return cluster_counter(
        "fleet_canary_rollouts_total",
        description="canary weight rollouts completed, by base model "
        "and outcome (promoted/rolled_back/aborted)",
        tag_keys=("model", "outcome"),
    )


def tenant_requests_counter():
    """Requests routed per (tenant, model): the denominator for the
    per-tenant shed rate llm_admission_rejected_total{tenant} is the
    numerator of."""
    from ray_tpu_torch.obs.telemetry import cluster_counter

    return cluster_counter(
        "fleet_tenant_requests_total",
        description="requests admitted and routed by the fleet, by "
        "tenant and base model",
        tag_keys=("tenant", "model"),
    )


def resident_adapters_gauge():
    from ray_tpu_torch.obs.telemetry import cluster_gauge

    return cluster_gauge(
        "fleet_resident_adapters",
        description="LoRA adapters currently resident across a model's "
        "replicas (sums across replicas)",
        tag_keys=("model",),
    )


def register_metrics() -> None:
    """Force the lazy metrics to register (the registry parity checks)."""
    adapter_load_counter()
    adapter_evict_counter()
    canary_counter()
    tenant_requests_counter()
    resident_adapters_gauge()
