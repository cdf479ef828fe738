"""KV-tier observability (counterpart of ``ray_tpu/llm/kvtier/metrics.py``,
the same names, descriptions and tags): the spill, residency,
resurrection and corrupt-drop series, over the port's ``obs/telemetry.py``.

Construct-per-call like ``obs/slo.py`` (same-name re-registration shares
storage in ``util/metrics``, so a test's ``clear_registry()`` can never
strand a stale cached instance). The per-tier prefix-cache HIT accounting
lives on the engine's ``llm_prefix_cache_hit_tokens_total`` counter, split
by its ``tier`` label (hbm / host / object).
"""

from __future__ import annotations


def spilled_bytes_counter():
    """Bytes of sealed KV pages spilled DOWN the ladder, by destination
    tier (host = evicted from HBM into host DRAM, object = demoted from
    host into the object store). Counters aggregate by SUM."""
    from ray_tpu_torch.obs.telemetry import cluster_counter

    return cluster_counter(
        "llm_kvtier_spilled_bytes_total",
        description="KV page bytes spilled from the HBM prefix cache "
        "into a deeper tier (labelled by destination tier)",
        tag_keys=("model", "tier"),
    )


def resident_bytes_gauge():
    """Bytes of spilled KV pages currently resident per deep tier
    (host/object). SUM across engines: the fleet value is the total
    spilled-cache footprint."""
    from ray_tpu_torch.obs.telemetry import cluster_gauge

    return cluster_gauge(
        "llm_kvtier_resident_bytes",
        description="KV page bytes currently held by this engine's "
        "host-DRAM / object-store prefix-cache tiers",
        tag_keys=("model", "tier"),
    )


def resurrected_tokens_counter():
    """Prompt tokens resurrected back into HBM with zero recompute, by
    source tier."""
    from ray_tpu_torch.obs.telemetry import cluster_counter

    return cluster_counter(
        "llm_kvtier_resurrected_tokens_total",
        description="prompt tokens whose KV was resurrected into the "
        "paged cache from a deeper tier (no recompute), by source tier",
        tag_keys=("model", "tier"),
    )


def corrupt_dropped_counter():
    """Spilled blocks whose CRC/token check failed at resurrection —
    dropped and recomputed, never decoded from garbage pages."""
    from ray_tpu_torch.obs.telemetry import cluster_counter

    return cluster_counter(
        "llm_kvtier_corrupt_dropped_total",
        description="spilled KV blocks dropped because seal "
        "verification failed at resurrection (fell back to recompute)",
        tag_keys=("model", "tier"),
    )


def register_metrics() -> None:
    """Register the lazily built series (a registry listing sees them)."""
    spilled_bytes_counter()
    resident_bytes_gauge()
    resurrected_tokens_counter()
    corrupt_dropped_counter()
