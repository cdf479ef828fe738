"""Fabric observability: the transfer plane's two series (counterpart of
``ray_tpu/fabric/metrics.py``, same names, descriptions and tags).

Built per call like ``obs/slo.py`` (a same-name registration shares
storage in ``util/metrics``, so a test's ``clear_registry()`` never strands
a cached instance). Both are telemetry-plane metrics (``ray_tpu_fabric_``
is in ``obs.telemetry.AGGREGATED_PREFIXES``).
"""

from __future__ import annotations


def edges_active_gauge():
    """Directed engine-pair edges this orchestrator serves, per transport
    backend. SUM across reporters: the fleet value is the total edge
    count, the per-backend series the backend mix."""
    from ray_tpu_torch.obs.telemetry import cluster_gauge

    return cluster_gauge(
        "fabric_edges_active",
        description="active fabric transfer edges (directed pool pairs) "
        "by transport backend (device/rpc/inproc)",
        tag_keys=("model", "backend"),
    )


def transfer_fallbacks_counter():
    """Device edges degraded to their RPC fallback after a device-transfer
    fault (counters default to SUM aggregation)."""
    from ray_tpu_torch.obs.telemetry import cluster_counter

    return cluster_counter(
        "fabric_transfer_fallbacks_total",
        description="fabric edges degraded from device-direct transfer "
        "to the RPC fallback after a device-transfer fault",
        tag_keys=("model", "edge"),
    )


def register_metrics() -> None:
    """Force the lazy metrics to register (the registry parity checks)."""
    edges_active_gauge()
    transfer_fallbacks_counter()
