"""KVTierConfig: shape of one engine's tiered prefix cache (counterpart of
``ray_tpu/llm/kvtier/config.py``: the same fields and defaults)."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

# tier names + index wire codes are owned by the control-plane half
# (cluster/prefix_index.py); re-exported here for engine-side callers
from ray_tpu_torch.cluster.prefix_index import (  # noqa: F401
    TIER_CODES,
    TIER_HBM,
    TIER_HOST,
    TIER_NAMES,
    TIER_OBJECT,
)


@dataclasses.dataclass
class KVTierConfig:
    """Budgets + routing weights for the HBM -> host -> object ladder.

    A tier with a zero budget is disabled; blocks falling past the last
    enabled tier are discarded (exactly the pre-kvtier behavior). The
    ``tier_weights`` discount what a cached prefix is worth to the
    router per tier: resurrecting from the object store still beats a
    recompute, but an HBM hit costs nothing at all, so routing must
    prefer the replica holding the prefix in the cheapest tier.
    """

    # host DRAM LRU budget for spilled page arrays (bytes; 0 disables)
    host_bytes: int = 64 << 20
    # object-store tier budget (bytes; 0 disables). Entries are
    # serialized through core/object_store.py — the plasma-shaped
    # boundary a multi-process deployment would cross.
    object_bytes: int = 256 << 20
    # optional store shared by engines (default: a private ObjectStore):
    # any object with put_serialized / serialized_get / remove_ref; entries
    # are namespaced by engine key either way
    object_store: Any = None
    # routing discount per tier (missing tier = 0.0: never preferred)
    tier_weights: tuple = ((TIER_HBM, 1.0), (TIER_HOST, 0.6), (TIER_OBJECT, 0.35))
    # prefix-aware picks only prefer a prefix-holder whose queue depth
    # is within this slack of the least-loaded candidate — cache
    # affinity must not pile every request onto one hot replica
    depth_slack: int = 4
    # min seconds between full index snapshots shipped to the prefix
    # index (piggybacks on the engine's throttled telemetry refresh)
    index_flush_interval_s: float = 0.2
    # index rows older than this are treated as dark by routing helpers
    index_stale_after_s: float = 30.0

    # -- the fetch plane (llm/kvfetch) -------------------------------------------
    # async batched spill: eviction only captures the block's pages as
    # a device slice; a spill worker coalesces queued blocks into one
    # batched device->host gather off the allocation hot path. False
    # keeps the blocking gather on the allocation path.
    async_spill: bool = True
    # bounded pending-spill queue (each entry pins its device slices);
    # overflow drops the oldest capture — a counted miss, never growth
    spill_queue_depth: int = 64
    # prefetch-at-admission: while a request waits in the queue, a
    # bounded worker verifies/deserializes its local deep-tier prefix
    # and pulls remote blocks over the fetch plane, so _prefill_one
    # finds the blocks already resident. False = synchronous
    # resurrection only.
    prefetch: bool = True
    prefetch_queue_depth: int = 64
    # routing discount for a prefix held by ANOTHER engine this replica
    # can fetch from (must stay below every holding-tier weight: a pull
    # over the fabric beats recompute but loses to any local copy)
    fetch_weight: float = 0.25
    # bound on one cross-engine pull (typed KVFetchError past it: the
    # requester degrades to local tiers + recompute, never hangs)
    fetch_timeout_s: float = 5.0
    # cap on blocks pulled per fetch (one queue-waiting request)
    fetch_max_blocks: int = 64

    def __post_init__(self):
        from ray_tpu_torch.core.object_store import tier_store

        if self.object_store is not None:
            tier_store(self.object_store)  # one lacking the tier's methods raises

    def weight(self, tier: Optional[str]) -> float:
        for t, w in self.tier_weights:
            if t == tier:
                return float(w)
        return 0.0
