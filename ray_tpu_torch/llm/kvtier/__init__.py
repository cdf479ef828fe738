"""The tiered KV/prefix cache (counterpart of ``ray_tpu/llm/kvtier``).

The HBM prefix cache (``llm/kv_cache.py`` ``BlockAllocator``) is tier 0 of
a three-deep ladder:

    HBM (the paged device cache) -> host memory (an LRU over a pinned slab
        of block-sized slots) -> the object store (serialized, bounded)

Sealed full blocks evicted from the HBM allocator SPILL down the ladder
instead of being discarded; a later prompt sharing the prefix RESURRECTS
them with a verified scatter into the cache (``num_cached_tokens`` covers
every resurrected position: no recompute). Every spilled block is
CRC-sealed with the ``KVHandoff`` seal, so a corrupt copy fails
``verify()`` and is recomputed: counted, never wrong tokens.

A prefix index (``LocalPrefixIndex``, in-process) maps chain hashes to
{engine, tier, n_tokens} so the disaggregated orchestrator routes each
request to the engine holding its longest prefix, tier-discounted, falling
back to its queue-depth ladder when the index holds nothing. On a cluster,
``GcsPrefixIndex`` reads and writes the same table hosted by the GCS.
"""

from ray_tpu_torch.llm.kvtier.config import TIER_HBM, TIER_HOST, TIER_OBJECT, KVTierConfig
from ray_tpu_torch.llm.kvtier.index import (
    GcsPrefixIndex,
    LocalPrefixIndex,
    PrefixIndexStore,
    best_prefix_replica,
    chain_hashes,
    get_local_index,
)
from ray_tpu_torch.llm.kvtier.tiers import KVTierManager, SpilledBlock

__all__ = [
    "KVTierConfig",
    "KVTierManager",
    "SpilledBlock",
    "PrefixIndexStore",
    "LocalPrefixIndex",
    "GcsPrefixIndex",
    "get_local_index",
    "best_prefix_replica",
    "chain_hashes",
    "TIER_HBM",
    "TIER_HOST",
    "TIER_OBJECT",
]
