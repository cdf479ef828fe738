"""Cluster-level prefix index: chain hash -> {engine, tier, n_tokens}
(counterpart of ``ray_tpu/llm/kvtier/index.py``).

 * ``PrefixIndexStore`` — the table (``cluster/prefix_index.py``,
   re-exported here), with the epoch/seq staleness discipline.
 * ``LocalPrefixIndex`` — the in-process store: same update/lookup
   contract, shared through a process-global namespace registry so the
   engines of one orchestrator meet on it.
 * ``GcsPrefixIndex`` — the reference's RPC client over the GCS; it waits
   for the cluster runtime (ROADMAP.md Queue 1, B8) and raises naming it.

``best_prefix_replica`` is the routing pick over a lookup: tier-discounted,
bounded by depth slack, with the fetch-cost discount.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from ray_tpu_torch.cluster.prefix_index import TIER_CODES, TIER_NAMES, PrefixIndexStore
from ray_tpu_torch.llm.kvtier.config import KVTierConfig


def chain_hashes(tokens: list, block_size: int, salt: int = 0) -> list:
    """The prefix-chain hash after each FULL block of ``tokens`` —
    the keys a prompt probes the index with. Mirrors
    BlockAllocator.chain_hash so index keys and cache keys can never
    drift."""
    from ray_tpu_torch.llm.kv_cache import BlockAllocator

    out = []
    h = salt
    for i in range(len(tokens) // block_size):
        blk = tuple(tokens[i * block_size : (i + 1) * block_size])
        h = BlockAllocator.chain_hash(h, blk)
        out.append(h)
    return out


class LocalPrefixIndex(PrefixIndexStore):
    """Same store, shared in-process (serve replicas + ingress)."""


_LOCAL_LOCK = threading.Lock()
_LOCAL: dict[str, LocalPrefixIndex] = {}


def get_local_index(namespace: str) -> LocalPrefixIndex:
    """Process-global namespace registry: every party naming the same
    namespace (an app, an orchestrator) meets on one index."""
    with _LOCAL_LOCK:
        idx = _LOCAL.get(namespace)
        if idx is None:
            idx = _LOCAL[namespace] = LocalPrefixIndex()
        return idx


class GcsPrefixIndex:
    """The reference's RPC-backed index client (a GCS over the cluster RPC
    plane): not ported, it waits for the cluster runtime."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "GcsPrefixIndex: the GCS prefix-index RPCs are not ported to "
            "ray_tpu_torch yet (the cluster runtime, ROADMAP.md Queue 1, B8); "
            "use get_local_index(namespace)"
        )


def best_prefix_replica(
    lookup: Optional[dict],
    depths: dict,
    cfg: Optional[KVTierConfig] = None,
    key_of: Optional[dict] = None,
    fetch_weight: float = 0.0,
) -> Optional[str]:
    """Tier-discounted routing pick over an index ``lookup`` result.

    ``depths`` maps replica -> queue depth for every LIVE candidate;
    ``key_of`` maps replica -> index engine key when they differ.
    Returns the replica to prefer, or None when the index is dark,
    holds nothing for this prompt, or the only holders are overloaded
    past ``depth_slack`` — in every None case the caller's existing
    queue-depth/p2c ladder decides (graceful degradation, never a pin).

    ``fetch_weight`` > 0 adds the FETCH-COST discount: a replica
    that holds nothing itself scores ``fetch_weight`` times the best
    fresh holder's score — a pull over the fetch plane beats recompute
    but loses to any local copy. With the holder loaded past the depth
    slack, the pick now SPREADS to a cold within-slack replica that
    will fetch the prefix, instead of piling onto (or abandoning) the
    one hot holder.
    """
    if not lookup or not depths:
        return None
    cfg = cfg or KVTierConfig()
    engines = lookup.get("engines") or {}
    if not engines:
        return None
    min_depth = min(depths.values())

    def held_score(replica) -> float:
        key = (key_of or {}).get(replica, replica)
        got = engines.get(key)
        if got is None or got.get("age_s", 0.0) > cfg.index_stale_after_s:
            return 0.0
        return cfg.weight(got.get("tier")) * float(got.get("n_tokens", 0))

    # the fetch discount prices pulling from the best FRESH holder,
    # whether or not that holder is a routable candidate here
    best_held = 0.0
    if fetch_weight > 0.0:
        for got in engines.values():
            if got.get("age_s", 0.0) > cfg.index_stale_after_s:
                continue
            s = cfg.weight(got.get("tier")) * float(got.get("n_tokens", 0))
            best_held = max(best_held, s)
    best: Optional[tuple] = None
    for replica, depth in depths.items():
        if depth > min_depth + cfg.depth_slack:
            continue  # cache affinity must not overload one replica
        score = max(held_score(replica), fetch_weight * best_held)
        if score <= 0.0:
            continue
        cand = (score, -depth, replica)
        if best is None or cand > best:
            best = cand
    return best[-1] if best else None


__all__ = [
    "PrefixIndexStore",
    "LocalPrefixIndex",
    "GcsPrefixIndex",
    "get_local_index",
    "chain_hashes",
    "best_prefix_replica",
    "TIER_CODES",
    "TIER_NAMES",
]
