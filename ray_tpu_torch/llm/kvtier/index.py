"""Cluster-level prefix index: chain hash -> {engine, tier, n_tokens}
(counterpart of ``ray_tpu/llm/kvtier/index.py``).

 * ``PrefixIndexStore`` — the table (``cluster/prefix_index.py``,
   re-exported here), with the epoch/seq staleness discipline.
 * ``LocalPrefixIndex`` — the in-process store: same update/lookup
   contract, shared through a process-global namespace registry so the
   engines of one orchestrator meet on it.
 * ``GcsPrefixIndex`` — the RPC client over the GCS's ``kvtier_*`` RPCs
   that routers use. Every call is bounded and failure-swallowed: a dark
   or stalled GCS (STALL_GCS chaos) makes ``lookup`` return None ("no
   information"), so the caller's p2c/queue-depth ladder takes over with
   no hang and no wrong-replica pin. Like the reference's, the GCS-side
   table is not persisted and not replicated to a standby: a restarted or
   promoted GCS repopulates within one flush interval.

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
    """RPC-backed index client. ``gcs`` is a ReconnectingRpcClient (its
    ``gcs.call`` hook is where STALL_GCS chaos injects): every call here is
    bounded by ``timeout_s`` and failure-swallowed, so a control-plane
    blackout costs routing FRESHNESS, never liveness."""

    def __init__(self, gcs: Any, timeout_s: float = 2.0):
        self._gcs = gcs
        self.timeout_s = timeout_s
        self.num_dark = 0  # calls answered by a dark/stalled index

    # A copy that crosses to another process (a Serve replica's constructor
    # argument on a cluster) carries the GCS's endpoints and dials them
    # there at its first call: a connection does not travel.
    def __getstate__(self):
        return {"endpoints": tuple(self._gcs.endpoints), "timeout_s": self.timeout_s}

    def __setstate__(self, state):
        from ray_tpu_torch.cluster.rpc import ReconnectingRpcClient

        self._gcs = ReconnectingRpcClient(*state["endpoints"], timeout=state["timeout_s"])
        self.timeout_s = state["timeout_s"]
        self.num_dark = 0

    def update(self, payload: dict) -> bool:
        try:
            got = self._gcs.call("kvtier_update", payload, timeout=self.timeout_s)
            return bool(got and got.get("ok"))
        except Exception:  # noqa: BLE001 — the next snapshot supersedes
            self.num_dark += 1
            return False

    def lookup(self, hashes: list) -> Optional[dict]:
        try:
            return self._gcs.call("kvtier_lookup", {"hashes": list(hashes)},
                                  timeout=self.timeout_s)
        except Exception:  # noqa: BLE001 — dark index = no information
            self.num_dark += 1
            return None

    def drop_engine(self, engine: str) -> bool:
        """Orderly removal via the dedicated RPC, never by publishing a
        poisoned epoch, which would block a restarted engine reusing the
        key from ever registering again."""
        try:
            self._gcs.call("kvtier_drop", {"engine": engine}, timeout=self.timeout_s)
            return True
        except Exception:  # noqa: BLE001
            self.num_dark += 1
            return False


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
