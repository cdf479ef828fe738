"""GCS-resident KV prefix index: chain hash -> {engine, tier, n_tokens}
(a copy of ``ray_tpu/cluster/prefix_index.py``; the port imports nothing
from the JAX package).

The control-plane half of ``ray_tpu_torch.llm.kvtier``: tier codes and the
table itself, hosted in-process (``LocalPrefixIndex``) or by the GCS behind
its ``kvtier_update`` / ``kvtier_lookup`` / ``kvtier_drop`` /
``kvtier_stats`` RPCs.

Staleness discipline (the telemetry plane's): engines ship FULL
snapshots stamped (epoch, seq). A replayed or out-of-order snapshot is
dropped, never merged; a new epoch (engine restart) atomically replaces
the dead incarnation's rows; a weight swap ships an empty snapshot that
drops every stale row at once. The table is deliberately NOT persisted:
like telemetry it is a freshness surface, and routers fall back to their
queue-depth ladder until it repopulates.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

TIER_HBM = "hbm"
TIER_HOST = "host"
TIER_OBJECT = "object"

# wire codes (ints travel in snapshots; names render in lookups)
TIER_CODES = {TIER_HBM: 0, TIER_HOST: 1, TIER_OBJECT: 2}
TIER_NAMES = {v: k for k, v in TIER_CODES.items()}


class _EngineRows:
    __slots__ = ("epoch", "seq", "rows", "ts", "fetch_addr")

    def __init__(self, epoch: int, seq: int, rows: dict, ts: float,
                 fetch_addr=None):
        self.epoch = epoch
        self.seq = seq
        self.rows = rows  # chain_hash -> (tier_code, n_tokens)
        self.ts = ts
        # where remote engines can PULL this engine's spilled blocks
        # (llm/kvfetch RPC backend: a (host, port) pair; None for
        # in-process planes). Rides each snapshot so a restarted
        # engine's new address replaces the old one atomically.
        self.fetch_addr = fetch_addr


class PrefixIndexStore:
    """The index table. Thread-safe; snapshot-replace per engine."""

    def __init__(self, stale_after_s: float = 30.0,
                 expire_after_s: float = 180.0):
        self._lock = threading.Lock()
        self._engines: dict[str, _EngineRows] = {}
        self.stale_after_s = stale_after_s
        # reap horizon: uuid-keyed replicas churn, and a dead replica's
        # snapshot must not pin its rows (or inflate stats) forever —
        # entries silent past this are deleted outright (lookup already
        # stopped answering from them at stale_after_s)
        self.expire_after_s = expire_after_s
        self.num_updates = 0
        self.num_stale_dropped = 0
        self.num_expired = 0

    def _reap_locked(self, now: float) -> None:
        dead = [e for e, er in self._engines.items()
                if now - er.ts > self.expire_after_s]
        for e in dead:
            del self._engines[e]
            self.num_expired += 1

    def update(self, payload: dict) -> dict:
        """Apply one engine snapshot: {"engine", "epoch", "seq",
        "rows": [[hash, tier_code, n_tokens], ...]}. Stale (old epoch /
        replayed seq) snapshots are dropped, never merged."""
        engine = str(payload["engine"])
        epoch = int(payload.get("epoch", 0))
        seq = int(payload.get("seq", 0))
        rows = {int(h): (int(t), int(n)) for h, t, n in payload.get("rows", [])}
        with self._lock:
            self._reap_locked(time.time())
            cur = self._engines.get(engine)
            if cur is not None:
                if epoch < cur.epoch or (epoch == cur.epoch and seq <= cur.seq):
                    self.num_stale_dropped += 1
                    return {"ok": False, "reason": "stale"}
            self._engines[engine] = _EngineRows(
                epoch, seq, rows, time.time(),
                fetch_addr=payload.get("fetch_addr"),
            )
            self.num_updates += 1
        return {"ok": True}

    def drop_engine(self, engine: str) -> None:
        with self._lock:
            self._engines.pop(str(engine), None)

    def lookup(self, hashes: list) -> dict:
        """Longest indexed prefix per engine over the prompt's chain
        hashes. Returns {"engines": {engine: {"tier", "n_tokens",
        "age_s"}}} — engines whose snapshot has gone stale are omitted
        (routing treats them as holding nothing)."""
        now = time.time()
        want = [int(h) for h in hashes]
        out: dict[str, dict] = {}
        with self._lock:
            for engine, er in self._engines.items():
                age = now - er.ts
                if age > self.stale_after_s:
                    continue
                best: Optional[tuple] = None
                for h in want:
                    got = er.rows.get(h)
                    if got is None:
                        continue
                    tier_code, n = got
                    if best is None or n > best[1]:
                        best = (tier_code, n)
                if best is not None:
                    row = {
                        "tier": TIER_NAMES.get(best[0], TIER_OBJECT),
                        "n_tokens": best[1],
                        "age_s": round(age, 3),
                    }
                    if er.fetch_addr is not None:
                        # the kvfetch pull address: a replica that does
                        # NOT hold this prefix can fetch it from here
                        row["fetch_addr"] = er.fetch_addr
                    out[engine] = row
        return {"engines": out}

    def stats(self) -> dict:
        with self._lock:
            self._reap_locked(time.time())
            by_tier: dict[str, int] = {}
            for er in self._engines.values():
                for tier_code, _n in er.rows.values():
                    name = TIER_NAMES.get(tier_code, TIER_OBJECT)
                    by_tier[name] = by_tier.get(name, 0) + 1
            return {
                "engines": len(self._engines),
                "rows": sum(len(er.rows) for er in self._engines.values()),
                "rows_by_tier": by_tier,
                "updates": self.num_updates,
                "stale_dropped": self.num_stale_dropped,
                "expired": self.num_expired,
            }
