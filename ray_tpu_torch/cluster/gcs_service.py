"""GCS service: the cluster control-plane server process.

Reference analog: src/ray/gcs/gcs_server/ (GcsServer gcs_server.cc,
GcsNodeManager, GcsActorManager gcs_actor_manager.h:324,
GcsPlacementGroupManager gcs_placement_group_manager.h:228,
GcsHealthCheckManager gcs_health_check_manager.h, InternalKVManager
gcs_kv_manager.h). Redesigned: one asyncio RPC process holding plain
dict tables; health is heartbeat-lease based (nodes push state, the
sweeper declares death after `node_death_timeout_s`) instead of gRPC
ping; placement groups are placed centrally against the authoritative
resource view rather than via the reference's two-phase raylet commit.

Event feed: monotonically numbered events (node_added / node_dead /
actor_update / pg_update); clients poll `events_since` — the long-poll
pubsub of the reference (src/ray/pubsub/) collapsed to cursor polling.

High availability (``cluster/ha.py``): every critical mutation is
appended to a replication log of ``(seq, term, op, data)`` entries that a
warm standby tails over ``repl_since`` (bootstrapped and resynced by
``repl_snapshot``); ``promote`` turns a standby into the primary at a
bumped fencing term, and ``ha_fence`` / ``ha_term`` are the hooks through
which ``RpcServer`` fences a deposed primary. The telemetry store
(``obs/telemetry.py``) takes heartbeat piggybacks, ``telemetry_push`` and
the coalesced ``heartbeat_batch`` frame, and answers the ``telemetry_*``
queries and ``ha_status``.

A copy of ``ray_tpu/cluster/gcs_service.py`` without what later parts of
ROADMAP.md Queue 1, item 6 bring; each of those RPCs raises
``NotImplementedError`` naming its part: the KV prefix index
(``kvtier_*``) waits for part 3c, and the autoscaler's inputs
(``autoscale_signals``, ``cluster_demand``) for part 8. This process
never imports torch.
"""

from __future__ import annotations

import argparse
import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from ray_tpu_torch.cluster.lockstats import TimedRLock
from ray_tpu_torch.cluster.rpc import (
    ClientPool,
    NotPrimaryError,
    RemoteError,
    RpcError,
    RpcServer,
)
from ray_tpu_torch.obs.telemetry import SLOThresholds, TelemetryStore
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.cluster.gcs")

PART_3C = "ROADMAP.md Queue 1, item 6, part 3c"
PART_8 = "ROADMAP.md Queue 1, item 6, part 8"


def _unported(what: str, part: str):
    raise NotImplementedError(f"GCS {what} is not ported to ray_tpu_torch yet ({part})")


_ha_metrics_cache: Optional[tuple] = None


def register_metrics() -> tuple:
    """The control plane's HA series. Plain process-registry metrics, not
    aggregated by the telemetry plane: each GCS process (primary or
    standby) exports its own view."""
    global _ha_metrics_cache
    if _ha_metrics_cache is None:
        from ray_tpu_torch.util.metrics import Counter, Gauge

        _ha_metrics_cache = (
            Gauge(
                "ray_tpu_gcs_replication_lag_seconds",
                description="how far the standby's replication-log tail "
                "trails the primary's mutation head (0 = fully caught up; "
                "measured at the long-poll ack on the primary and at the "
                "tail loop on the standby)",
            ),
            Counter(
                "ray_tpu_gcs_failovers_total",
                description="control-plane failovers: standby promotions "
                "to primary after the primary's lease expired",
            ),
        )
    return _ha_metrics_cache


@dataclass
class NodeEntry:
    node_id: str
    addr: tuple  # (host, port) of the node daemon
    resources: dict  # name -> total
    available: dict  # name -> available (as last reported)
    labels: dict = field(default_factory=dict)
    alive: bool = True
    draining: bool = False  # graceful drain: alive but not schedulable
    last_hb: float = field(default_factory=time.monotonic)
    pending: list = field(default_factory=list)  # queued lease specs
    # set on snapshot restore: the entry is a (possibly stale) claim, not
    # ground truth — the node's next heartbeat is answered with
    # `reregister` so it re-reports its live workers/actors/leases/PG
    # bundles and the reconcile path converges the table to reality
    pending_reconcile: bool = False


@dataclass
class ActorEntry:
    actor_id: bytes
    name: Optional[str]
    namespace: str
    node_id: Optional[str]
    worker_addr: Optional[tuple]
    state: str = "PENDING"  # PENDING | ALIVE | RESTARTING | DEAD
    max_restarts: int = 0
    num_restarts: int = 0
    # enough to re-create the actor elsewhere on node death
    creation_spec: Optional[bytes] = None
    owner_addr: Optional[tuple] = None
    lease_resources: dict = field(default_factory=lambda: {"num_cpus": 1})
    # the lease currently backing the actor's dedicated worker, and the
    # daemon that granted it — kill must release it THERE (reference:
    # GcsActorManager tracks the actor's leased worker per node)
    lease_id: Optional[str] = None
    node_addr: Optional[tuple] = None


class GcsService:
    """RPC handler. All methods take (payload, peer)."""

    def __init__(self, node_death_timeout_s: float = 5.0,
                 persist_path: Optional[str] = None,
                 role: str = "primary"):
        # one RLock domain serializes every table (the sharding roadmap's
        # bottleneck); TimedRLock feeds hold/wait histograms when
        # lockstats.enable_lock_timing() is on, raw-RLock cost otherwise
        self._lock = TimedRLock("gcs")
        # -- HA identity (cluster/ha.py) ----------------------------------
        # role/term/fenced under their own small lock so the RPC layer's
        # per-request ha_fence/ha_term checks never contend on the table
        # lock. Lock order: table lock OUTER, _ha_lock INNER — never the
        # reverse.
        self._ha_lock = threading.Lock()
        self._ha = {
            "role": role,
            "term": 0,
            "fenced": False,
            "failovers_total": 0,
            "fenced_writes_total": 0,
            "fenced_persists_total": 0,
        }
        # replication log: every critical mutation as (seq, term, op,
        # data), tailed by the warm standby over repl_since. Bounded like
        # the event ring; a tailer that falls off the retained window is
        # told to resync from a snapshot.
        self._repl: list[tuple[int, int, str, dict]] = []
        self._repl_seq = itertools.count(1)
        self._repl_head = 0
        self._repl_dropped = 0    # highest seq trimmed out of the log
        self._repl_acked = 0      # highest seq any tailer has consumed
        self._repl_synced_ts: Optional[float] = None
        self._events_dropped = -1  # highest event seq trimmed from the ring
        self._nodes: dict[str, NodeEntry] = {}
        self._actors: dict[bytes, ActorEntry] = {}
        self._named: dict[tuple, bytes] = {}  # (ns, name) -> actor_id
        self._pgs: dict[bytes, dict] = {}
        self._kv: dict[str, dict[bytes, bytes]] = {}
        self._objects: dict[bytes, set[str]] = {}  # obj_id -> node_ids
        self._events: list[tuple[int, str, dict]] = []
        self._event_seq = itertools.count()
        # push-tier pubsub: subscribers long-poll `events_since` with a
        # wait budget; _emit wakes them (reference: GCS pubsub push via
        # long-poll channels, src/ray/pubsub/publisher.h)
        self._events_cv = threading.Condition(self._lock)
        self._death_timeout = node_death_timeout_s
        self._pg_counter = itertools.count()
        # fault tolerance: durable snapshot of the control-plane tables
        # (reference: Redis-backed GCS storage, redis_store_client.h:107,
        # replayed by gcs_init_data.cc on restart). Nodes re-register via
        # the heartbeat "reregister" path; actor/PG/KV state comes back
        # from the snapshot.
        self._persist_path = persist_path
        self._dirty = 0
        self._persisted = 0
        self._persist_io = threading.Lock()  # serializes snapshot installs
        # control-plane FT observability (r13): restart + reconcile-delta
        # counters for `ray_tpu status` — a blackout must show up as a
        # counted restart and explicit convergence deltas, not as
        # phantom-zero metrics. restarts_total rides the snapshot so it
        # is cumulative across the process's own restarts.
        self.ft = {
            "gcs_restarts_total": 0,
            "reconcile_nodes_reregistered": 0,
            "reconcile_actors_confirmed": 0,
            "reconcile_actors_resurrected": 0,
            "reconcile_actors_lost": 0,
            "reconcile_bundles_adopted": 0,
            "reconcile_bundles_orphaned": 0,
            "reconcile_leases_reported": 0,
            "reconcile_actors_stale_copies": 0,
        }
        # snapshot-ALIVE actors awaiting confirmation by their node's
        # re-registration report; grace-expired leftovers are buried by
        # reconcile_sweep instead of lingering as phantoms
        self._needs_confirm: set[bytes] = set()
        self._orphan_bundles: list[tuple] = []  # (daemon_addr, pg_id, idx)
        # stale actor copies a reconciling node reported after the actor
        # was restarted elsewhere: (daemon_addr, actor_id, lease_id) to
        # destroy in reconcile_sweep (killing the lease kills the
        # dedicated worker and the copy with it)
        self._stale_copies: list[tuple] = []
        self._restore_t: Optional[float] = None
        # the cluster-wide metrics plane (obs/telemetry.py): bounded
        # time-series per (reporter, metric, labels), fed by heartbeat
        # piggybacks and telemetry_push. Not persisted and not replicated:
        # metrics are a freshness surface, repopulated within one
        # reporting interval of a restart or a failover.
        self.telemetry = TelemetryStore()
        if persist_path:
            self._load_snapshot()

    # -- persistence ----------------------------------------------------------

    def _mark_dirty(self) -> None:
        if self._persist_path:
            self._dirty += 1

    def _load_snapshot(self) -> None:
        import pickle

        t0 = time.time()
        try:
            with open(self._persist_path, "rb") as f:
                snap = pickle.load(f)
        except (OSError, pickle.UnpicklingError, EOFError):
            return
        self._actors = snap.get("actors", {})
        self._named = snap.get("named", {})
        self._pgs = snap.get("pgs", {})
        self._kv = snap.get("kv", {})
        self.ft["gcs_restarts_total"] = int(snap.get("restarts_total", 0)) + 1
        with self._ha_lock:
            # the fencing term is durable: a restarted primary comes back
            # at its old term (still fenceable by a promoted standby), never
            # at term 0 where every zombie check would pass
            self._ha["term"] = max(self._ha["term"], int(snap.get("ha_term", 0)))
        # restored nodes are CLAIMS until they re-register: keep them
        # visible (their daemons are usually still alive and serving) but
        # answer their first heartbeat with `reregister` so the node
        # re-reports ground truth; the health sweep buries ones that
        # never come back within the death timeout
        for node_id, rec in snap.get("nodes", {}).items():
            self._nodes[node_id] = NodeEntry(
                node_id=node_id,
                addr=tuple(rec["addr"]),
                resources=dict(rec["resources"]),
                available=dict(rec["resources"]),
                labels=dict(rec.get("labels", {})),
                pending_reconcile=True,
            )
        self._needs_confirm = {
            a.actor_id for a in self._actors.values() if a.state == "ALIVE"
        }
        self._reserve_placed_bundles_locked()
        self._restore_t = time.monotonic()
        logger.info(
            "GCS restored from snapshot (restart #%d): %d actors, %d pgs, "
            "%d kv namespaces, %d nodes pending reconcile",
            self.ft["gcs_restarts_total"], len(self._actors), len(self._pgs),
            len(self._kv), len(self._nodes),
        )
        try:
            from ray_tpu_torch.obs.recorder import get_recorder

            get_recorder().record(
                "gcs.restore", t0, time.time(),
                attrs={
                    "restart": str(self.ft["gcs_restarts_total"]),
                    "actors": str(len(self._actors)),
                    "pgs": str(len(self._pgs)),
                    "nodes": str(len(self._nodes)),
                },
            )
        except Exception:  # noqa: BLE001 — tracing must never break restore
            pass

    def _reserve_placed_bundles_locked(self) -> None:
        """Re-deduct placed PG bundles from restored nodes' availability.

        Restored/replicated nodes come back as reconcile claims with
        ``available = resources`` — the daemon's next full report is the
        ground truth that overwrites it. But until that report lands,
        placement would see inflated capacity and could double-book a
        fresh PG against bundles a CREATED group already holds on the
        node. Rebuild ``available`` as resources minus every placed
        bundle of a live group; the heartbeat's wholesale ``available``
        report converges any remaining drift."""
        for e in self._nodes.values():
            e.available = dict(e.resources)
        for pg in self._pgs.values():
            if pg["state"] not in ("CREATED", "RESCHEDULING"):
                continue
            for b in pg["bundles"]:
                node = self._nodes.get(b.get("node_id"))
                if node is None:
                    continue
                for k, v in b["resources"].items():
                    node.available[k] = node.available.get(k, 0.0) - v

    def _snapshot_state_locked(self) -> tuple[int, dict]:
        """(generation, shallow-copied durable tables). Caller holds the
        table lock — only the O(entries) dict copies happen under it;
        the pickle of the (potentially large) values runs outside, so a
        critical persist can't stretch the lock past what heartbeat
        handlers tolerate. Entries mutated after the copy may pickle
        torn across fields; the reconcile path converges those."""
        return self._dirty, {
            "actors": dict(self._actors),
            "named": dict(self._named),
            "pgs": {k: dict(v) for k, v in self._pgs.items()},
            # the collective rendezvous namespace is EPHEMERAL by design:
            # round contributions are multi-MB gradient payloads (every
            # write-ahead critical persist would ship them), and they are
            # gen-scoped in-flight state — after a restart the round is
            # gone, ranks surface typed CollectiveErrors within their
            # bounded waits, and the supervisor rides it out as a
            # blackout (re-form at gen+1, restore, resume)
            "kv": {ns: dict(kv) for ns, kv in self._kv.items()
                   if ns != "__collective__"},
            "nodes": {
                e.node_id: {
                    "addr": tuple(e.addr),
                    "resources": dict(e.resources),
                    "labels": dict(e.labels),
                }
                for e in self._nodes.values() if e.alive
            },
            "restarts_total": self.ft["gcs_restarts_total"],
            "ha_term": self.ha_term(),
        }

    def _write_snapshot(self, gen: int, doc: dict) -> None:
        """Crash-atomic snapshot install (.tmp + os.replace — the r12
        checkpoint discipline): a crash mid-write leaves the previous
        complete snapshot in place, never a torn file. Serialized by the
        persist I/O lock: handlers run on a thread pool, and two
        concurrent critical persists sharing one .tmp path could
        interleave writes or install an OLDER generation over a newer
        acked one — exactly the dirty window write-ahead exists to
        close. A generation at/behind what's already on disk is skipped
        (same-gen builds see identical tables)."""
        import pickle

        snap = pickle.dumps(doc)
        with self._persist_io:
            if gen <= self._persisted:
                return
            with self._ha_lock:
                if self._ha["fenced"]:
                    # a deposed primary must not install snapshots: the
                    # promoted one owns the durable state, and a late
                    # persist here would bring pre-failover tables back on
                    # the next restart (split brain on disk)
                    self._ha["fenced_persists_total"] += 1
                    logger.warning("GCS fenced at term %d: snapshot persist rejected",
                                   self._ha["term"])
                    return
            tmp = self._persist_path + ".tmp"
            try:
                with open(tmp, "wb") as f:
                    f.write(snap)
                    f.flush()
                    # fsync BEFORE the rename: os.replace is atomic in the
                    # namespace but says nothing about the DATA being on
                    # disk — without this, a power loss after the rename
                    # can leave the new name pointing at zero-length/torn
                    # content, which is exactly the loss the write-ahead
                    # ack (persist_critical) promised could not happen
                    os.fsync(f.fileno())
                os.replace(tmp, self._persist_path)
                # then fsync the directory so the rename itself is durable
                dfd = os.open(
                    os.path.dirname(os.path.abspath(self._persist_path)),
                    os.O_RDONLY,
                )
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
                self._persisted = gen
            except OSError:
                logger.exception("GCS snapshot write failed")

    def persist_if_dirty(self) -> None:
        """Debounced snapshot write (driven by the server's sweeper) —
        the non-critical tables' path. Critical mutations (actor/node
        registration, PG creation) go through persist_critical instead
        and never wait for this sweep."""
        if not self._persist_path:
            return
        with self._lock:
            if self._dirty == self._persisted:
                return
            gen, doc = self._snapshot_state_locked()
        self._write_snapshot(gen, doc)

    def persist_critical(self) -> None:
        """Write-ahead ack: persist NOW, before the caller's RPC is
        acknowledged. Closes the dirty window where an acked
        registration existed only in memory until the next debounced
        sweep — a crash in that window silently lost the actor."""
        if not self._persist_path:
            return
        with self._lock:
            gen, doc = self._snapshot_state_locked()
        self._write_snapshot(gen, doc)

    # -- HA: fencing term + replication log (cluster/ha.py) -------------------

    # methods a fenced/standby GCS still answers: diagnostics and the
    # replication plane itself (the standby must be able to tail a
    # primary that was just fenced, and status must stay queryable)
    _FENCE_EXEMPT = frozenset({
        "ha_status", "repl_since", "repl_snapshot", "gcs_ft",
        "telemetry_status", "telemetry_prometheus", "events_since",
    })
    # read-only methods: rejected when fenced (stale data) but not
    # counted as fenced WRITES — the split-brain acceptance gate counts
    # rejected mutations, not rejected reads
    _FENCE_READS = frozenset({
        "get_actor", "get_named_actor", "list_actors", "list_nodes",
        "list_pgs", "kv_get", "kv_keys", "kv_wait", "locate_object",
        "locate_many", "telemetry_slo", "telemetry_perf",
        "kvtier_lookup", "kvtier_stats", "cluster_demand",
        "autoscale_signals",
    })

    def ha_term(self) -> int:
        """Current fencing term — stamped into every RPC response by
        RpcServer._dispatch."""
        with self._ha_lock:
            return self._ha["term"]

    def ha_fence(self, hterm: int, method: str):
        """Envelope-level fencing check, called by RpcServer BEFORE the
        handler runs. A request carrying a term above ours proves a
        standby was promoted while we were alive: we are the zombie half
        of a split brain and must stop mutating. Returns None to admit
        the call, or the exception to answer with."""
        with self._ha_lock:
            if hterm > self._ha["term"]:
                if not self._ha["fenced"]:
                    logger.warning(
                        "GCS fenced: request carries term %d > own term %d "
                        "— a standby promoted; this process is a zombie",
                        hterm, self._ha["term"],
                    )
                self._ha["fenced"] = True
            if not self._ha["fenced"] or method in self._FENCE_EXEMPT:
                return None
            if method not in self._FENCE_READS:
                self._ha["fenced_writes_total"] += 1
            term = self._ha["term"]
        return NotPrimaryError(
            f"GCS fenced at term {term}: {method!r} rejected "
            f"(a newer primary holds term >= {hterm})",
            term=term,
        )

    def _repl_append_locked(self, op: str, data: dict) -> None:
        """Append one mutation to the replication log (caller holds the
        table lock) and wake long-polling tailers."""
        seq = next(self._repl_seq)
        with self._ha_lock:
            term = self._ha["term"]
        self._repl.append((seq, term, op, data))
        self._repl_head = seq
        if len(self._repl) > 20000:
            self._repl_dropped = self._repl[9999][0]
            del self._repl[:10000]
        self._events_cv.notify_all()

    def _repl_from_event_locked(self, kind: str, data: dict) -> None:
        """Translate an emitted event into a replication-log entry. The
        event stream says *something changed*; the log entry carries the
        full row so the standby can apply it without a read-back."""
        if kind == "actor_update":
            a = self._actors.get(data["actor_id"])
            if a is not None:
                self._repl_append_locked("actor_put", self._actor_info(a))
        elif kind == "node_added":
            e = self._nodes.get(data["node_id"])
            if e is not None:
                self._repl_append_locked("node_put", {
                    "node_id": e.node_id,
                    "addr": tuple(e.addr),
                    "resources": dict(e.resources),
                    "labels": dict(e.labels),
                })
        elif kind in ("node_dead", "node_draining"):
            self._repl_append_locked(kind, dict(data))
        elif kind == "pg_update":
            pg = self._pgs.get(data["pg_id"])
            if pg is None or pg["state"] == "REMOVED":
                self._repl_append_locked(
                    "pg_remove", {"pg_id": data["pg_id"]}
                )
            else:
                self._repl_append_locked("pg_put", self._pg_repl(pg))

    def _pg_repl(self, pg: dict) -> dict:
        """PG row as shipped on the replication log: the client-facing
        info plus the reserve bookkeeping a promoted standby needs to
        keep running the pg_reserve_sweep."""
        info = self._pg_info(pg)
        info["needs_reserve"] = bool(pg.get("needs_reserve"))
        info["reserve_gen"] = int(pg.get("reserve_gen", 0))
        return info

    def rpc_repl_since(self, payload, peer):
        """Replication-log long-poll: the standby's tail. Same cursor
        contract as events_since, plus the resync verdict — a tailer
        whose cursor fell off the retained window must re-bootstrap from
        repl_snapshot instead of silently skipping the gap."""
        cursor = int(payload["cursor"])
        wait = min(float(payload.get("wait", 0.0)), 10.0)
        deadline = time.monotonic() + wait
        with self._lock:
            if cursor <= self._repl_dropped:
                return {
                    "entries": [], "cursor": self._repl_head + 1,
                    "resync": True, "term": self.ha_term(),
                    "head": self._repl_head,
                }
            while True:
                out = [e for e in self._repl if e[0] >= cursor]
                if out or wait <= 0:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._events_cv.wait(remaining)
            next_cursor = out[-1][0] + 1 if out else cursor
            self._repl_acked = max(self._repl_acked, next_cursor - 1)
            if self._repl_acked >= self._repl_head:
                self._repl_synced_ts = time.monotonic()
            head = self._repl_head
        self._set_lag_metric_locked_free()
        return {
            "entries": out, "cursor": next_cursor, "resync": False,
            "term": self.ha_term(), "head": head,
        }

    def rpc_repl_snapshot(self, payload, peer):
        """Snapshot bootstrap/resync for a standby tailer: full durable
        tables + the cursor at which the log continues them."""
        with self._lock:
            _gen, doc = self._snapshot_state_locked()
            cursor = self._repl_head + 1
            self._repl_acked = self._repl_head
            self._repl_synced_ts = time.monotonic()
        return {"doc": doc, "cursor": cursor, "term": self.ha_term()}

    def _replication_lag_s(self) -> Optional[float]:
        """None = no tailer has ever synced; 0.0 = caught up; else the
        age of the last moment the tail was at head."""
        with self._lock:
            if self._repl_synced_ts is None:
                return None
            if self._repl_acked >= self._repl_head:
                return 0.0
            return time.monotonic() - self._repl_synced_ts

    def _set_lag_metric_locked_free(self) -> None:
        lag = self._replication_lag_s()
        if lag is not None:
            register_metrics()[0].set(lag)

    def rpc_ha_status(self, payload, peer):
        """Role/term/replication view for `ray_tpu status` and the HA
        tests: who is primary, at what term, how far any tailer trails."""
        with self._lock:
            head = self._repl_head
            acked = self._repl_acked
        with self._ha_lock:
            out = {
                "role": self._ha["role"],
                "term": self._ha["term"],
                "fenced": self._ha["fenced"],
                "failovers_total": self._ha["failovers_total"],
                "fenced_writes_total": self._ha["fenced_writes_total"],
                "fenced_persists_total": self._ha["fenced_persists_total"],
            }
        out["replication_lag_s"] = self._replication_lag_s()
        out["repl_head"] = head
        out["repl_acked"] = acked
        return out

    # -- HA: standby-side application + promotion -----------------------------

    def repl_install_snapshot(self, doc: dict, cursor: int, term: int) -> None:
        """Install a primary's snapshot wholesale (standby bootstrap or
        post-gap resync). Nodes come in as reconcile CLAIMS, exactly like
        a restart restore — on promotion their daemons re-register and
        ground truth converges."""
        with self._lock:
            self._actors = dict(doc.get("actors", {}))
            self._named = dict(doc.get("named", {}))
            self._pgs = {k: dict(v) for k, v in doc.get("pgs", {}).items()}
            self._kv = {ns: dict(kv) for ns, kv in doc.get("kv", {}).items()}
            self.ft["gcs_restarts_total"] = int(doc.get("restarts_total", 0))
            self._nodes = {}
            for node_id, rec in doc.get("nodes", {}).items():
                self._nodes[node_id] = NodeEntry(
                    node_id=node_id,
                    addr=tuple(rec["addr"]),
                    resources=dict(rec["resources"]),
                    available=dict(rec["resources"]),
                    labels=dict(rec.get("labels", {})),
                    pending_reconcile=True,
                )
            with self._ha_lock:
                self._ha["term"] = max(
                    self._ha["term"], int(term), int(doc.get("ha_term", 0))
                )
            self._mark_dirty()

    def repl_apply(self, entries) -> int:
        """Apply tailed log entries in order; observes each entry's term
        so the standby's own term never trails the primary's."""
        applied = 0
        with self._lock:
            for _seq, term, op, data in entries:
                self._repl_apply_one_locked(op, data)
                with self._ha_lock:
                    if term > self._ha["term"]:
                        self._ha["term"] = int(term)
                applied += 1
            if applied:
                self._mark_dirty()
        return applied

    def _repl_apply_one_locked(self, op: str, data: dict) -> None:
        if op == "actor_put":
            aid = data["actor_id"]
            a = ActorEntry(
                actor_id=aid,
                name=data.get("name"),
                namespace=data.get("namespace", "default"),
                node_id=data.get("node_id"),
                worker_addr=tuple(data["worker_addr"])
                if data.get("worker_addr") else None,
                state=data.get("state", "PENDING"),
                max_restarts=int(data.get("max_restarts", 0)),
                num_restarts=int(data.get("num_restarts", 0)),
                creation_spec=data.get("creation_spec"),
                owner_addr=tuple(data["owner_addr"])
                if data.get("owner_addr") else None,
                lease_resources=dict(
                    data.get("lease_resources") or {"num_cpus": 1}
                ),
                lease_id=data.get("lease_id"),
                node_addr=tuple(data["node_addr"])
                if data.get("node_addr") else None,
            )
            self._actors[aid] = a
            if a.name:
                self._named[(a.namespace, a.name)] = aid
        elif op == "node_put":
            self._nodes[data["node_id"]] = NodeEntry(
                node_id=data["node_id"],
                addr=tuple(data["addr"]),
                resources=dict(data["resources"]),
                available=dict(data["resources"]),
                labels=dict(data.get("labels", {})),
                pending_reconcile=True,
            )
        elif op == "node_dead":
            e = self._nodes.get(data["node_id"])
            if e is not None:
                e.alive = False
        elif op == "node_draining":
            e = self._nodes.get(data["node_id"])
            if e is not None:
                e.draining = True
        elif op == "pg_put":
            self._pgs[data["pg_id"]] = {
                "pg_id": data["pg_id"],
                "bundles": [dict(b) for b in data["bundles"]],
                "strategy": data["strategy"],
                "state": data["state"],
                "name": data.get("name"),
                "needs_reserve": bool(data.get("needs_reserve")),
                "reserve_gen": int(data.get("reserve_gen", 0)),
            }
        elif op == "pg_remove":
            self._pgs.pop(data["pg_id"], None)
        elif op == "kv_put":
            self._kv.setdefault(data["ns"], {})[data["key"]] = data["value"]
            self._events_cv.notify_all()
        elif op == "kv_del":
            self._kv.get(data["ns"], {}).pop(data["key"], None)
        # unknown ops are skipped: forward compatibility with a newer
        # primary shipping ops this standby build doesn't know

    def promote(self, term: Optional[int] = None) -> int:
        """Standby -> primary. Bumps the fencing term past everything
        seen, then runs the restart-restore discipline over the
        replicated tables: every node becomes a reconcile claim with a
        fresh heartbeat lease, every ALIVE actor awaits confirmation, and
        the grace clock starts — the reconcile sweep converges whatever
        the log missed. Persists critically so the new term is durable
        before the first client is acked at it."""
        with self._lock:
            with self._ha_lock:
                new_term = max(self._ha["term"] + 1, int(term or 0))
                self._ha["term"] = new_term
                self._ha["role"] = "primary"
                self._ha["fenced"] = False
                self._ha["failovers_total"] += 1
            now = time.monotonic()
            for e in self._nodes.values():
                e.pending_reconcile = True
                e.last_hb = now  # fresh lease: death clock starts NOW
            self._needs_confirm = {
                a.actor_id for a in self._actors.values()
                if a.state == "ALIVE"
            }
            self._reserve_placed_bundles_locked()
            self._restore_t = now
            self._mark_dirty()
            self._events_cv.notify_all()
        self.persist_critical()
        register_metrics()[1].inc()
        logger.warning(
            "GCS standby PROMOTED to primary at term %d (%d nodes pending "
            "reconcile, %d actors pending confirm)",
            new_term, len(self._nodes), len(self._needs_confirm),
        )
        return new_term

    # -- events ---------------------------------------------------------------

    def _emit(self, kind: str, data: dict) -> None:
        self._events.append((next(self._event_seq), kind, data))
        if len(self._events) > 10000:
            self._events_dropped = self._events[4999][0]
            del self._events[:5000]
        # critical mutations surface as events; mirror them onto the
        # replication log (full-row entries) before waking subscribers
        self._repl_from_event_locked(kind, data)
        self._events_cv.notify_all()

    def rpc_events_since(self, payload, peer):
        """Cursor'd event feed. With `wait` > 0 this is a long-poll: the
        handler thread parks until an event at/after `cursor` lands or
        the wait budget expires — push-latency delivery without a
        persistent subscriber channel (reference: GCS pubsub long-poll,
        src/ray/pubsub/publisher.h).

        A `resync: true` verdict means the cursor fell below the oldest
        retained event (the ring trimmed past it): events were LOST to
        this subscriber, and anything mirroring state off the feed must
        rebuild from a full read instead of continuing the tail."""
        cursor = payload["cursor"]
        # cap well below RpcClient's 30s default call timeout: a quiet
        # feed must answer (empty) before the client gives up on the RPC
        wait = min(float(payload.get("wait", 0.0)), 10.0)
        deadline = time.monotonic() + wait
        with self._lock:
            if cursor <= self._events_dropped:
                next_cursor = (
                    self._events[0][0] if self._events
                    else self._events_dropped + 1
                )
                return {"events": [], "cursor": next_cursor, "resync": True}
            while True:
                out = [e for e in self._events if e[0] >= cursor]
                if out or wait <= 0:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._events_cv.wait(remaining)
            next_cursor = self._events[-1][0] + 1 if self._events else cursor
        return {"events": out, "cursor": next_cursor, "resync": False}

    # -- nodes ----------------------------------------------------------------

    def rpc_register_node(self, payload, peer):
        with self._lock:
            e = NodeEntry(
                node_id=payload["node_id"],
                addr=tuple(payload["addr"]),
                resources=dict(payload["resources"]),
                available=dict(payload["resources"]),
                labels=payload.get("labels", {}),
            )
            self._nodes[e.node_id] = e
            # re-registration after a GCS restart rebuilds the object
            # directory from the node's own inventory (the reference
            # relearns locations via raylet resubscription)
            for oid in payload.get("objects", ()):
                self._objects.setdefault(oid, set()).add(e.node_id)
            if "actors" in payload or "bundles" in payload:
                # report-carrying registration = a RE-registration (fresh
                # nodes never send reports) — counted even when the
                # snapshot didn't know the node (lost/stale snapshot)
                self.ft["reconcile_nodes_reregistered"] += 1
            # reconcile-on-restart: converge the (possibly stale) snapshot
            # to the node's reported ground truth — live actors are
            # confirmed or resurrected, never killed; reported bundle
            # reservations are adopted, never double-reserved; a
            # snapshot-ALIVE actor this node did NOT report is gone and
            # takes the normal node-death path (restart budget or bury)
            if "actors" in payload or "bundles" in payload:
                self._reconcile_node_report_locked(e, payload)
            self._mark_dirty()
            self._emit("node_added", {"node_id": e.node_id, "addr": e.addr})
            logger.info("node %s registered at %s", e.node_id, e.addr)
        # node registration is a critical mutation: persist BEFORE the ack
        # (write-ahead) so a crash right after cannot forget the node
        self.persist_critical()
        return {"ok": True}

    def _reconcile_node_report_locked(self, e: NodeEntry, payload) -> None:
        """Apply a re-registering node's {actors, leases, bundles} report
        (caller holds the lock) — the r09 pg_reserve_sweep generalized
        into full reconciliation."""
        reported: set[bytes] = set()
        for rec in payload.get("actors", ()):
            aid = rec["actor_id"]
            reported.add(aid)
            a = self._actors.get(aid)
            if a is not None and a.state == "DEAD":
                # tombstone wins: the kill was acked; a worker whose
                # destroy raced the outage must not resurrect it
                continue
            if a is None:
                # created after the last snapshot (or the snapshot was
                # lost): the data plane is ground truth — resurrect
                a = ActorEntry(
                    actor_id=aid,
                    name=rec.get("name"),
                    namespace=rec.get("namespace", "default"),
                    node_id=e.node_id,
                    worker_addr=tuple(rec["worker_addr"])
                    if rec.get("worker_addr") else None,
                    state="ALIVE",
                    max_restarts=int(rec.get("max_restarts", 0)),
                    creation_spec=rec.get("creation_spec"),
                    lease_resources=dict(
                        rec.get("lease_resources") or {"num_cpus": 1}
                    ),
                    lease_id=rec.get("lease_id"),
                    node_addr=e.addr,
                )
                self._actors[aid] = a
                if a.name and (a.namespace, a.name) not in self._named:
                    self._named[(a.namespace, a.name)] = aid
                self.ft["reconcile_actors_resurrected"] += 1
                self._emit("actor_update", {"actor_id": aid, "state": "ALIVE"})
            else:
                cur = self._nodes.get(a.node_id) if a.node_id else None
                if (
                    a.state == "ALIVE"
                    and a.node_id is not None
                    and a.node_id != e.node_id
                    and cur is not None and cur.alive
                    and not cur.pending_reconcile
                ):
                    # the table's binding is NEWER ground truth: this
                    # actor was already restarted on another live node
                    # (e.g. while the reporter was partitioned and
                    # declared dead). Repointing here would leave two
                    # live copies — instead the reported stale copy is
                    # destroyed by the reconcile sweep
                    self._stale_copies.append(
                        (e.addr, aid, rec.get("lease_id"))
                    )
                    self.ft["reconcile_actors_stale_copies"] += 1
                    continue
                a.state = "ALIVE"
                a.node_id = e.node_id
                if rec.get("worker_addr"):
                    a.worker_addr = tuple(rec["worker_addr"])
                if rec.get("lease_id"):
                    a.lease_id = rec["lease_id"]
                a.node_addr = e.addr
                self.ft["reconcile_actors_confirmed"] += 1
                # no event fires for a silent confirm, but the binding
                # (node/worker/lease) may have changed: replicate it
                self._repl_append_locked("actor_put", self._actor_info(a))
            self._needs_confirm.discard(aid)
        # snapshot-ALIVE actors homed on THIS node that it did not report
        # are gone with the outage: normal node-death treatment, now
        for a in self._actors.values():
            if (
                a.actor_id in self._needs_confirm
                and a.node_id == e.node_id
                and a.actor_id not in reported
            ):
                self._needs_confirm.discard(a.actor_id)
                self.ft["reconcile_actors_lost"] += 1
                self._bury_or_restart_locked(a)
        for rec in payload.get("bundles", ()):
            pg = self._pgs.get(rec["pg_id"])
            idx = int(rec["bundle_index"])
            if (
                pg is None or pg["state"] == "REMOVED"
                or idx >= len(pg["bundles"])
            ):
                # reservation for a PG the table no longer knows: the
                # daemon still holds the resources — release them via the
                # reconcile sweep (needs the RPC pool, not held here)
                self._orphan_bundles.append((e.addr, rec["pg_id"], idx))
                self.ft["reconcile_bundles_orphaned"] += 1
                continue
            b = pg["bundles"][idx]
            b["node_id"] = e.node_id  # daemon-held reservation wins
            self.ft["reconcile_bundles_adopted"] += 1
            self._repl_append_locked("pg_put", self._pg_repl(pg))
        self.ft["reconcile_leases_reported"] += len(payload.get("leases", ()))

    def _bury_or_restart_locked(self, a: ActorEntry) -> None:
        """Node-death treatment for one actor (caller holds the lock)."""
        if a.state not in ("ALIVE", "PENDING"):
            return
        if a.num_restarts < a.max_restarts:
            a.state = "RESTARTING"
            a.num_restarts += 1
            a.node_id = None
            a.worker_addr = None
        else:
            a.state = "DEAD"
        self._emit(
            "actor_update",
            {"actor_id": a.actor_id, "state": a.state,
             "num_restarts": a.num_restarts},
        )

    def _heartbeat_locked(self, payload) -> dict:
        """Table-side of one heartbeat; caller holds ``self._lock``.
        Telemetry piggybacks are the CALLER's job (outside the table
        lock: the store has its own) — and only for accepted beats, so a
        node told to re-register never sneaks metrics in under a stale
        registration."""
        e = self._nodes.get(payload["node_id"])
        if e is None or not e.alive:
            # unknown/dead node: tell it to re-register (GCS restart or
            # it was declared dead while partitioned)
            return {"ok": False, "reregister": True}
        if e.pending_reconcile:
            # restored-from-snapshot claim: keep the lease fresh (the
            # node IS alive — it just proved it) but demand a full
            # re-registration so its ground-truth report arrives
            e.last_hb = time.monotonic()
            return {"ok": False, "reregister": True}
        e.last_hb = time.monotonic()
        if "available" in payload:
            e.available = dict(payload["available"])
        e.pending = list(payload.get("pending", ()))
        if payload.get("draining") and not e.draining:
            e.draining = True
            self._emit("node_draining", {"node_id": e.node_id})
        return {"ok": True}

    def rpc_heartbeat(self, payload, peer):
        with self._lock:
            out = self._heartbeat_locked(payload)
        snap = payload.get("telemetry")
        if snap and out.get("ok"):
            # piggybacked metrics snapshot (outside the table lock: the
            # store has its own); a STALL_HEARTBEAT partition shows up as
            # telemetry staleness for exactly the stalled node
            self.telemetry.ingest(
                payload["node_id"], snap, {"kind": "node"}
            )
        return out

    def rpc_heartbeat_batch(self, payload, peer):
        """Coalesced heartbeat frame (control-plane batching): N
        heartbeats under ONE table-lock acquisition, their telemetry
        piggybacks under ONE store-lock acquisition
        (TelemetryStore.ingest_batch). Per-beat semantics — reregister
        demands, draining transitions, stale-seq drops — are identical
        to N individual ``heartbeat`` calls; results keep frame order."""
        beats = list(payload.get("heartbeats", ()))
        with self._lock:
            results = [self._heartbeat_locked(hb) for hb in beats]
        telem = [
            (hb["node_id"], hb["telemetry"], {"kind": "node"})
            for hb, r in zip(beats, results)
            if r.get("ok") and hb.get("telemetry")
        ]
        if telem:
            self.telemetry.ingest_batch(telem)
        return {"ok": True, "results": results}

    # -- telemetry plane ------------------------------------------------------

    def rpc_telemetry_push(self, payload, peer):
        """Dedicated push path for engine hosts / serving processes (node
        daemons piggyback on heartbeats instead). Drops/delays of this
        RPC may only cost freshness: snapshots carry monotonic totals."""
        return self.telemetry.ingest(
            payload["reporter_id"],
            payload["snapshot"],
            {"kind": payload.get("kind", ""), "role": payload.get("role", "")},
        )

    def rpc_telemetry_cluster(self, payload, peer):
        """GCS-aggregated cluster metrics (ClusterClient.cluster_metrics):
        counter sums and rates, gauge rollups, merged histograms,
        per-reporter staleness."""
        return self.telemetry.cluster_metrics()

    def rpc_telemetry_slo(self, payload, peer):
        th = SLOThresholds.from_dict((payload or {}).get("thresholds"))
        return self.telemetry.slo_report(th)

    def rpc_telemetry_prometheus(self, payload, peer):
        return self.telemetry.prometheus_text()

    def rpc_telemetry_perf(self, payload, peer):
        """Sampled-profiling rollup (obs.perfwatch): per-step times,
        coverage, MFU, overlap, regression grades — the dashboard
        /api/perf surface."""
        return self.telemetry.perf_health()

    def rpc_telemetry_status(self, payload, peer):
        """One-query cluster status (rendered by ``format_status``): node
        table + reporters + pool rollups + utilization + SLO grades +
        control-plane FT counters (restart/reconcile deltas — a blackout
        shows as a counted restart, not phantom-zero metrics)."""
        th = SLOThresholds.from_dict((payload or {}).get("thresholds"))
        out = {"nodes": self.rpc_list_nodes(None, peer)}
        out.update(self.telemetry.status_payload(th))
        out["gcs_ft"] = self.rpc_gcs_ft(None, peer)
        out["gcs_ha"] = self.rpc_ha_status(None, peer)
        return out

    def rpc_autoscale_signals(self, payload, peer):
        _unported("autoscaler signals (autoscale_signals)", PART_8)

    def rpc_cluster_demand(self, payload, peer):
        _unported("cluster demand (cluster_demand)", PART_8)

    # -- KV prefix index (part 3c) --------------------------------------------

    def rpc_kvtier_update(self, payload, peer):
        _unported("KV prefix index (kvtier_update)", PART_3C)

    def rpc_kvtier_lookup(self, payload, peer):
        _unported("KV prefix index (kvtier_lookup)", PART_3C)

    def rpc_kvtier_drop(self, payload, peer):
        _unported("KV prefix index (kvtier_drop)", PART_3C)

    def rpc_kvtier_stats(self, payload, peer):
        _unported("KV prefix index (kvtier_stats)", PART_3C)

    def rpc_gcs_ft(self, payload, peer):
        """Control-plane FT counters: restarts and reconcile deltas, and the
        HA failover and fence counters."""
        with self._lock:
            out = dict(self.ft)
            out["actors_pending_confirm"] = len(self._needs_confirm)
        with self._ha_lock:
            out["gcs_failovers_total"] = self._ha["failovers_total"]
            out["gcs_fenced_writes_total"] = self._ha["fenced_writes_total"]
            out["gcs_fenced_persists_total"] = self._ha["fenced_persists_total"]
        return out

    def rpc_drain_node(self, payload, peer):
        """Graceful removal (cluster_utils teardown)."""
        with self._lock:
            self._mark_dead(payload["node_id"], reason="drained")
        return {"ok": True}

    def rpc_list_nodes(self, payload, peer):
        with self._lock:
            return [
                {
                    "node_id": e.node_id,
                    "addr": e.addr,
                    "resources": dict(e.resources),
                    "available": dict(e.available),
                    "labels": dict(e.labels),
                    "alive": e.alive,
                    "draining": e.draining,
                }
                for e in self._nodes.values()
            ]

    def _mark_dead(self, node_id: str, reason: str) -> None:
        e = self._nodes.get(node_id)
        if e is None or not e.alive:
            return
        e.alive = False
        logger.warning("node %s declared dead (%s)", node_id, reason)
        self._emit("node_dead", {"node_id": node_id, "reason": reason})
        # objects whose only copy was there are lost
        for oid, locs in list(self._objects.items()):
            locs.discard(node_id)
            if not locs:
                del self._objects[oid]
        # actors on that node: restart or bury (reference:
        # GcsActorManager::OnNodeDead)
        for a in self._actors.values():
            if a.node_id == node_id and a.state in ("ALIVE", "PENDING"):
                self._needs_confirm.discard(a.actor_id)
                self._bury_or_restart_locked(a)
        self._mark_dirty()
        # placement groups with bundles there reschedule
        for pg in self._pgs.values():
            if any(b.get("node_id") == node_id for b in pg["bundles"]):
                for b in pg["bundles"]:
                    if b.get("node_id") == node_id:
                        b["node_id"] = None
                pg["state"] = "RESCHEDULING"
                self._try_place_pg(pg)
                self._emit("pg_update", {"pg_id": pg["pg_id"], "state": pg["state"]})

    def health_sweep(self) -> None:
        with self._lock:
            now = time.monotonic()
            for e in list(self._nodes.values()):
                if e.alive and now - e.last_hb > self._death_timeout:
                    self._mark_dead(e.node_id, reason="heartbeat timeout")

    def restart_sweep(self, pool) -> None:
        """Re-create RESTARTING actors on surviving nodes (reference:
        GcsActorScheduler re-leases a worker for restartable actors)."""
        with self._lock:
            todo = [
                a for a in self._actors.values()
                if a.state == "RESTARTING" and a.creation_spec is not None
            ]
            nodes = [
                (e.node_id, e.addr, dict(e.available))
                for e in self._nodes.values() if e.alive and not e.draining
            ]
        for a in todo:
            res = a.lease_resources
            for node_id, addr, avail in nodes:
                if not all(avail.get(k, 0.0) >= v for k, v in res.items()):
                    continue
                try:
                    daemon = pool.get(tuple(addr))
                    r = daemon.call(
                        "request_worker_lease", {"resources": res}, timeout=60
                    )
                    if "grant" not in r:
                        continue
                    g = r["grant"]
                    w = pool.get(tuple(g["worker_addr"]))
                    cr = w.call(
                        "create_actor",
                        {"actor_id": a.actor_id, "creation_spec": a.creation_spec,
                         "meta": {"name": a.name, "namespace": a.namespace,
                                  "max_restarts": a.max_restarts,
                                  "lease_resources": dict(a.lease_resources)}},
                        timeout=300,
                    )
                    if not cr.get("ok"):
                        daemon.call(
                            "release_lease",
                            {"lease_id": g["lease_id"], "kill": True},
                            timeout=10,
                        )
                        logger.warning(
                            "actor %s restart failed: %s",
                            a.actor_id.hex()[:12], cr.get("error"),
                        )
                        continue
                    with self._lock:
                        if (
                            a.state == "ALIVE"
                            and a.worker_addr is not None
                            and tuple(a.worker_addr) != tuple(g["worker_addr"])
                        ):
                            # a reconcile report confirmed the ORIGINAL
                            # copy alive while this sweep was re-creating
                            # it (restore race): keep ground truth, kill
                            # the just-created duplicate with its lease
                            duplicate = True
                        else:
                            duplicate = False
                            a.node_id = g["node_id"]
                            a.worker_addr = tuple(g["worker_addr"])
                            a.lease_id = g["lease_id"]
                            a.node_addr = tuple(g.get("node_addr") or addr)
                            a.state = "ALIVE"
                            self._mark_dirty()
                            self._emit(
                                "actor_update",
                                {"actor_id": a.actor_id, "state": "ALIVE",
                                 "worker_addr": a.worker_addr},
                            )
                    if duplicate:
                        daemon.call(
                            "release_lease",
                            {"lease_id": g["lease_id"], "kill": True},
                            timeout=10,
                        )
                        logger.warning(
                            "actor %s: reconcile confirmed the original "
                            "copy; discarded duplicate restart",
                            a.actor_id.hex()[:12],
                        )
                        break
                    logger.info(
                        "actor %s restarted on %s",
                        a.actor_id.hex()[:12], g["node_id"],
                    )
                    break
                except (RpcError, RemoteError):
                    continue

    def reconcile_sweep(self, pool) -> None:
        """Post-restore convergence work that needs the RPC pool:

         * release orphaned bundle reservations a re-registering node
           reported for PGs the table no longer knows (their resources
           are otherwise leaked on the daemon forever);
         * after a grace period, bury snapshot-ALIVE actors whose node
           never re-registered to confirm them (the node itself is
           handled by the health sweep; this covers actors whose
           snapshot node entry was missing or stale)."""
        with self._lock:
            orphans, self._orphan_bundles = self._orphan_bundles, []
            stale, self._stale_copies = self._stale_copies, []
        for addr, pg_id, idx in orphans:
            try:
                pool.get(tuple(addr)).call(
                    "release_pg_bundle",
                    {"pg_id": pg_id, "bundle_index": idx},
                    timeout=10,
                )
            except (RpcError, RemoteError):
                pass  # daemon died; the reservation died with it
        for addr, aid, lease_id in stale:
            # kill the stale copy's lease on its own daemon: the worker
            # (and the duplicate actor in it) dies with the lease
            if not lease_id:
                continue
            try:
                pool.get(tuple(addr)).call(
                    "release_lease", {"lease_id": lease_id, "kill": True},
                    timeout=10,
                )
                logger.warning(
                    "reconcile: destroyed stale copy of actor %s",
                    aid.hex()[:12] if isinstance(aid, bytes) else aid,
                )
            except (RpcError, RemoteError):
                pass
        grace = max(2 * self._death_timeout, 3.0)
        with self._lock:
            # invariant: _needs_confirm is only read/cleared under _lock —
            # the restore path populates it concurrently with this sweep
            if self._restore_t is None or not self._needs_confirm:
                return
            if time.monotonic() - self._restore_t < grace:
                return
            stale, self._needs_confirm = self._needs_confirm, set()
            for aid in stale:
                a = self._actors.get(aid)
                if a is None or a.state not in ("ALIVE", "PENDING"):
                    continue
                node = self._nodes.get(a.node_id)
                if node is not None and node.alive and not node.pending_reconcile:
                    continue  # node re-registered and confirmed it already
                self.ft["reconcile_actors_lost"] += 1
                self._bury_or_restart_locked(a)
            if stale:
                self._mark_dirty()

    def pg_reserve_sweep(self, pool) -> None:
        """Reserve re-placed placement-group bundles on their new nodes
        (reference: the raylet-side two-phase commit the reference replays
        on reschedule). The daemon's reserve is idempotent by
        (pg_id, bundle_index), so surviving bundles are no-ops."""
        with self._lock:
            # snapshot bundles AND the placement generation under the
            # lock: the reserve RPCs below run lock-free, and a node
            # death mid-sweep re-places these same bundle dicts
            todo = [
                (pg, pg.get("reserve_gen", 0),
                 [(dict(b["resources"]), b.get("node_id"))
                  for b in pg["bundles"]])
                for pg in self._pgs.values()
                if pg.get("needs_reserve") and pg["state"] == "CREATED"
            ]
            nodes = {
                e.node_id: e.addr for e in self._nodes.values() if e.alive
            }
        for pg, gen, bundles in todo:
            all_ok = True
            for i, (res, node_id) in enumerate(bundles):
                addr = nodes.get(node_id)
                if addr is None:
                    all_ok = False
                    continue
                try:
                    r = pool.get(tuple(addr)).call(
                        "reserve_pg_bundle",
                        {"pg_id": pg["pg_id"], "bundle_index": i,
                         "resources": res},
                        timeout=10,
                    )
                    if not r.get("ok"):
                        all_ok = False
                except (RpcError, RemoteError):
                    all_ok = False
            if all_ok:
                with self._lock:
                    # clear ONLY if no re-placement raced the RPCs: a
                    # fresh needs_reserve (bumped generation) must survive
                    # or its bundles stay unleasable forever
                    if pg.get("reserve_gen", 0) == gen \
                            and pg["state"] == "CREATED":
                        pg["needs_reserve"] = False
                        self._mark_dirty()  # re-reservation is durable state
                logger.info(
                    "pg %s re-reserved after reschedule",
                    pg["pg_id"].hex()[:12] if isinstance(pg["pg_id"], bytes)
                    else pg["pg_id"],
                )

    # -- kv -------------------------------------------------------------------

    def rpc_kv_put(self, payload, peer):
        with self._lock:
            ns_name = payload.get("ns", "default")
            ns = self._kv.setdefault(ns_name, {})
            if payload.get("nx") and payload["key"] in ns:
                # set-if-absent: atomic claim primitive (job submission
                # ids, leader election) — check-then-put at the caller
                # races between clients
                return {"ok": False}
            ns[payload["key"]] = payload["value"]
            self._mark_dirty()
            if ns_name != "__collective__":
                # the collective rendezvous namespace is ephemeral and
                # multi-MB (see _snapshot_state_locked); everything else
                # replicates, so a promoted standby serves the same KV
                self._repl_append_locked("kv_put", {
                    "ns": ns_name, "key": payload["key"], "value": payload["value"],
                })
            self._events_cv.notify_all()  # wake kv_wait long-pollers
        return {"ok": True}

    def rpc_kv_wait(self, payload, peer):
        """Long-poll kv_get: park until `key` appears (or the wait budget
        expires) and return its value (None on timeout). Per-call wait is
        capped low so a fully parked handler pool self-heals; callers loop
        to their own deadline. This is the synchronization primitive the
        cluster-tier collectives rendezvous on (reference analog: Redis
        BLPOP-style waits in the GCS store client)."""
        deadline = time.monotonic() + min(float(payload.get("wait", 1.0)), 5.0)
        ns_name = payload.get("ns", "default")
        key = payload["key"]
        with self._lock:
            while True:
                v = self._kv.get(ns_name, {}).get(key)
                if v is not None:
                    return v
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._events_cv.wait(remaining)

    def rpc_kv_get(self, payload, peer):
        with self._lock:
            return self._kv.get(payload.get("ns", "default"), {}).get(payload["key"])

    def rpc_kv_del(self, payload, peer):
        with self._lock:
            ns_name = payload.get("ns", "default")
            self._kv.get(ns_name, {}).pop(payload["key"], None)
            self._mark_dirty()
            if ns_name != "__collective__":
                self._repl_append_locked("kv_del", {"ns": ns_name, "key": payload["key"]})
        return {"ok": True}

    def rpc_kv_keys(self, payload, peer):
        with self._lock:
            ns = self._kv.get(payload.get("ns", "default"), {})
            pre = payload.get("prefix", b"")
            return [k for k in ns if k.startswith(pre)]

    # -- object directory -----------------------------------------------------

    def rpc_add_object_location(self, payload, peer):
        with self._lock:
            self._objects.setdefault(payload["object_id"], set()).add(
                payload["node_id"]
            )
        return {"ok": True}

    def rpc_remove_object_location(self, payload, peer):
        with self._lock:
            locs = self._objects.get(payload["object_id"])
            if locs is not None:
                locs.discard(payload["node_id"])
                if not locs:
                    self._objects.pop(payload["object_id"], None)
        return {"ok": True}

    def rpc_locate_object(self, payload, peer):
        with self._lock:
            locs = self._objects.get(payload["object_id"], set())
            return [
                self._nodes[nid].addr
                for nid in locs
                if nid in self._nodes and self._nodes[nid].alive
            ]

    def rpc_locate_many(self, payload, peer):
        """Batched location probe: object_id -> [holder addrs]. One RPC
        for a whole wait() poll / batched-fetch round instead of one per
        ref (empty list = not available, truthiness works for wait)."""
        with self._lock:
            out = {}
            for oid in payload["object_ids"]:
                locs = self._objects.get(oid, set())
                out[oid] = [
                    self._nodes[nid].addr
                    for nid in locs
                    if nid in self._nodes and self._nodes[nid].alive
                ]
            return out

    # -- actors ---------------------------------------------------------------

    def rpc_register_actor(self, payload, peer):
        with self._lock:
            name, ns = payload.get("name"), payload.get("namespace", "default")
            prior = self._actors.get(payload["actor_id"])
            if prior is not None and prior.state != "DEAD":
                # duplicate delivery: the client retried after losing the
                # ack (GCS failover/timeout) but the registration already
                # took. Ack idempotently — re-creating the entry would
                # reset restart bookkeeping, and the name check below
                # would bounce our OWN registration as "taken"
                return {"ok": True, "duplicate": True}
            if name:
                existing = self._named.get((ns, name))
                if existing is not None and existing != payload["actor_id"]:
                    a = self._actors.get(existing)
                    if a is not None and a.state != "DEAD":
                        return {"ok": False, "error": f"name {name!r} taken"}
            a = ActorEntry(
                actor_id=payload["actor_id"],
                name=name,
                namespace=ns,
                node_id=payload.get("node_id"),
                worker_addr=tuple(payload["worker_addr"]) if payload.get("worker_addr") else None,
                state=payload.get("state", "PENDING"),
                max_restarts=payload.get("max_restarts", 0),
                creation_spec=payload.get("creation_spec"),
                owner_addr=tuple(payload["owner_addr"]) if payload.get("owner_addr") else None,
                lease_resources=dict(
                    payload.get("lease", {}).get("resources", {"num_cpus": 1})
                ),
                lease_id=payload.get("lease_id"),
                node_addr=tuple(payload["node_addr"]) if payload.get("node_addr") else None,
            )
            self._actors[a.actor_id] = a
            if name:
                self._named[(ns, name)] = a.actor_id
            self._mark_dirty()
            self._repl_append_locked("actor_put", self._actor_info(a))
        # write-ahead ack: the registration must be durable BEFORE the
        # client sees ok — killing the GCS between this ack and the next
        # debounced sweep used to silently lose the actor
        self.persist_critical()
        return {"ok": True}

    def rpc_update_actor(self, payload, peer):
        with self._lock:
            a = self._actors.get(payload["actor_id"])
            if a is None:
                return {"ok": False}
            for k in ("node_id", "state"):
                if k in payload:
                    setattr(a, k, payload[k])
            if "worker_addr" in payload:
                a.worker_addr = (
                    tuple(payload["worker_addr"]) if payload["worker_addr"] else None
                )
            self._emit(
                "actor_update", {"actor_id": a.actor_id, "state": a.state}
            )
            self._mark_dirty()
            died = a.state == "DEAD"
        if died:
            # a kill is a critical mutation too: an unpersisted tombstone
            # lets the reconcile path resurrect an actor the user killed
            self.persist_critical()
        return {"ok": True}

    def _actor_info(self, a: ActorEntry) -> dict:
        return {
            "actor_id": a.actor_id,
            "name": a.name,
            "namespace": a.namespace,
            "node_id": a.node_id,
            "worker_addr": a.worker_addr,
            "state": a.state,
            "max_restarts": a.max_restarts,
            "num_restarts": a.num_restarts,
            "creation_spec": a.creation_spec,
            "owner_addr": a.owner_addr,
            "lease_id": a.lease_id,
            "node_addr": a.node_addr,
            "lease_resources": dict(a.lease_resources),
        }

    def rpc_get_actor(self, payload, peer):
        with self._lock:
            a = self._actors.get(payload["actor_id"])
            return self._actor_info(a) if a else None

    def rpc_get_named_actor(self, payload, peer):
        with self._lock:
            aid = self._named.get(
                (payload.get("namespace", "default"), payload["name"])
            )
            a = self._actors.get(aid) if aid else None
            return self._actor_info(a) if a else None

    def rpc_list_actors(self, payload, peer):
        with self._lock:
            return [self._actor_info(a) for a in self._actors.values()]

    # -- placement groups -----------------------------------------------------

    def rpc_create_pg(self, payload, peer):
        """Place bundles against the resource view. Returns the placement
        (bundle index -> node) or state=PENDING when it doesn't fit."""
        with self._lock:
            prior = self._pgs.get(payload["pg_id"])
            if prior is not None and prior["state"] != "REMOVED":
                # duplicate delivery (retry across a failover/timeout):
                # re-placing would deduct node availability a SECOND time
                # for the same bundles — return the existing placement
                return self._pg_info(prior)
            pg = {
                "pg_id": payload["pg_id"],
                "bundles": [
                    {"resources": dict(b), "node_id": None}
                    for b in payload["bundles"]
                ],
                "strategy": payload.get("strategy", "PACK"),
                "state": "PENDING",
                "name": payload.get("name"),
            }
            self._pgs[pg["pg_id"]] = pg
            self._try_place_pg(pg)
            self._mark_dirty()
            self._repl_append_locked("pg_put", self._pg_repl(pg))
            info = self._pg_info(pg)
        # write-ahead ack (same contract as register_actor): the
        # reservation the client is about to make against this placement
        # must survive a control-plane crash after the ack
        self.persist_critical()
        return info

    def _try_place_pg(self, pg: dict) -> None:
        alive = [e for e in self._nodes.values() if e.alive and not e.draining]
        if not alive:
            return
        strategy = pg["strategy"]
        # work on a copy of the availability view; commit on success
        avail = {e.node_id: dict(e.available) for e in alive}

        def fits(node_id: str, res: dict) -> bool:
            a = avail[node_id]
            return all(a.get(k, 0.0) >= v for k, v in res.items())

        def take(node_id: str, res: dict) -> None:
            a = avail[node_id]
            for k, v in res.items():
                a[k] = a.get(k, 0.0) - v

        assignment: list[Optional[str]] = [None] * len(pg["bundles"])
        order = sorted(avail)  # deterministic
        if strategy in ("STRICT_PACK",):
            for nid in order:
                trial = dict(avail[nid])
                ok = True
                for b in pg["bundles"]:
                    if all(trial.get(k, 0.0) >= v for k, v in b["resources"].items()):
                        for k, v in b["resources"].items():
                            trial[k] = trial.get(k, 0.0) - v
                    else:
                        ok = False
                        break
                if ok:
                    assignment = [nid] * len(pg["bundles"])
                    break
        elif strategy in ("STRICT_SPREAD", "SPREAD"):
            used: set[str] = set()
            for i, b in enumerate(pg["bundles"]):
                placed = False
                for nid in order:
                    if nid in used and strategy == "STRICT_SPREAD":
                        continue
                    if fits(nid, b["resources"]):
                        take(nid, b["resources"])
                        assignment[i] = nid
                        used.add(nid)
                        placed = True
                        break
                if not placed and strategy == "SPREAD":
                    # SPREAD is best-effort: reuse nodes
                    for nid in order:
                        if fits(nid, b["resources"]):
                            take(nid, b["resources"])
                            assignment[i] = nid
                            placed = True
                            break
                if not placed:
                    assignment = [None] * len(pg["bundles"])
                    break
        else:  # PACK: prefer one node, overflow to others
            for i, b in enumerate(pg["bundles"]):
                placed = False
                for nid in order:
                    if fits(nid, b["resources"]):
                        take(nid, b["resources"])
                        assignment[i] = nid
                        placed = True
                        break
                if not placed:
                    assignment = [None] * len(pg["bundles"])
                    break

        if all(a is not None for a in assignment):
            for b, nid in zip(pg["bundles"], assignment):
                b["node_id"] = nid
            if pg["state"] == "RESCHEDULING":
                # node-death re-placement: the CLIENT reserved the original
                # bundles at create time, but nobody is waiting to reserve
                # the replacements — the pg_reserve_sweep must do it, or
                # every lease against the re-placed bundle fails with "no
                # bundle reserved here" forever (chaos-found bug). The
                # generation counter lets the sweep detect a re-placement
                # that raced its (lock-free) reserve RPCs.
                pg["needs_reserve"] = True
                pg["reserve_gen"] = pg.get("reserve_gen", 0) + 1
            pg["state"] = "CREATED"
            # deduct from the authoritative view so back-to-back PGs don't
            # double-book before the next heartbeat refreshes availability
            for b, nid in zip(pg["bundles"], assignment):
                node = self._nodes.get(nid)
                if node is not None:
                    for k, v in b["resources"].items():
                        node.available[k] = node.available.get(k, 0.0) - v

    def rpc_remove_pg(self, payload, peer):
        with self._lock:
            pg = self._pgs.pop(payload["pg_id"], None)
            if pg is not None:
                # restore the authoritative availability view NOW — waiting
                # for the next heartbeat (0.5s) would serialize PG churn
                # (create/remove rate) on the heartbeat period
                for b in pg["bundles"]:
                    node = self._nodes.get(b.get("node_id"))
                    if node is not None:
                        for k, v in b["resources"].items():
                            node.available[k] = node.available.get(k, 0.0) + v
                pg["state"] = "REMOVED"
                self._emit("pg_update", {"pg_id": pg["pg_id"], "state": "REMOVED"})
            self._mark_dirty()
        return {"ok": True}

    def rpc_get_pg(self, payload, peer):
        with self._lock:
            pg = self._pgs.get(payload["pg_id"])
            if pg is not None and pg["state"] in ("PENDING", "RESCHEDULING"):
                prev = pg["state"]
                self._try_place_pg(pg)  # retry on demand (nodes may have joined)
                if pg["state"] != prev:
                    # an on-demand placement is the same durable mutation
                    # a create is: persist (debounced) and replicate it
                    self._mark_dirty()
                    self._repl_append_locked("pg_put", self._pg_repl(pg))
            return self._pg_info(pg) if pg else None

    def rpc_list_pgs(self, payload, peer):
        with self._lock:
            return [self._pg_info(pg) for pg in self._pgs.values()]

    def _pg_info(self, pg: dict) -> dict:
        return {
            "pg_id": pg["pg_id"],
            "bundles": [dict(b) for b in pg["bundles"]],
            "strategy": pg["strategy"],
            "state": pg["state"],
            "name": pg.get("name"),
        }


def start_sweeper(service: GcsService, stop: threading.Event,
                  pool=None, period_s: float = 0.25) -> threading.Thread:
    """The serving primary's background loop: health leases, reconcile
    convergence, actor restarts, PG re-reservation, debounced persist.
    Shared by ``GcsServer`` and a promoted standby (``cluster/ha.py``): a
    promotion starts exactly this loop."""
    if pool is None:
        pool = ClientPool(timeout=120.0)

    def sweep():
        while not stop.wait(period_s):
            try:
                service.health_sweep()
                service.reconcile_sweep(pool)
                service.restart_sweep(pool)
                service.pg_reserve_sweep(pool)
                service.persist_if_dirty()
            except Exception:
                logger.exception("health sweep failed")

    t = threading.Thread(target=sweep, name="gcs-health", daemon=True)
    t.start()
    return t


class GcsServer:
    """GcsService + RpcServer + health sweeper, embeddable or standalone."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 node_death_timeout_s: float = 5.0,
                 persist_path: Optional[str] = None):
        self.service = GcsService(
            node_death_timeout_s=node_death_timeout_s,
            persist_path=persist_path,
        )
        self.rpc = RpcServer(self.service, host=host, port=port)
        self._pool = ClientPool(timeout=120.0)
        self._sweeper: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self) -> tuple[str, int]:
        addr = self.rpc.start()
        self._sweeper = start_sweeper(self.service, self._stop, pool=self._pool)
        return addr

    def stop(self) -> None:
        self._stop.set()
        if self._sweeper is not None:
            self._sweeper.join(timeout=5)
        self.rpc.stop()
        self._pool.close_all()


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--death-timeout", type=float, default=5.0)
    p.add_argument("--persist", default=None,
                   help="snapshot path for GCS fault tolerance")
    args = p.parse_args()
    server = GcsServer(args.host, args.port, args.death_timeout,
                       persist_path=args.persist)
    host, port = server.start()
    # parent discovers the bound port from stdout
    print(f"GCS_ADDRESS {host}:{port}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
