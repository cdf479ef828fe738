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

A copy of ``ray_tpu/cluster/gcs_service.py`` without what later parts of
ROADMAP.md Queue 1, item 6 bring; each of those RPCs raises
``NotImplementedError`` naming its part: the HA role, fencing term and
replication log (``repl_*``, ``ha_status``) and the telemetry plane
(``telemetry_*``, and no telemetry on heartbeats) wait for part 3b, the
KV prefix index (``kvtier_*``) for part 3c, and the autoscaler's inputs
(``autoscale_signals``, ``cluster_demand``) for part 8, and with them the
coalesced frames (``heartbeat_batch``, ``batch``) only the autoscaler's
control plane sends. This process never imports torch.
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
from ray_tpu_torch.cluster.rpc import ClientPool, RemoteError, RpcError, RpcServer
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.cluster.gcs")

PART_3B = "ROADMAP.md Queue 1, item 6, part 3b"
PART_3C = "ROADMAP.md Queue 1, item 6, part 3c"
PART_8 = "ROADMAP.md Queue 1, item 6, part 8"


def _unported(what: str, part: str):
    raise NotImplementedError(f"GCS {what} is not ported to ray_tpu_torch yet ({part})")


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
                 persist_path: Optional[str] = None):
        # one RLock domain serializes every table (the sharding roadmap's
        # bottleneck); TimedRLock feeds hold/wait histograms when
        # lockstats.enable_lock_timing() is on, raw-RLock cost otherwise
        self._lock = TimedRLock("gcs")
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

    # -- HA (part 3b) ---------------------------------------------------------

    def rpc_repl_since(self, payload, peer):
        _unported("replication log tail (repl_since)", PART_3B)

    def rpc_repl_snapshot(self, payload, peer):
        _unported("replication snapshot (repl_snapshot)", PART_3B)

    def rpc_ha_status(self, payload, peer):
        _unported("HA status (ha_status)", PART_3B)

    # -- events ---------------------------------------------------------------

    def _emit(self, kind: str, data: dict) -> None:
        self._events.append((next(self._event_seq), kind, data))
        if len(self._events) > 10000:
            self._events_dropped = self._events[4999][0]
            del self._events[:5000]
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
        """Table-side of one heartbeat; caller holds ``self._lock``. A
        telemetry piggyback waits for part 3b: a beat carrying one is
        accepted and the snapshot dropped."""
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
            return self._heartbeat_locked(payload)

    # -- telemetry plane (part 3b) --------------------------------------------

    def rpc_telemetry_push(self, payload, peer):
        _unported("telemetry (telemetry_push)", PART_3B)

    def rpc_telemetry_push_batch(self, payload, peer):
        _unported("telemetry (telemetry_push_batch)", PART_3B)

    def rpc_telemetry_cluster(self, payload, peer):
        _unported("telemetry (telemetry_cluster)", PART_3B)

    def rpc_telemetry_slo(self, payload, peer):
        _unported("telemetry (telemetry_slo)", PART_3B)

    def rpc_telemetry_prometheus(self, payload, peer):
        _unported("telemetry (telemetry_prometheus)", PART_3B)

    def rpc_telemetry_perf(self, payload, peer):
        _unported("telemetry (telemetry_perf)", PART_3B)

    def rpc_telemetry_status(self, payload, peer):
        _unported("telemetry (telemetry_status)", PART_3B)

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
        """Control-plane FT counters: restarts + reconcile deltas."""
        with self._lock:
            out = dict(self.ft)
            out["actors_pending_confirm"] = len(self._needs_confirm)
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
                    # a create is: persist it (debounced)
                    self._mark_dirty()
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
    """The GCS's background loop: health leases, reconcile convergence,
    actor restarts, PG re-reservation, debounced persist."""
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
