"""Per-node daemon: worker pool, lease protocol, object service.

Reference analog: the raylet (src/ray/raylet/node_manager.h:118 —
worker-lease handling at node_manager.cc:1915 HandleRequestWorkerLease,
WorkerPool worker_pool.h:125, object transfer via
src/ray/object_manager/object_manager.h:117). Redesigned:

 * leases: a submitter asks its local daemon for a worker; the daemon
   grants a dedicated worker process if the resources fit, otherwise
   answers with a spillback target chosen from the GCS resource view
   (the hybrid policy's "prefer local, spill to the best-fitting remote"
   leg, hybrid_scheduling_policy.h:29-49);
 * workers: real OS processes (spawned clean — no fork-after-JAX),
   each with its own RPC server for direct submitter->worker pushes;
 * objects: a per-node in-memory store; `fetch` pulls missing objects
   chunk-wise from a holder found via the GCS object directory and
   caches them locally (PullManager/PushManager collapsed into one
   chunked pull path);
 * placement-group bundles: reservations carve sub-pools out of the
   node's availability, keyed (pg_id, bundle_index).

A copy of ``ray_tpu/cluster/node_daemon.py`` with the card rule of the
port: a lease that holds ``"GPU"`` gets whole cards as
``core.scheduler.CardGrants`` gives them, and its worker is spawned with
``CUDA_VISIBLE_DEVICES`` naming them, set before anything in the worker
imports torch; a lease without gets ``CUDA_VISIBLE_DEVICES=""``, so its
worker never opens a CUDA context. Idle workers are pooled by runtime env
and by that value. A GPU lease on a daemon that sees fewer cards than its
``"GPU"`` resource claims fails, never runs on the CPU. The daemon itself
never imports torch. Its store file is ``ray_tpu_torch-store-{node}-{pid}``
(the reference's daemons, which may run beside it, use
``ray_tpu-store-``). Every ``telemetry_interval_s`` a heartbeat carries
a snapshot of the node's own gauges (``ray_tpu_node_*``, tagged with its
node id) to the GCS's telemetry store. The GCS address may name a primary
and its standby (``--gcs h1:p1,h2:p2``): the daemon's GCS client, and the
workers it spawns, follow the primary across a failover. A schedule the
driver exported (``chaos.install(propagate_env=True)``) is adopted at
start.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import queue as queue_mod
import subprocess
import sys
import threading
import time
import uuid
from typing import Any, Optional

from ray_tpu_torch.chaos import harness as _chaos
from ray_tpu_torch.cluster.rpc import (
    ClientPool,
    ReconnectingRpcClient,
    RemoteError,
    RpcClient,
    RpcError,
    RpcServer,
    format_gcs_addr,
    parse_gcs_addr,
)
from ray_tpu_torch.core.process_pool import visible_devices
from ray_tpu_torch.core.scheduler import CardGrants
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.cluster.node")

STORE_PREFIX = "ray_tpu_torch-store-"


def visible_cards() -> int:
    """The NVIDIA cards this process sees, without importing torch: the
    entries of ``CUDA_VISIBLE_DEVICES`` when it is set (an empty value or
    a negative index hides the rest, as CUDA reads it), else the more of
    the ``/dev/nvidia<N>`` device files and the driver's
    ``/proc/driver/nvidia/gpus`` entries."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        n = 0
        for tok in env.split(","):
            tok = tok.strip()
            if not tok or tok.startswith("-"):
                break
            n += 1
        return n

    def count(path: str, keep) -> int:
        try:
            return sum(1 for d in os.listdir(path) if keep(d))
        except OSError:
            return 0

    return max(count("/dev", lambda d: d.startswith("nvidia") and d[6:].isdigit()),
               count("/proc/driver/nvidia/gpus", lambda d: True))


CHUNK = 4 << 20  # object transfer chunk size


def _node_gauges() -> dict:
    """Per-node utilization gauges (tagged by node so in-process test
    daemons sharing one registry stay distinguishable). Aggregation kinds
    ride telemetry snapshots to the GCS (obs/telemetry.py)."""
    from ray_tpu_torch.obs.telemetry import cluster_gauge

    return {
        "workers": cluster_gauge(
            "node_workers",
            description="worker processes attached to this node daemon",
            tag_keys=("node",),
        ),
        "leases": cluster_gauge(
            "node_leases",
            description="worker leases currently granted on this node",
            tag_keys=("node",),
        ),
        "queued_leases": cluster_gauge(
            "node_queued_leases",
            description="lease requests parked in this node's grant queue "
            "(the autoscaler's per-node demand signal)",
            tag_keys=("node",),
        ),
        "object_bytes": cluster_gauge(
            "node_object_store_bytes",
            description="bytes resident in this node's object-store memory "
            "tier (dict tier; shm tier reports via stats())",
            tag_keys=("node",),
        ),
        "oom_kills": cluster_gauge(
            "node_oom_kills",
            description="workers killed by this node's memory monitor "
            "since daemon start",
            tag_keys=("node",),
        ),
    }


def register_metrics() -> None:
    """Force the node gauges to register (the metrics lint's hook)."""
    _node_gauges()


class ObjectService:
    """Node-local object table: byte-capped LRU memory tier + disk-spill
    tier + chunked cross-node pull.

    Reference analog: the plasma store's LRU eviction
    (src/ray/object_manager/plasma/eviction_policy.h:105) combined with
    the raylet's spill-to-disk path (raylet/local_object_manager.h:41).
    Objects never silently vanish: over-capacity entries spill to the
    node's spill dir and reload on access; only `free` deletes."""

    def __init__(self, node_id: str, gcs: RpcClient, pool: ClientPool,
                 capacity_bytes: int = 512 << 20,
                 spill_dir: Optional[str] = None,
                 shm_path: Optional[str] = None):
        from collections import OrderedDict

        self._objects: "OrderedDict[bytes, bytes]" = OrderedDict()
        self._bytes = 0
        self._capacity = capacity_bytes
        # shared-memory primary tier (the C++ plasma-equivalent,
        # native/src/shm_store.cc): workers on this node read results
        # zero-RPC and write returns without shipping bytes through the
        # daemon. The daemon PINS every adopted object (holds a ref) so
        # the store's zero-ref LRU eviction can never drop a primary copy;
        # shm-full falls back to the Python dict tier + disk spill.
        self._shm = None
        self._shm_held: set[bytes] = set()
        self.shm_path = None
        if shm_path:
            try:
                from ray_tpu_torch.native.shm import ShmObjectStore

                self._shm = ShmObjectStore.create(shm_path, capacity_bytes)
                self.shm_path = shm_path
                # ONE memory budget: shm takes it, the dict tier becomes a
                # small overflow buffer (not a second full-size cache)
                self._capacity = max(
                    capacity_bytes // 4, min(capacity_bytes, 16 << 20)
                )
            except Exception:
                logger.exception("shm store unavailable; using dict tier only")
        self._spill_dir = spill_dir or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), f"ray_tpu_torch-spill-{node_id}-{os.getpid()}"
        )
        self._spilled: set[bytes] = set()
        self._lock = threading.Lock()
        self._arrived = threading.Condition(self._lock)  # wakes fetch waiters
        self._node_id = node_id
        self._gcs = gcs
        self._pool = pool
        # object-directory announcements that failed because the GCS was
        # dark: the object is stored and served locally regardless (a
        # control-plane outage must not fail the data plane's put path);
        # the heartbeat loop re-announces these once the GCS answers
        self._unannounced: set[bytes] = set()

    def _spill_path(self, object_id: bytes) -> str:
        return os.path.join(self._spill_dir, object_id.hex())

    def _evict_over_capacity_locked(self) -> None:
        """Spill least-recently-used entries until under the byte cap."""
        while self._bytes > self._capacity and len(self._objects) > 1:
            oid, data = self._objects.popitem(last=False)  # LRU end
            self._bytes -= len(data)
            try:
                os.makedirs(self._spill_dir, exist_ok=True)
                tmp = self._spill_path(oid) + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, self._spill_path(oid))
                self._spilled.add(oid)
            except OSError:
                # disk full/unwritable: keep it in memory rather than lose it
                self._objects[oid] = data
                self._bytes += len(data)
                logger.exception("spill failed; keeping %s in memory", oid.hex()[:12])
                return

    # objects below this ride the dict tier: for tiny payloads the shm
    # alloc/seal/ref protocol costs more than the bytes it saves
    SHM_MIN_BYTES = 64 << 10

    def _shm_put_pinned(self, object_id: bytes, data: bytes) -> bool:
        """Store into shm holding the creator ref (pin). False on full."""
        if self._shm is None or len(data) < self.SHM_MIN_BYTES:
            return False
        if not self._shm.put_pinned(object_id, data):
            return False
        self._shm_held.add(object_id)
        return True

    def adopt_shm(self, object_id: bytes) -> bool:
        """Pin an object a WORKER sealed directly into shm (its bytes never
        crossed an RPC) and publish its location."""
        if self._shm is None:
            return False
        view = self._shm.get(object_id)  # takes the pin ref
        if view is None:
            return False
        with self._lock:
            self._shm_held.add(object_id)
            self._arrived.notify_all()
        self._announce(object_id)
        return True

    def put(self, object_id: bytes, data: bytes) -> None:
        with self._lock:
            if object_id in self._shm_held:
                pass  # already resident in shm
            elif self._shm_put_pinned(object_id, data):
                pass
            else:
                old = self._objects.pop(object_id, None)
                if old is not None:
                    self._bytes -= len(old)
                self._objects[object_id] = data
                self._bytes += len(data)
                self._evict_over_capacity_locked()
            self._arrived.notify_all()  # unblock fetch() waiters instantly
        self._announce(object_id)

    def _announce(self, object_id: bytes) -> None:
        """Publish the location; a dark GCS only costs directory
        freshness — the bytes are stored and locally readable either way
        (degraded-mode contract: per-request paths never fail on the
        control plane). Deferred announcements flush from the heartbeat
        loop / the re-registration inventory."""
        try:
            self._gcs.call(
                "add_object_location",
                {"object_id": object_id, "node_id": self._node_id},
            )
        except (RpcError, RemoteError):
            with self._lock:
                self._unannounced.add(object_id)

    def flush_unannounced(self) -> None:
        """Re-announce puts that landed while the GCS was dark (called
        after a successful heartbeat)."""
        with self._lock:
            todo = list(self._unannounced)
        for oid in todo:
            try:
                self._gcs.call(
                    "add_object_location",
                    {"object_id": oid, "node_id": self._node_id},
                )
            except (RpcError, RemoteError):
                return  # still dark; retry on a later beat
            with self._lock:
                self._unannounced.discard(oid)

    def get_local(self, object_id: bytes) -> Optional[bytes]:
        if self._shm is not None and object_id in self._shm_held:
            data = self._shm.get_bytes(object_id)
            if data is not None:
                return data
        with self._lock:
            data = self._objects.get(object_id)
            if data is not None:
                self._objects.move_to_end(object_id)  # MRU
                return data
        return self._get_spilled(object_id)

    def in_shm(self, object_id: bytes) -> bool:
        """Is this object readable straight from the shm mapping?"""
        return self._shm is not None and object_id in self._shm_held

    def local_size(self, object_id: bytes) -> Optional[int]:
        """Size without materializing (chunk-serving metadata)."""
        if self._shm is not None and object_id in self._shm_held:
            n = self._shm.size_of(object_id)
            if n is not None:
                return n
        with self._lock:
            data = self._objects.get(object_id)
        if data is not None:
            return len(data)
        data = self._get_spilled(object_id)
        return None if data is None else len(data)

    def local_slice(self, object_id: bytes, offset: int,
                    length: int) -> Optional[bytes]:
        """One chunk of a local object — for shm objects this copies ONLY
        the slice (a full get_bytes per chunk would make cross-node pulls
        quadratic in object size)."""
        if self._shm is not None and object_id in self._shm_held:
            data = self._shm.get_slice(object_id, offset, length)
            if data is not None:
                return data
        data = self.get_local(object_id)
        return None if data is None else data[offset:offset + length]

    def _get_spilled(self, object_id: bytes) -> Optional[bytes]:
        with self._lock:
            if object_id in self._spilled:
                try:
                    with open(self._spill_path(object_id), "rb") as f:
                        data = f.read()
                except OSError:
                    self._spilled.discard(object_id)
                    return None
                # promote back into the memory tier
                self._objects[object_id] = data
                self._bytes += len(data)
                self._spilled.discard(object_id)
                try:
                    os.unlink(self._spill_path(object_id))
                except OSError:
                    pass
                self._evict_over_capacity_locked()
                return data
        return None

    def free(self, object_id: bytes) -> None:
        with self._lock:
            if object_id in self._shm_held:
                self._shm_held.discard(object_id)
                try:
                    self._shm.release(object_id)  # drop the pin
                    self._shm.delete(object_id)
                except OSError:
                    pass
            data = self._objects.pop(object_id, None)
            if data is not None:
                self._bytes -= len(data)
            if object_id in self._spilled:
                self._spilled.discard(object_id)
                try:
                    os.unlink(self._spill_path(object_id))
                except OSError:
                    pass
            self._unannounced.discard(object_id)
        try:
            self._gcs.call(
                "remove_object_location",
                {"object_id": object_id, "node_id": self._node_id},
            )
        except RpcError:
            pass

    def fetch(self, object_id: bytes, timeout: float = 30.0) -> Optional[bytes]:
        """Local hit or remote pull; single-object form of fetch_many."""
        return self.fetch_many([object_id], timeout)[0]

    SHM_MARKER = {"__shm__": True}

    def fetch_many(self, ids: list, timeout: float = 30.0,
                   shm_markers: bool = False) -> list:
        """Batched local-or-remote fetch, the ONE pull implementation.

        Local arrivals (the hot path: a worker's put_return racing the
        caller's get) wake waiters via condition variable — no 50 ms poll
        tax on fresh task results. Remote lookups are ONE batched
        locate_many per rate-limited round, not a per-object GCS call per
        wakeup (GCS thundering herd).

        shm_markers: the caller has the store mapped (a local driver) —
        shm-resident objects come back as SHM_MARKER without EVER being
        materialized into daemon-side bytes (the copy is the point of
        the fast path, not just the socket)."""
        deadline = time.monotonic() + timeout
        out: dict[bytes, Optional[bytes]] = {oid: None for oid in ids}
        missing = [oid for oid in dict.fromkeys(ids)]  # dedup, keep order
        next_remote = 0.0  # first round probes immediately
        while missing:
            still = []
            for oid in missing:
                if shm_markers and self.in_shm(oid):
                    out[oid] = self.SHM_MARKER
                    continue
                data = self.get_local(oid)
                if data is None:
                    still.append(oid)
                else:
                    out[oid] = data
            missing = still
            if not missing or time.monotonic() >= deadline:
                break
            if time.monotonic() >= next_remote:
                next_remote = time.monotonic() + 0.25
                try:
                    locs = self._gcs.call(
                        "locate_many", {"object_ids": missing}, timeout=10
                    )
                except (RpcError, RemoteError):
                    locs = {}
                for oid in list(missing):
                    for addr in locs.get(oid, ()):
                        if tuple(addr) == self._pool_self_addr:
                            continue
                        try:
                            data = self._pull_from(tuple(addr), oid)
                        except (RpcError, RemoteError):
                            continue
                        if data is not None:
                            self.put(oid, data)
                            # a caller with the store mapped reads the
                            # pulled copy there, not through this RPC
                            out[oid] = (self.SHM_MARKER if shm_markers and self.in_shm(oid)
                                        else data)
                            missing.remove(oid)
                            break
            if not missing or time.monotonic() >= deadline:
                break
            with self._arrived:
                self._arrived.wait(timeout=0.05)
        return [out[oid] for oid in ids]

    _pool_self_addr: tuple = ("", 0)  # set by daemon after bind

    def _pull_from(self, addr: tuple, object_id: bytes) -> Optional[bytes]:
        c = self._pool.get(addr)
        meta = c.call("object_meta", {"object_id": object_id})
        if meta is None:
            return None
        size = meta["size"]
        parts = []
        off = 0
        while off < size:
            chunk = c.call(
                "object_chunk",
                {"object_id": object_id, "offset": off, "length": CHUNK},
            )
            if chunk is None:
                return None
            parts.append(chunk)
            off += len(chunk)
        return b"".join(parts)

    def inventory(self) -> list:
        """Every object id resident on this node (memory + spilled +
        shm tiers) — the re-registration report that rebuilds a restarted
        GCS's object directory."""
        with self._lock:
            return list(
                dict.fromkeys(
                    list(self._objects) + list(self._spilled)
                    + list(self._shm_held)
                )
            )

    def close(self) -> None:
        """Remove the spill files, release pins and close (owner: unlink)
        the shm store."""
        import shutil

        shutil.rmtree(self._spill_dir, ignore_errors=True)
        if self._shm is None:
            return
        for oid in list(self._shm_held):
            try:
                self._shm.release(oid)
            except OSError:
                pass
        self._shm_held.clear()
        try:
            self._shm.close()
        except Exception:
            pass

    def stats(self) -> dict:
        with self._lock:
            out = {
                "num_objects": len(self._objects) + len(self._spilled)
                + len(self._shm_held),
                "bytes": self._bytes,
                "spilled": len(self._spilled),
                "capacity": self._capacity,
                "shm_objects": len(self._shm_held),
            }
            if self._shm is not None:
                try:
                    out["shm"] = self._shm.stats()
                except OSError:
                    pass
            return out


class WorkerHandle:
    def __init__(self, proc: subprocess.Popen, worker_id: str):
        self.proc = proc
        self.worker_id = worker_id
        self.addr: Optional[tuple] = None
        self.ready = threading.Event()
        # (runtime-env hash, CUDA_VISIBLE_DEVICES) this worker is dedicated to
        self.env_key: tuple = ("", "")
        self.idle_since = time.monotonic()

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        try:
            self.proc.kill()
        except Exception:
            pass
        # reap off the caller's thread: a killed worker must not linger
        # as a zombie of the daemon
        threading.Thread(target=self._reap, name="worker-reap", daemon=True).start()

    def _reap(self) -> None:
        try:
            self.proc.wait(timeout=30)
        except Exception:  # noqa: BLE001 — still alive past the bound; the OS reaps at exit
            pass


def _sweep_stale_stores(shm_dir: str) -> None:
    """Unlink object-store files whose owning daemon is gone: a SIGKILLed
    daemon (chaos tests, OOM kills) can't clean its own tmpfs file, and
    the leaks compound at hundreds of MB per killed node."""
    try:
        names = os.listdir(shm_dir)
    except OSError:
        return
    for name in names:
        if not name.startswith(STORE_PREFIX):
            continue
        pid_s = name.rsplit("-", 1)[-1]
        if not pid_s.isdigit():
            continue
        try:
            os.kill(int(pid_s), 0)  # signal 0 = liveness probe
        except ProcessLookupError:
            try:
                os.unlink(os.path.join(shm_dir, name))
            except OSError:
                pass
        except PermissionError:
            pass  # someone else's live process


class NodeDaemon:
    """The per-node control process (raylet-equivalent)."""

    def __init__(
        self,
        gcs_addr: tuple,
        resources: dict,
        node_id: Optional[str] = None,
        host: str = "127.0.0.1",
        labels: Optional[dict] = None,
        worker_env: Optional[dict] = None,
        heartbeat_interval_s: float = 0.5,
        object_capacity_bytes: int = 512 << 20,
        worker_rss_limit_mb: int = 0,       # 0 = no per-worker cap
        memory_usage_threshold: float = 0.95,  # node pressure kill point
        memory_monitor_interval_s: float = 1.0,  # 0 = monitor disabled
        telemetry_interval_s: float = 2.0,  # 0 = no heartbeat piggyback
    ):
        self.node_id = node_id or f"node-{uuid.uuid4().hex[:8]}"
        self.gcs_addr = gcs_addr
        self.total = dict(resources)
        self.available = dict(resources)
        self.labels = labels or {}
        self.worker_env = worker_env or {}
        self._hb_interval = heartbeat_interval_s
        self._rss_limit_mb = int(worker_rss_limit_mb)
        self._mem_threshold = float(memory_usage_threshold)
        self._mem_interval = float(memory_monitor_interval_s)
        self._oom_kills = 0
        self._telemetry_interval = float(telemetry_interval_s)
        self._last_telemetry = 0.0
        # whole cards for GPU leases, over the cards the "GPU" resource claims
        total_gpus = float(resources.get("GPU", 0))
        self._cards = CardGrants(int(total_gpus) if total_gpus > 0 else 0)
        # RLock: PG-bundle reserve is check-then-act over _bundles AND the
        # node availability — the whole sequence must be atomic across
        # handler threads (reference: PlacementGroupResourceManager commits
        # bundle resources atomically)
        self._res_lock = threading.RLock()
        self._leases: dict[str, dict] = {}  # lease_id -> {resources, worker}
        self._bundles: dict[tuple, dict] = {}  # (pg_id, idx) -> reserved resources
        # idle pool keyed by (runtime-env hash, CUDA_VISIBLE_DEVICES): a
        # worker only ever runs tasks of ONE runtime env (reference:
        # worker_pool.h dedicated workers per runtime env) and of one card
        # grant (a CPU lease never lands in a worker holding a CUDA context)
        self._idle_workers: dict[tuple, list[WorkerHandle]] = {}
        self._all_workers: dict[str, WorkerHandle] = {}
        self._env_cache = os.path.join(
            os.environ.get("TMPDIR", "/tmp"),
            f"ray_tpu_torch-envs-{node_id or 'node'}-{os.getpid()}",
        )
        self._wlock = threading.Lock()
        self._grant_queue: "queue_mod.Queue" = queue_mod.Queue()
        self._capacity_signal = threading.Event()  # wakes the granter
        self._num_queued = 0  # granter's current waiter count (approximate)
        self._pending_specs: list[dict] = []  # queued lease resource specs
        from collections import deque as _deque

        self._spans: "_deque[dict]" = _deque(maxlen=20000)  # worker exec spans
        self.rpc = RpcServer(self, host=host)
        self.pool = ClientPool()
        # reconnecting: the GCS may restart (FT snapshot) and come back at
        # the same address; the daemon must ride through the outage
        self.gcs = ReconnectingRpcClient(*gcs_addr).connect(retries=20)
        from ray_tpu_torch.utils.shm import shm_dir as _shm_dir

        shm_dir = _shm_dir()
        _sweep_stale_stores(shm_dir)
        self.objects = ObjectService(
            self.node_id, self.gcs, self.pool,
            capacity_bytes=object_capacity_bytes,
            shm_path=os.path.join(shm_dir, f"{STORE_PREFIX}{self.node_id}-{os.getpid()}"),
        )
        self._stop = threading.Event()
        # graceful drain (SIGTERM / maintenance event): stop admitting
        # leases, let in-flight work finish, deregister from the GCS
        self._draining = False
        self.addr: Optional[tuple] = None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> tuple:
        self.addr = self.rpc.start()
        self.objects._pool_self_addr = self.addr
        self.gcs.call(
            "register_node",
            {
                "node_id": self.node_id,
                "addr": self.addr,
                "resources": self.total,
                "labels": self.labels,
            },
        )
        t = threading.Thread(target=self._heartbeat_loop, name="node-hb", daemon=True)
        t.start()
        threading.Thread(
            target=self._granter_loop, name="node-granter", daemon=True
        ).start()
        if self._mem_interval > 0:
            threading.Thread(
                target=self._memory_monitor_loop, name="node-memmon",
                daemon=True,
            ).start()
        return self.addr

    # -- memory monitor -------------------------------------------------------
    # Reference analog: src/ray/raylet/worker_killing_policy.cc — under
    # node memory pressure the raylet kills workers (retriable tasks
    # first, newest first) instead of letting the kernel OOM-killer take
    # out the daemon or an arbitrary process. Two triggers here:
    #   * per-worker RSS cap (worker_rss_limit_mb): a deterministic cap
    #     against one runaway task;
    #   * node usage threshold (memory_usage_threshold over
    #     /proc/meminfo): kill the NEWEST leased worker — its pusher gets
    #     a connection error and the task re-leases under max_retries,
    #     exactly the retriable-FIFO policy's assumption.

    @staticmethod
    def _worker_rss_mb(pid: int) -> float:
        try:
            with open(f"/proc/{pid}/statm") as f:
                pages = int(f.read().split()[1])
            return pages * (os.sysconf("SC_PAGE_SIZE") / (1 << 20))
        except (OSError, ValueError, IndexError):
            return 0.0

    @staticmethod
    def _node_memory_usage() -> float:
        try:
            info = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    k, v = line.split(":", 1)
                    info[k] = int(v.strip().split()[0])
            total = info.get("MemTotal", 0)
            avail = info.get("MemAvailable", total)
            return 1.0 - avail / total if total else 0.0
        except (OSError, ValueError):
            return 0.0

    def _memory_monitor_loop(self) -> None:
        while not self._stop.wait(self._mem_interval):
            try:
                self._memory_check()
            except Exception:  # noqa: BLE001 — monitor must never die
                logger.exception("memory monitor tick failed")

    def _memory_check(self) -> None:
        # reap corpses first: a worker the monitor killed last tick must
        # leave _all_workers/_idle_workers, or the newest-first selection
        # would livelock re-killing the same dead handle every tick while
        # live workers hold the actual memory
        with self._wlock:
            dead = [w for w in self._all_workers.values() if not w.alive()]
            for w in dead:
                self._all_workers.pop(w.worker_id, None)
            for key, pool in list(self._idle_workers.items()):
                keep = [w for w in pool if w.alive()]
                if keep:
                    self._idle_workers[key] = keep
                else:
                    self._idle_workers.pop(key, None)
            workers = list(self._all_workers.values())
        victims: list[tuple] = []
        if self._rss_limit_mb > 0:
            for w in workers:
                if not w.alive():
                    continue
                rss = self._worker_rss_mb(w.proc.pid)
                if rss > self._rss_limit_mb:
                    victims.append((w, f"rss {rss:.0f}MB > limit "
                                       f"{self._rss_limit_mb}MB"))
        if not victims and self._mem_threshold < 1.0:
            usage = self._node_memory_usage()
            if usage > self._mem_threshold:
                # RETRIABLE leases first, newest first (reference
                # worker_killing_policy: a max_retries=0 task dies for
                # good if its worker is killed — only shed it when no
                # retriable victim exists); fall back to the newest idle
                # worker to shed pool memory
                with self._res_lock:
                    leased = sorted(
                        (ls for ls in self._leases.values()
                         if ls.get("worker") is not None
                         and ls["worker"].alive()),
                        key=lambda ls: (
                            not ls.get("retriable", True), -ls.get("t", 0.0)
                        ),
                    )
                live = [w for w in workers if w.alive()]
                if leased:
                    pick = leased[0]
                    victims.append((
                        pick["worker"],
                        f"node memory {usage:.0%} > "
                        f"{self._mem_threshold:.0%} "
                        f"({'retriable' if pick.get('retriable', True) else 'NON-retriable (no retriable victim)'} lease)",
                    ))
                elif live:
                    victims.append((
                        max(live, key=lambda w: w.idle_since),
                        f"node memory {usage:.0%} (idle worker)",
                    ))
        for w, why in victims:
            logger.warning(
                "memory monitor killing worker %s (pid %s): %s",
                w.worker_id, w.proc.pid, why,
            )
            self._oom_kills += 1
            w.kill()

    def drain(self, timeout_s: float = 30.0) -> dict:
        """Graceful drain (SIGTERM / maintenance event): stop admitting
        leases, wait for in-flight leases to finish (bounded), deregister
        from the GCS, then stop. In-flight work either completes here or
        — if the timeout expires — dies with the node and re-homes via
        the caller's normal retry path (max_retries / actor restart)."""
        self._draining = True
        logger.warning("node %s draining (timeout %.1fs)", self.node_id, timeout_s)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._res_lock:
                inflight = len(self._leases)
            if inflight == 0 and self._grant_queue.qsize() == 0 \
                    and self._num_queued == 0:
                break
            time.sleep(0.1)
        with self._res_lock:
            leaked = len(self._leases)
        if leaked:
            logger.warning(
                "node %s drain timeout with %d leases in flight; "
                "their tasks will re-home via retry", self.node_id, leaked,
            )
        self.stop()  # stop() deregisters via drain_node before teardown
        return {"ok": True, "leases_killed": leaked}

    def rpc_drain(self, payload, peer):
        """Remote maintenance trigger (the autoscaler's scale-down /
        preemption-notice path); drains on a background thread so the
        RPC answers immediately."""
        timeout_s = float((payload or {}).get("timeout_s", 30.0))
        threading.Thread(
            target=self.drain, args=(timeout_s,), name="node-drain", daemon=True
        ).start()
        return {"ok": True, "draining": True}

    def rpc_chaos_kill_worker(self, payload, peer):
        """Fault-injection surface (chaos.runner): SIGKILL the newest
        leased worker — the deterministic stand-in for a worker OOM/crash
        mid-task."""
        with self._res_lock:
            leased = sorted(
                (ls for ls in self._leases.values()
                 if ls.get("worker") is not None and ls["worker"].alive()),
                key=lambda ls: -ls.get("t", 0.0),
            )
        if not leased:
            return {"ok": False, "error": "no leased worker to kill"}
        w = leased[0]["worker"]
        logger.warning("chaos: killing worker %s (pid %s)", w.worker_id, w.proc.pid)
        w.kill()
        return {"ok": True, "worker_id": w.worker_id}

    def stop(self) -> None:
        self._stop.set()
        with self._wlock:
            workers = list(self._all_workers.values())
            self._all_workers.clear()
            self._idle_workers.clear()
        for w in workers:
            w.kill()
        try:
            self.gcs.call("drain_node", {"node_id": self.node_id}, timeout=2)
        except (RpcError, RemoteError):
            pass
        self.rpc.stop()
        self.gcs.close()
        self.pool.close_all()
        self.objects.close()  # releases pins; owner unlinks the tmpfs file
        import shutil

        shutil.rmtree(self._env_cache, ignore_errors=True)

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self._hb_interval):
            try:
                self._reap_idle_workers()
            except Exception:
                pass
            if _chaos.ACTIVE is not None and any(
                f.kind == _chaos.STALL_HEARTBEAT
                for f in _chaos.fire("node.heartbeat",
                                     kinds=(_chaos.STALL_HEARTBEAT,),
                                     node_id=self.node_id)
            ):
                # partition simulation: the node is alive and working but
                # its heartbeats never reach the GCS — the exact shape of
                # a network partition / GC pause the _mark_dead sweeper
                # turns into a (possibly premature) death verdict
                continue
            try:
                with self._res_lock:
                    avail = dict(self.available)
                hb = {"node_id": self.node_id, "available": avail,
                      "pending": self._pending_specs,
                      "draining": self._draining}
                if (self._telemetry_interval > 0
                        and time.monotonic() - self._last_telemetry >= self._telemetry_interval):
                    # the node's gauges as absolute values: a beat a chaos
                    # STALL drops costs only freshness, which the GCS
                    # reports as this node's staleness
                    try:
                        hb["telemetry"] = self._telemetry_snapshot()
                        self._last_telemetry = time.monotonic()
                    except Exception:  # noqa: BLE001 — never break heartbeats
                        logger.exception("telemetry snapshot failed")
                r = self.gcs.call("heartbeat", hb, timeout=5)
                if not r.get("ok") and r.get("reregister"):
                    # a restarted/partition-recovered GCS asked for ground
                    # truth: re-register with the FULL reconcile report —
                    # object inventory, held leases, reserved PG bundles,
                    # and the live actors our workers host — so the GCS
                    # converges its (possibly stale) snapshot to reality
                    self.gcs.call(
                        "register_node",
                        {
                            "node_id": self.node_id,
                            "addr": self.addr,
                            "resources": self.total,
                            "labels": self.labels,
                            **self._reconcile_report(),
                        },
                    )
                else:
                    self.objects.flush_unannounced()
            except (RpcError, RemoteError):
                pass  # GCS down: keep trying (it may restart)

    def _reconcile_report(self) -> dict:
        """Ground truth for a reconciling GCS: everything live on this
        node right now. Worker actor inventories are collected over
        bounded RPCs; a worker that died mid-collect simply contributes
        nothing (its actors are genuinely gone)."""
        with self._res_lock:
            leases = [
                {
                    "lease_id": lid,
                    "resources": dict(ls["resources"]),
                    "worker_id": getattr(ls.get("worker"), "worker_id", None),
                }
                for lid, ls in self._leases.items()
            ]
            bundles = [
                {"pg_id": pg_id, "bundle_index": idx,
                 "resources": dict(res)}
                for (pg_id, idx), res in self._bundles.items()
            ]
            worker_by_lease = {
                lid: ls.get("worker") for lid, ls in self._leases.items()
            }
        actors: list[dict] = []
        for lid, w in worker_by_lease.items():
            if w is None or not w.alive() or w.addr is None:
                continue
            try:
                inv = self.pool.get(tuple(w.addr)).call(
                    "actor_inventory", {}, timeout=5
                )
            except (RpcError, RemoteError):
                continue
            for rec in inv or ():
                rec = dict(rec)
                rec.setdefault("lease_id", lid)
                rec.setdefault("worker_addr", tuple(w.addr))
                actors.append(rec)
        return {
            "objects": self.objects.inventory(),
            "leases": leases,
            "bundles": bundles,
            "actors": actors,
        }

    # -- resources ------------------------------------------------------------

    def _try_acquire(self, res: dict, pool: Optional[dict] = None) -> bool:
        with self._res_lock:
            target = pool if pool is not None else self.available
            if all(target.get(k, 0.0) >= v - 1e-9 for k, v in res.items()):
                for k, v in res.items():
                    target[k] = target.get(k, 0.0) - v
                return True
            return False

    def _release(self, res: dict, pool: Optional[dict] = None) -> None:
        with self._res_lock:
            target = pool if pool is not None else self.available
            for k, v in res.items():
                target[k] = target.get(k, 0.0) + v

    # -- worker pool ----------------------------------------------------------

    def _spawn_worker(self, runtime_env: Optional[dict] = None,
                      visible: str = "") -> WorkerHandle:
        worker_id = f"w-{uuid.uuid4().hex[:8]}"
        env = dict(os.environ)
        env.update(self.worker_env)
        # the worker must import ray_tpu_torch REGARDLESS of its cwd: a
        # runtime_env working_dir changes cwd to the materialized
        # package, dropping any implicit cwd-based import
        from ray_tpu_torch.utils.env import inject_framework_pythonpath

        inject_framework_pythonpath(env)
        env["RAY_TPU_WORKER_ID"] = worker_id
        env["RAY_TPU_NODE_ID"] = self.node_id
        # the host workers should advertise for cross-host rendezvous
        env["RAY_TPU_NODE_IP"] = self.addr[0]
        # the card grant, set before the worker's interpreter starts: ""
        # for a CPU lease, so its worker never opens a CUDA context
        env["CUDA_VISIBLE_DEVICES"] = visible
        cwd = os.getcwd()
        env_key = ""
        if runtime_env:
            from ray_tpu_torch.cluster.runtime_env import env_hash, materialize
            from ray_tpu_torch.cluster.serialization import loads_value

            env_key = env_hash(runtime_env)

            def fetch_bytes(oid):
                data = self.objects.fetch(oid, timeout=60.0)
                return None if data is None else loads_value(data, lambda _: None)

            extra, workdir = materialize(
                runtime_env, fetch_bytes, self._env_cache, base_env=env
            )
            env.update(extra)
            if workdir:
                cwd = workdir
        proc = subprocess.Popen(
            [
                sys.executable, "-m", "ray_tpu_torch.cluster.worker_main",
                "--daemon", f"{self.addr[0]}:{self.addr[1]}",
                "--worker-id", worker_id,
                "--gcs", format_gcs_addr(self.gcs_addr),
            ],
            env=env,
            cwd=cwd,
        )
        h = WorkerHandle(proc, worker_id)
        h.env_key = (env_key, visible)
        with self._wlock:
            self._all_workers[worker_id] = h
        return h

    def _lease_worker(self, block: bool = True, runtime_env: Optional[dict] = None,
                      visible: str = "") -> Optional[WorkerHandle]:
        from ray_tpu_torch.cluster.runtime_env import env_hash

        key = (env_hash(runtime_env), visible)
        with self._wlock:
            pool = self._idle_workers.get(key, [])
            while pool:
                w = pool.pop()
                if w.alive():
                    # a live worker trumps any stale spawn error
                    getattr(self, "_spawn_errors", {}).pop(key, None)
                    return w
            err = getattr(self, "_spawn_errors", {}).pop(key, None)
            if err is not None:
                # a background spawn for this env failed (bad runtime_env,
                # missing package): surface it instead of retrying forever
                raise RpcError(f"worker spawn failed: {err}")
        if not block:
            # the single granter thread must never sit in a multi-second
            # worker spawn (it would stall every other queued lease):
            # kick an async spawn and let the capacity signal re-trigger
            self._ensure_spawning(runtime_env, key)
            return None
        w = self._spawn_worker(runtime_env, visible)
        if not w.ready.wait(timeout=60):
            w.kill()
            raise RpcError("worker failed to start in 60s")
        return w

    def _ensure_spawning(self, runtime_env: Optional[dict], key: tuple) -> None:
        """At most one background worker spawn in flight per runtime env."""
        with self._wlock:
            spawning = getattr(self, "_spawning", None)
            if spawning is None:
                spawning = self._spawning = set()
            if not hasattr(self, "_spawn_errors"):
                self._spawn_errors: dict[tuple, str] = {}
            if key in spawning:
                return
            spawning.add(key)

        def run():
            try:
                w = self._spawn_worker(runtime_env, key[1])
                if w.ready.wait(timeout=60) and w.alive():
                    w.idle_since = time.monotonic()
                    with self._wlock:
                        self._idle_workers.setdefault(key, []).append(w)
                else:
                    w.kill()
                    with self._wlock:
                        self._spawn_errors[key] = "worker failed to start in 60s"
            except Exception as e:  # noqa: BLE001 - deliver to the waiter
                with self._wlock:
                    self._spawn_errors[key] = repr(e)
            finally:
                with self._wlock:
                    self._spawning.discard(key)
                self._notify_capacity()

        threading.Thread(target=run, name="worker-spawn", daemon=True).start()

    def _reap_idle_workers(self, ttl_s: float = 60.0) -> None:
        """Kill runtime-env-dedicated workers idle past their TTL; the
        default pools (no runtime env, any card grant) are exempt
        (reference: worker_pool idle-worker killing for dedicated
        workers)."""
        now = time.monotonic()
        doomed: list[WorkerHandle] = []
        with self._wlock:
            for key, pool in list(self._idle_workers.items()):
                if key[0] == "":
                    continue
                keep = []
                for w in pool:
                    if now - getattr(w, "idle_since", now) > ttl_s:
                        doomed.append(w)
                    else:
                        keep.append(w)
                if keep:
                    self._idle_workers[key] = keep
                else:
                    self._idle_workers.pop(key, None)
            for w in doomed:
                self._all_workers.pop(w.worker_id, None)
        for w in doomed:
            w.kill()

    def rpc_register_worker(self, payload, peer):
        with self._wlock:
            w = self._all_workers.get(payload["worker_id"])
        if w is None:
            return {"ok": False}
        w.addr = tuple(payload["addr"])
        w.ready.set()
        return {
            "ok": True,
            "node_id": self.node_id,
            "gcs_addr": self.gcs_addr,
            "daemon_addr": self.addr,
            "shm_path": self.objects.shm_path,
        }

    # -- lease protocol -------------------------------------------------------

    def _try_grant(self, payload, allow_spillback: bool = True,
                   block_spawn: bool = True) -> Optional[dict]:
        """One grant attempt. Returns a response dict, or None when the
        request should QUEUE here (no capacity now, no better node).

        allow_spillback=False on queue retries: recomputing spillback
        candidates means a GCS list_nodes per waiter per wakeup — a
        thundering herd that serializes the whole cluster on the GCS."""
        res = payload.get("resources", {})
        pg_key = None
        if self._draining and (
            payload.get("pg_id") is not None or payload.get("pinned")
        ):
            # placement here is mandatory but the node is leaving: fail
            # fast so the caller re-resolves instead of queueing into a
            # node that will never grant again
            return {"error": f"node {self.node_id} is draining"}
        if payload.get("pg_id") is not None:
            pg_key = (payload["pg_id"], payload.get("bundle_index", 0))
            with self._res_lock:
                bundle_pool = self._bundles.get(pg_key)
                if bundle_pool is None:
                    return {"error": f"no bundle reserved here for {pg_key}"}
                acquired = self._try_acquire(res, bundle_pool)
        else:
            # a draining node stops admitting new leases entirely
            acquired = (not self._draining) and self._try_acquire(res)
        if acquired:
            gpus = float(res.get("GPU", 0))
            cards: tuple = ()
            try:
                if gpus > 0:
                    cards = self._grant_cards(gpus)
                w = self._lease_worker(
                    block=block_spawn, runtime_env=payload.get("runtime_env"),
                    visible=visible_devices(cards),
                )
            except Exception as e:  # noqa: BLE001 - incl. runtime_env failures
                self._cards.release(cards, gpus)
                with self._res_lock:
                    self._release(
                        res, self._bundles.get(pg_key) if pg_key else None
                    )
                return {"error": str(e)}
            if w is None:  # spawn in flight; re-queue until it registers
                self._cards.release(cards, gpus)
                with self._res_lock:
                    self._release(
                        res, self._bundles.get(pg_key) if pg_key else None
                    )
                return None
            lease_id = uuid.uuid4().hex
            self._leases[lease_id] = {
                "resources": res, "worker": w, "pg_key": pg_key, "cards": cards,
                "t": time.monotonic(),  # newest-first OOM kill policy
                "retriable": bool(payload.get("retriable", True)),
            }
            return {
                "grant": {
                    "lease_id": lease_id,
                    "worker_addr": w.addr,
                    "worker_id": w.worker_id,
                    "node_id": self.node_id,
                    "cards": visible_devices(cards),
                    # the address release_lease must go to — without it a
                    # remote actor's lease could only ever be released at
                    # the driver's local daemon (leaking worker+resources)
                    "node_addr": self.addr,
                }
            }
        # no local capacity: pg/pinned requests always queue here
        if pg_key is not None or payload.get("pinned") or not allow_spillback:
            return None
        # spillback: consult the GCS view for a node that fits
        exclude = set(payload.get("exclude", ())) | {self.node_id}
        try:
            nodes = self.gcs.call("list_nodes", None, timeout=5)
        except (RpcError, RemoteError):
            nodes = []
        candidates = [
            n for n in nodes
            if n["alive"] and not n.get("draining")
            and n["node_id"] not in exclude
            and all(n["available"].get(k, 0.0) >= v for k, v in res.items())
        ]
        if candidates:
            # hybrid policy's remote leg: random among the top-k by
            # availability, so concurrent submitters with the same (stale)
            # view don't all herd onto one node
            # (reference: hybrid_scheduling_policy.h:29-49)
            import random

            key = next(iter(res), None)
            random.shuffle(candidates)
            candidates.sort(
                key=lambda n: -n["available"].get(key, 0.0) if key else 0.0
            )
            top_k = candidates[: max(1, min(3, len(candidates)))]
            pick = random.choice(top_k)
            return {"spillback": pick["addr"],
                    "spillback_node": pick["node_id"],
                    "node_id": self.node_id}
        if self._draining:
            # never queue on a draining node: tell the client to retry
            # (somewhere else, or here again once replacement capacity
            # registers) instead of parking until the drain kills us
            return {"retry_after": 0.25, "node_id": self.node_id,
                    "draining": True}
        return None  # saturated cluster: queue here

    async def rpc_request_worker_lease(self, payload, peer):
        """Grant a worker, spill back, or QUEUE the request server-side
        until capacity frees (reference: ClusterTaskManager queues leases,
        src/ray/raylet/scheduling/cluster_task_manager.h — the round-2
        50 ms client busy-poll is gone). Queued requests are granted FIFO
        by ONE granter thread: a broadcast wakeup would retry every
        waiter on every release (thundering herd).
        """
        loop = asyncio.get_running_loop()
        # fast path only when nobody is queued — otherwise new arrivals
        # would steal freed capacity from FIFO waiters (starvation)
        if self._grant_queue.qsize() == 0 and self._num_queued == 0:
            r = await loop.run_in_executor(None, self._try_grant, payload, True)
            if r is not None:
                return r
        fut = loop.create_future()
        deadline = time.monotonic() + float(payload.get("queue_timeout", 30.0))
        self._grant_queue.put((payload, loop, fut, deadline))
        return await fut

    def _granter_loop(self) -> None:
        """Server-side lease queue (the ClusterTaskManager role).

        Scans ALL waiters each round in arrival order: a blocked head
        (e.g. a fixed-bundle request on a busy bundle) must not stall
        requests for other bundles/resources behind it. Any exception in
        a grant attempt answers THAT waiter with an error — the granter
        thread itself must never die (every queued future would hang)."""
        waiters: list = []  # [payload, loop, fut, deadline, next_spill]
        while not self._stop.is_set():
            try:  # drain new arrivals
                while True:
                    item = self._grant_queue.get_nowait()
                    waiters.append(list(item) + [time.monotonic() + 0.5])
            except queue_mod.Empty:
                pass
            if not waiters:
                try:
                    item = self._grant_queue.get(timeout=0.5)
                    waiters.append(list(item) + [time.monotonic() + 0.5])
                except queue_mod.Empty:
                    continue
            progressed = False
            still: list = []
            for waiter in waiters:
                payload, loop, fut, deadline, next_spill = waiter
                # while queued, periodically re-check the GCS for a node
                # with free capacity — the local queue must not starve a
                # task the rest of the cluster could run right now. The
                # request's exclude list is DROPPED for these probes: it
                # records nodes that were full when the client hopped
                # through them, and by now (>=0.5s later, a fresh heartbeat)
                # those views are stale — keeping it would permanently
                # blind the queue to a node that has since freed up
                spill = time.monotonic() >= next_spill and not payload.get("pinned")
                probe = payload
                if spill and payload.get("exclude"):
                    probe = {k: v for k, v in payload.items() if k != "exclude"}
                try:
                    r = self._try_grant(
                        probe, allow_spillback=spill, block_spawn=False
                    )
                except Exception as e:  # noqa: BLE001 - must not kill the granter
                    logger.exception("lease grant attempt failed")
                    r = {"error": f"lease grant failed: {e!r}"}
                if spill:
                    waiter[4] = time.monotonic() + 1.0
                if r is None and time.monotonic() >= deadline:
                    # let the client re-evaluate (capacity may exist under
                    # a different exclude set by now)
                    r = {"retry_after": 0.05, "node_id": self.node_id}
                if r is None:
                    still.append(waiter)
                    continue
                progressed = True

                def _finish(f=fut, rr=r):
                    if f.cancelled():
                        # requester vanished after we granted: reclaim the
                        # lease or it (worker + resources) leaks forever
                        self._reclaim_grant(rr)
                        return
                    f.set_result(rr)

                try:
                    loop.call_soon_threadsafe(_finish)
                except RuntimeError:
                    self._reclaim_grant(r)  # connection's loop is gone
            waiters = still
            self._num_queued = len(waiters)
            # autoscaler demand feed: specs of leases parked here, shipped
            # to the GCS with the next heartbeat (reference: resource
            # demand in raylet heartbeats driving the autoscaler)
            self._pending_specs = [
                dict(w[0].get("resources", {})) for w in waiters[:64]
            ]
            if waiters and not progressed:
                self._capacity_signal.wait(timeout=0.1)
                self._capacity_signal.clear()

    def _grant_cards(self, gpus: float) -> tuple:
        """Whole cards for a lease of ``gpus``; raises when this node sees
        no card for it (a GPU lease never runs on the CPU)."""
        seen = visible_cards()
        cards = self._cards.acquire(gpus)
        if cards is None:
            raise RuntimeError(f"node {self.node_id}: no card free for a lease of {gpus} GPU")
        if max(cards) >= seen:
            self._cards.release(cards, gpus)
            raise RuntimeError(
                f"node {self.node_id} declares GPU={self.total.get('GPU')} but sees {seen} "
                f"card(s) (CUDA_VISIBLE_DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES')!r}): "
                f"a lease of {gpus} GPU cannot run here")
        return cards

    def _reclaim_grant(self, response: dict) -> None:
        """Release a lease whose grant could not be delivered."""
        grant = response.get("grant") if isinstance(response, dict) else None
        if grant:
            try:
                self.rpc_release_lease(
                    {"lease_id": grant["lease_id"], "kill": False}, None
                )
            except Exception:
                logger.exception("reclaiming undeliverable grant failed")

    def _notify_capacity(self) -> None:
        """Wake the granter (called from release paths, any thread)."""
        self._capacity_signal.set()

    def rpc_release_lease(self, payload, peer):
        lease = self._leases.pop(payload["lease_id"], None)
        if lease is None:
            return {"ok": False}
        # worker back to the idle pool BEFORE freeing resources: the
        # granter races on freed capacity, and losing this race makes it
        # spawn a brand-new worker process (seconds) instead of reusing
        # the one we are returning right now
        w: WorkerHandle = lease["worker"]
        if payload.get("kill") or not w.alive():
            w.kill()
            with self._wlock:
                self._all_workers.pop(w.worker_id, None)
        else:
            w.idle_since = time.monotonic()
            with self._wlock:
                self._idle_workers.setdefault(w.env_key, []).append(w)
        self._cards.release(lease["cards"], float(lease["resources"].get("GPU", 0)))
        with self._res_lock:
            pool = self._bundles.get(lease["pg_key"]) if lease["pg_key"] else None
            self._release(lease["resources"], pool)
        self._notify_capacity()
        return {"ok": True}

    # -- placement group bundles ----------------------------------------------

    def rpc_reserve_pg_bundle(self, payload, peer):
        key = (payload["pg_id"], payload["bundle_index"])
        res = payload["resources"]
        with self._res_lock:  # atomic check-then-reserve across handlers
            if key in self._bundles:
                return {"ok": True}  # idempotent
            if not self._try_acquire(res):
                return {"ok": False, "error": "insufficient resources"}
            self._bundles[key] = dict(res)
        self._notify_capacity()  # pg-queued leases can now be granted
        return {"ok": True}

    def rpc_release_pg_bundle(self, payload, peer):
        key = (payload["pg_id"], payload["bundle_index"])
        with self._res_lock:
            pool = self._bundles.pop(key, None)
            if pool is None:
                return {"ok": False}
            # return whatever is still reserved plus whatever tasks gave back
            self._release(pool)
        self._notify_capacity()
        return {"ok": True}

    def rpc_release_pg_all(self, payload, peer):
        pg_id = payload["pg_id"]
        with self._res_lock:
            for key in [k for k in self._bundles if k[0] == pg_id]:
                self._release(self._bundles.pop(key))
        self._notify_capacity()
        return {"ok": True}

    # -- object service -------------------------------------------------------

    def rpc_put_object(self, payload, peer):
        self.objects.put(payload["object_id"], payload["data"])
        return {"ok": True}

    def rpc_object_sealed(self, payload, peer):
        """A colocated worker sealed this object straight into the shared-
        memory store — adopt (pin) it; the bytes never cross an RPC
        (reference: plasma seal notification, plasma/client.cc)."""
        return {"ok": self.objects.adopt_shm(payload["object_id"])}

    def rpc_object_meta(self, payload, peer):
        size = self.objects.local_size(payload["object_id"])
        return None if size is None else {"size": size}

    def rpc_object_chunk(self, payload, peer):
        return self.objects.local_slice(
            payload["object_id"], payload["offset"], payload["length"]
        )

    def rpc_fetch_object(self, payload, peer):
        """Blocking local-or-remote fetch (driver/worker `get` path)."""
        return self.objects.fetch(
            payload["object_id"], timeout=payload.get("timeout", 30.0)
        )

    def rpc_fetch_objects(self, payload, peer):
        """Batched fetch in ONE handler thread (a wide batch of blocking
        single fetches would pin one executor thread per ref and starve
        the daemon's put path — deadlock under load).

        shm_direct: the caller has the node's shm store mapped (a local
        driver) — SEALED shm objects come back as a {"__shm__"} marker
        it reads zero-RPC from the mapping; the daemon never even
        materializes the bytes (the large-task-return bandwidth
        ceiling, round-5 profile)."""
        return self.objects.fetch_many(
            payload["object_ids"], timeout=payload.get("timeout", 30.0),
            shm_markers=bool(payload.get("shm_direct")),
        )

    def rpc_free_object(self, payload, peer):
        self.objects.free(payload["object_id"])
        return {"ok": True}

    # -- misc -----------------------------------------------------------------

    def rpc_shm_info(self, payload, peer):
        """Local clients (drivers) attach the store read-side with this —
        the plasma-client role (same handshake workers get in register)."""
        return {"shm_path": self.objects.shm_path}

    def rpc_record_spans(self, payload, peer):
        """Batched execution spans from this node's workers (reference:
        worker ProfileEvents flowing to the task-event pipeline). Bounded
        buffer; rpc_timeline serves it to the dashboard/state API."""
        self._spans.extend(payload.get("spans", ()))
        return {"ok": True}

    def rpc_timeline(self, payload, peer):
        since = float(payload.get("since", 0.0)) if payload else 0.0
        return [s for s in list(self._spans)
                if float(s.get("end", 0.0)) >= since]

    def _telemetry_snapshot(self) -> dict:
        """Refresh this node's utilization gauges, then snapshot ONLY the
        series this daemon owns (name prefix + node tag): a test daemon
        colocated with other subsystems in one process must not re-ship
        their series under its own reporter id (double count)."""
        from ray_tpu_torch.obs.telemetry import annotated_snapshot

        g = _node_gauges()
        tags = {"node": self.node_id}
        with self._wlock:
            num_workers = len(self._all_workers)
        with self._res_lock:
            num_leases = len(self._leases)
        g["workers"].set(num_workers, tags=tags)
        g["leases"].set(num_leases, tags=tags)
        g["queued_leases"].set(self._num_queued, tags=tags)
        g["object_bytes"].set(self.objects.stats()["bytes"], tags=tags)
        g["oom_kills"].set(self._oom_kills, tags=tags)
        node_id = self.node_id
        return annotated_snapshot(
            lambda name, t: name.startswith("ray_tpu_node_")
            and t.get("node") == node_id
        )

    def rpc_stats(self, payload, peer):
        # invariant: _all_workers is _wlock state — snapshot it under its
        # own lock BEFORE _res_lock (never nested: lock-order discipline)
        with self._wlock:
            num_workers = len(self._all_workers)
        with self._res_lock:
            return {
                "node_id": self.node_id,
                "total": dict(self.total),
                "available": dict(self.available),
                "num_leases": len(self._leases),
                "num_oom_kills": self._oom_kills,
                "num_workers": num_workers,
                "objects": self.objects.stats(),
            }


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--gcs", required=True)
    p.add_argument("--node-id", default=None)
    p.add_argument("--resources", default="num_cpus=1")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--worker-env", default="", help="k=v,... for worker processes")
    p.add_argument("--object-capacity", type=int, default=512 << 20,
                   help="object store memory tier cap in bytes (LRU spills to disk)")
    p.add_argument("--worker-rss-limit-mb", type=int, default=0,
                   help="kill any worker whose RSS exceeds this (0 = off)")
    p.add_argument("--memory-usage-threshold", type=float, default=0.95,
                   help="node memory fraction that triggers worker kills "
                        "(>=1.0 disables the pressure trigger)")
    p.add_argument("--memory-monitor-interval", type=float, default=1.0,
                   help="memory monitor tick seconds (0 disables entirely)")
    p.add_argument("--telemetry-interval", type=float, default=2.0,
                   help="seconds between metrics snapshots piggybacked on "
                        "heartbeats (0 disables)")
    args = p.parse_args()
    gcs_addr = parse_gcs_addr(args.gcs)  # "h:p" or a primary and its standby "h1:p1,h2:p2"
    resources: dict[str, float] = {}
    for kv in args.resources.split(","):
        if kv:
            k, v = kv.split("=")
            resources[k] = float(v)
    worker_env: dict[str, str] = {}
    for kv in args.worker_env.split(","):
        if kv:
            k, v = kv.split("=", 1)
            worker_env[k] = v
    _chaos.install_from_env()  # adopt a schedule the driver exported
    daemon = NodeDaemon(
        gcs_addr, resources, node_id=args.node_id, worker_env=worker_env,
        object_capacity_bytes=args.object_capacity,
        worker_rss_limit_mb=args.worker_rss_limit_mb,
        memory_usage_threshold=args.memory_usage_threshold,
        memory_monitor_interval_s=args.memory_monitor_interval,
        telemetry_interval_s=args.telemetry_interval,
    )
    addr = daemon.start()
    print(f"NODE_ADDRESS {addr[0]}:{addr[1]} {daemon.node_id}", flush=True)

    import signal

    def _on_sigterm(signum, frame):
        # graceful-drain contract: stop admission, finish in-flight work,
        # deregister from the GCS, exit — run off the signal frame so
        # blocking waits are legal
        def _run():
            daemon.drain(timeout_s=float(
                os.environ.get("RAY_TPU_DRAIN_TIMEOUT_S", "30")
            ))
            os._exit(0)

        threading.Thread(target=_run, name="sigterm-drain", daemon=True).start()

    signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        daemon.stop()


if __name__ == "__main__":
    main()
