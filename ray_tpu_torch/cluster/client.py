"""Driver-side cluster runtime: submit/get/put/wait/actors over the RPC plane.

Reference analog: the submit path of the core worker
(src/ray/core_worker/core_worker.cc:2475 SubmitTask ->
transport/normal_task_submitter.h:74 — lease request, spillback retry,
PushNormalTask to the leased worker) and the actor submit path
(transport/actor_task_submitter.h:382). Redesigned around the node
daemon's lease RPC: the driver leases from its local daemon, follows at
most a few spillback hops, pushes the task directly to the granted
worker, and releases the lease when the push returns. Results live in
node object stores; `get` pulls through the local daemon's fetch path.

Failure handling: a dead worker/node surfaces as a transport error on
the push; the task is re-leased elsewhere up to `max_retries` (the
reference's task_manager.h:260 retry loop, node-failure edition).

A copy of ``ray_tpu/cluster/client.py``: functions and values go through
the port's stdlib pickler (``cluster/serialization.py``) where the
reference uses cloudpickle, ``num_gpus`` leases ride the ``"GPU"``
resource, and actor methods' ``.bind`` waits for the DAG nodes (ROADMAP.md
Queue 1, item 6, part 6). Left out: the reference's client-side lease
cache (``RAY_TPU_LEASE_CACHE_TTL``, off by default there and measured
slower than the daemon's queue): a lease is released when its task ends.
Given a primary GCS and its standby (``ClusterClient(((h1, p1), (h2, p2)),
daemon)``), the GCS client follows the primary across a failover.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Optional, Sequence

from ray_tpu_torch.chaos import harness as _chaos
from ray_tpu_torch.cluster.rpc import (
    ClientPool,
    ReconnectingRpcClient,
    RemoteError,
    RpcClient,
    RpcError,
)
from ray_tpu_torch.cluster.serialization import _ErrorValue, dumps_value, loads_value
from ray_tpu_torch.core.serialization import dumps as _dumps_by_value
from ray_tpu_torch.util.backoff import ExponentialBackoff
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.cluster.client")


class ClusterTaskError(Exception):
    def __init__(self, desc: str, cause: BaseException, tb: str):
        super().__init__(f"{desc} failed: {cause!r}\n{tb}")
        self.cause = cause


class ActorDiedError(Exception):
    pass


class GetTimeoutError(Exception):
    pass


def _new_id() -> bytes:
    return uuid.uuid4().bytes


def _current_trace_dict() -> Optional[dict]:
    """Ambient TraceContext as an envelope-ready dict (None when the
    caller isn't tracing). Tracing must never break submission."""
    try:
        from ray_tpu_torch.obs import context as trace_context

        ctx = trace_context.current()
        return ctx.to_dict() if ctx is not None else None
    except Exception:  # noqa: BLE001
        return None


class ClusterObjectRef:
    """A future for an object living in some node's store.

    Refs created by the OWNING client (put / task returns) participate in
    driver-side ref counting: when the last owned handle drops, the
    object is freed cluster-wide (reference: owner-based ref counting,
    src/ray/core_worker/reference_count.h:66 — here collapsed to the
    driver as sole owner; deserialized/borrowed refs never free)."""

    __slots__ = ("id", "_client", "_desc", "_owned")

    def __init__(self, object_id: bytes, client: "ClusterClient", desc: str = "",
                 owned: bool = False):
        self.id = object_id
        self._client = client
        self._desc = desc
        self._owned = owned
        if owned:
            client._mark_owned(object_id)
            client._incref(object_id)

    def get(self, timeout: Optional[float] = None):
        return self._client.get(self, timeout=timeout)

    def __reduce__(self):
        # travels as a persistent id through dumps_value; plain pickling
        # (e.g. inside foreign containers) rebuilds against the ambient
        # client on the receiving side — as a BORROWED ref
        return (_rebuild_ref, (self.id, self._desc))

    def __del__(self):
        if getattr(self, "_owned", False):
            try:
                self._client._decref(self.id)
            except Exception:
                pass

    def __repr__(self):
        return f"ClusterObjectRef({self.id.hex()[:12]}, {self._desc})"


def _rebuild_ref(object_id: bytes, desc: str) -> "ClusterObjectRef":
    return ClusterObjectRef(object_id, _ambient_client(), desc)


_AMBIENT: list = [None]


def _ambient_client():
    c = _AMBIENT[0]
    if c is None:
        raise RuntimeError("no ClusterClient in this process")
    return c


class ClusterActorHandle:
    """Location-transparent actor handle (actor_id + GCS lookup)."""

    def __init__(self, actor_id: bytes, client: "ClusterClient", desc: str = "actor"):
        self._actor_id = actor_id
        self._client = client
        self._desc = desc

    def __getattr__(self, name: str) -> "_ActorMethod":
        if name.startswith("_"):
            raise AttributeError(name)
        return _ActorMethod(self, name)

    def __reduce__(self):
        return (_rebuild_handle, (self._actor_id, self._desc))

    def kill(self) -> None:
        self._client.kill_actor(self._actor_id)

    @property
    def state(self) -> str:
        info = self._client.gcs.call("get_actor", {"actor_id": self._actor_id})
        return info["state"] if info else "UNKNOWN"


def _rebuild_handle(actor_id: bytes, desc: str) -> ClusterActorHandle:
    return ClusterActorHandle(actor_id, _ambient_client(), desc)


class _ActorMethod:
    def __init__(self, handle: ClusterActorHandle, name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args, **kwargs):
        h = self._handle
        return h._client.submit_actor_task(
            h._actor_id, self._name, args, kwargs
        )

    def bind(self, *args, **kwargs):
        """A compiled-graph node (the reference's ClassMethodNode): not
        ported yet."""
        raise NotImplementedError(
            f"actor method {self._name}.bind: the DAG nodes of ray_tpu/dag "
            "(ROADMAP.md Queue 1, item 6, part 6)")

    def options(self, num_returns: int = 1):
        method = self

        class _Opts:
            def remote(self_o, *args, **kwargs):
                h = method._handle
                return h._client.submit_actor_task(
                    h._actor_id, method._name, args, kwargs,
                    num_returns=num_returns,
                )

        return _Opts()


class ClusterClient:
    """One per driver process. `local_daemon` is the colocated node daemon
    the driver leases from and fetches through (the head node's raylet)."""

    def __init__(self, gcs_addr: tuple, local_daemon_addr: tuple):
        # reconnecting: survives a GCS restart (FT snapshot + same port)
        self.gcs = ReconnectingRpcClient(*gcs_addr, timeout=60.0).connect(retries=20)
        self.local_daemon_addr = tuple(local_daemon_addr)
        self.pool = ClientPool(timeout=120.0)
        self._lock = threading.Lock()
        # ref-count ops flow through a lock-free deque consumed by ONE
        # accountant thread: __del__ may fire from cyclic GC while this
        # thread holds any lock, so the hot path must only deque.append
        # (GIL-atomic) — taking a client lock there can self-deadlock
        from collections import deque as _deque

        self._rc_ops: "_deque[tuple[str, bytes]]" = _deque()
        self._spans: "_deque[dict]" = _deque(maxlen=10000)  # task tracing
        # drivers own their objects and free on last handle drop; worker
        # processes only BORROW (their task returns are owned by the
        # submitting driver) — worker_main flips this off so a worker
        # dropping a ref it created for a nested submit can't free an
        # object some caller still holds
        self.auto_free = True
        self._closed = False
        # lineage: return-oid -> shared task record, enough to RE-EXECUTE
        # the producing task when its stored result is lost with the node
        # that held it (reference: lineage reconstruction driven by the
        # ownership table, core_worker object recovery). Depth 1: a
        # reconstruction whose ARGS were also lost fails over to the
        # normal task-lost error. Bounded; entries drop with the ref.
        self._lineage: dict[bytes, dict] = {}
        self._lineage_cap = 8192
        self._lineage_guard = threading.Lock()  # check-then-act on records
        self._freer = threading.Thread(
            target=self._rc_loop, name="ray_tpu-freer", daemon=True
        )
        self._freer.start()
        # bounded submitter pool: thread-per-task melts down under wide
        # fan-out (thousands of threads fighting the GIL); a pool sized to
        # the host caps that while keeping pushes concurrent. Long-running
        # pushes hold a pool thread, so size it generously.
        import concurrent.futures
        import os as _os

        self._submitter = concurrent.futures.ThreadPoolExecutor(
            max_workers=min(64, 8 * (_os.cpu_count() or 4)),
            thread_name_prefix="ray_tpu_torch-submit",
        )
        # plasma-client role: attach the local daemon's shm store READ side
        # so get() of same-node sealed objects never round-trips the RPC
        # plane (reference: the driver IS a plasma client; round-5 profile:
        # the daemon->driver pickle+TCP copy was the large-return ceiling)
        self._shm = None
        self._shm_tried = False
        _AMBIENT[0] = self

    @property
    def local_daemon(self) -> RpcClient:
        return self.pool.get(self.local_daemon_addr)

    def _local_shm(self):
        if not self._shm_tried:
            self._shm_tried = True
            try:
                info = self.local_daemon.call("shm_info", None, timeout=10)
                path = (info or {}).get("shm_path")
                if path:
                    from ray_tpu_torch.native.shm import ShmObjectStore

                    self._shm = ShmObjectStore.open(path)
            except Exception:  # noqa: BLE001 — store unavailable: RPC path
                self._shm = None
        return self._shm

    def _shm_get(self, object_id: bytes):
        """Zero-RPC read of a same-node sealed object, or None."""
        shm = self._local_shm()
        if shm is None:
            return None
        try:
            return shm.get_bytes(object_id)
        except OSError:
            return None

    def close(self) -> None:
        self._closed = True
        self._submitter.shutdown(wait=False, cancel_futures=True)
        self.gcs.close()
        self.pool.close_all()
        if self._shm is not None:
            try:
                self._shm.close()
            except Exception:  # noqa: BLE001
                pass
            self._shm = None
        if _AMBIENT[0] is self:
            _AMBIENT[0] = None

    # -- driver-side ref counting ---------------------------------------------
    # Only OWNED ids ("own" op: put / task returns created here) are ever
    # freed; borrowed refs pinned as task args inc/dec without freeing.

    def _incref(self, object_id: bytes) -> None:
        self._rc_ops.append(("inc", object_id))

    def _decref(self, object_id: bytes) -> None:
        self._rc_ops.append(("dec", object_id))

    def _mark_owned(self, object_id: bytes) -> None:
        self._rc_ops.append(("own", object_id))

    def free(self, refs) -> None:
        """Explicitly free objects cluster-wide (ray._private free analog)."""
        if not isinstance(refs, (list, tuple)):
            refs = [refs]
        for r in refs:
            self._rc_ops.append(("free", r.id))

    def _rc_loop(self) -> None:
        """The accountant: applies ref-count ops, frees owned objects on
        their last decref (reference: ReferenceCounter's delete callback,
        reference_count.h:66). A ref dropped BEFORE its task stored the
        result has no locations yet — those frees retry until the object
        appears (else fire-and-forget results would leak forever)."""
        counts: dict[bytes, int] = {}
        owned: set[bytes] = set()
        retries: dict[bytes, tuple[float, int]] = {}  # oid -> (due, attempts)
        while not self._closed:
            now = time.monotonic()
            for oid, (due, attempts) in list(retries.items()):
                if due <= now:
                    if self._free_everywhere(oid) or attempts >= 120:
                        retries.pop(oid, None)
                    else:
                        retries[oid] = (now + 1.0, attempts + 1)
            if not self._rc_ops:
                time.sleep(0.05)
                continue
            try:
                op, oid = self._rc_ops.popleft()
            except IndexError:
                continue
            if op == "inc":
                counts[oid] = counts.get(oid, 0) + 1
            elif op == "own":
                owned.add(oid)
            elif op == "dec":
                n = counts.get(oid, 0) - 1
                if n > 0:
                    counts[oid] = n
                else:
                    counts.pop(oid, None)
                    if oid in owned and self.auto_free:
                        owned.discard(oid)
                        self._lineage.pop(oid, None)  # freed: never rebuild
                        if not self._free_everywhere(oid):
                            retries[oid] = (time.monotonic() + 1.0, 1)
            elif op == "free":
                owned.discard(oid)
                counts.pop(oid, None)
                retries.pop(oid, None)
                self._lineage.pop(oid, None)
                self._free_everywhere(oid)

    def _free_everywhere(self, oid: bytes) -> bool:
        """Free on every holder; returns True when at least one holder
        existed (False = object not stored anywhere yet)."""
        try:
            locs = self.gcs.call("locate_object", {"object_id": oid}, timeout=10)
        except Exception:
            return False
        freed = False
        for addr in locs or ():
            freed = True
            try:
                self.pool.get(tuple(addr)).call(
                    "free_object", {"object_id": oid}, timeout=10
                )
            except (RpcError, RemoteError):
                pass
        return freed

    # -- kv -------------------------------------------------------------------

    def kvtier_update(self, payload: dict, timeout: float = 5.0) -> dict:
        """Ship one engine's prefix-index snapshot to the GCS
        (llm/kvtier; epoch-banked — a dropped or delayed snapshot can
        only cost freshness, the next one supersedes it)."""
        return self.gcs.call("kvtier_update", payload, timeout=timeout)

    def kvtier_lookup(self, hashes: list, timeout: float = 5.0) -> dict:
        """Longest indexed KV prefix per engine for these chain hashes
        (prefix-aware routing; callers treat failure as a dark index
        and fall back to their queue-depth ladder)."""
        return self.gcs.call("kvtier_lookup", {"hashes": list(hashes)},
                             timeout=timeout)

    def kvtier_stats(self, timeout: float = 5.0) -> dict:
        return self.gcs.call("kvtier_stats", None, timeout=timeout)

    def kv_put(self, key: bytes, value: bytes, ns: str = "default") -> None:
        self.gcs.call("kv_put", {"ns": ns, "key": key, "value": value})

    def kv_get(self, key: bytes, ns: str = "default"):
        return self.gcs.call("kv_get", {"ns": ns, "key": key})

    def kv_del(self, key: bytes, ns: str = "default") -> None:
        self.gcs.call("kv_del", {"ns": ns, "key": key})

    def kv_wait(self, key: bytes, ns: str = "default",
                timeout: float = 120.0):
        """Block until `key` exists (server-side long-poll loop); returns
        its value, or raises TimeoutError."""
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"kv_wait({ns}/{key!r}) after {timeout}s")
            v = self.gcs.call(
                "kv_wait", {"ns": ns, "key": key, "wait": min(remaining, 5.0)}
            )
            if v is not None:
                return v

    # -- objects --------------------------------------------------------------

    def put(self, value: Any) -> ClusterObjectRef:
        oid = _new_id()
        self.local_daemon.call(
            "put_object", {"object_id": oid, "data": dumps_value(value)}
        )
        return ClusterObjectRef(oid, self, "put", owned=True)

    def get(self, ref: "ClusterObjectRef | Sequence[ClusterObjectRef]",
            timeout: Optional[float] = None):
        if isinstance(ref, (list, tuple)):
            return type(ref)(self._get_many(list(ref), timeout))
        deadline = time.monotonic() + (timeout if timeout is not None else 300.0)
        t0 = time.monotonic()
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise GetTimeoutError(f"get({ref!r}) timed out")
            data = self._shm_get(ref.id)
            if data is None:
                data = self.local_daemon.call(
                    "fetch_object",
                    {"object_id": ref.id, "timeout": min(remaining, 5.0)},
                    timeout=min(remaining, 5.0) + 10,
                )
            if data is None and time.monotonic() - t0 > 2.0:
                self._maybe_reconstruct(ref.id)
            if data is not None:
                value = loads_value(data, self._resolve)
                if isinstance(value, _ErrorValue):
                    raise ClusterTaskError(value.task_desc, value.exc, value.tb)
                return value

    def _get_many(self, refs: list, timeout: Optional[float]) -> list:
        """Batched get: pipelined fetch_object frames on one connection
        (not one blocking round-trip per ref)."""
        deadline = time.monotonic() + (timeout if timeout is not None else 300.0)
        out: dict[int, Any] = {}
        pending = list(enumerate(refs))
        t0 = time.monotonic()
        while pending:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise GetTimeoutError(f"get of {len(pending)} refs timed out")
            # shm fast path first: same-node sealed results cost zero RPCs
            rpc_pending = []
            for i, r in pending:
                data = self._shm_get(r.id)
                if data is not None:
                    value = loads_value(data, self._resolve)
                    if isinstance(value, _ErrorValue):
                        raise ClusterTaskError(
                            value.task_desc, value.exc, value.tb
                        )
                    out[i] = value
                else:
                    rpc_pending.append((i, r))
            pending = rpc_pending
            if not pending:
                break
            step = min(remaining, 5.0)
            datas = self.local_daemon.call(
                "fetch_objects",
                {"object_ids": [r.id for _, r in pending], "timeout": step,
                 "shm_direct": self._local_shm() is not None},
                timeout=step + 30,
            )
            still = []
            reconstruct = time.monotonic() - t0 > 2.0
            for (i, r), data in zip(pending, datas):
                if data is None:
                    if reconstruct:
                        self._maybe_reconstruct(r.id)
                    still.append((i, r))
                    continue
                if isinstance(data, dict) and data.get("__shm__"):
                    data = self._shm_get(r.id)
                    if data is None:  # evicted between marker and read
                        step2 = max(0.1, min(deadline - time.monotonic(), 5.0))
                        data = self.local_daemon.call(
                            "fetch_object",
                            {"object_id": r.id, "timeout": step2},
                            timeout=step2 + 10,
                        )
                    if data is None:
                        still.append((i, r))
                        continue
                value = loads_value(data, self._resolve)
                if isinstance(value, _ErrorValue):
                    raise ClusterTaskError(value.task_desc, value.exc, value.tb)
                out[i] = value
            pending = still
        return [out[i] for i in range(len(refs))]

    def _resolve(self, object_id: bytes):
        data = self._shm_get(object_id)
        if data is None:
            data = self.local_daemon.call(
                "fetch_object", {"object_id": object_id, "timeout": 30.0},
                timeout=40,
            )
        if data is None:
            raise RuntimeError(f"object {object_id.hex()} unavailable")
        value = loads_value(data, self._resolve)
        if isinstance(value, _ErrorValue):
            raise ClusterTaskError(value.task_desc, value.exc, value.tb)
        return value

    def wait(self, refs: Sequence[ClusterObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        ready: list = []
        pending = list(refs)
        t0 = time.monotonic()
        while len(ready) < num_returns:
            # one batched probe per poll (not one RPC per ref)
            have = self.gcs.call(
                "locate_many", {"object_ids": [r.id for r in pending]}
            )
            still = []
            reconstruct = time.monotonic() - t0 > 2.0
            for r in pending:
                if have.get(r.id):
                    ready.append(r)
                else:
                    if reconstruct:
                        self._maybe_reconstruct(r.id)
                    still.append(r)
            pending = still
            if len(ready) >= num_returns:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(0.02)
        return ready, pending

    # -- task submission ------------------------------------------------------

    def submit(
        self,
        func,
        args: tuple = (),
        kwargs: Optional[dict] = None,
        *,
        resources: Optional[dict] = None,
        num_returns: int = 1,
        max_retries: int = 3,
        pg_id: Optional[bytes] = None,
        bundle_index: int = 0,
        desc: Optional[str] = None,
        affinity_node_id: Optional[str] = None,
        affinity_soft: bool = False,
        runtime_env: Optional[dict] = None,
    ) -> "ClusterObjectRef | list[ClusterObjectRef]":
        desc = desc or getattr(func, "__name__", "task")
        return_ids = [_new_id() for _ in range(num_returns)]
        # pin argument objects until the task completes: user code may drop
        # its handles while the task is still pending/retrying
        arg_refs: list[bytes] = []
        payload = {
            "task_id": _new_id(),
            "desc": desc,
            "func": self._dumps_func(func),
            "args": dumps_value((args, dict(kwargs or {})), arg_refs.append),
            "return_ids": return_ids,
            "num_returns": num_returns,
            # trace context rides the envelope: captured HERE (the caller
            # thread) because _drive_task runs on the submitter pool where
            # the contextvar is gone
            "trace": _current_trace_dict(),
        }
        for oid in arg_refs:
            self._incref(oid)
        spec = {
            # None -> default 1 CPU; an explicit {} means "costs nothing"
            "resources": dict({"num_cpus": 1} if resources is None else resources),
            "pg_id": pg_id,
            "bundle_index": bundle_index,
            "affinity_node_id": affinity_node_id,
            "affinity_soft": affinity_soft,
            "runtime_env": self._package_runtime_env(runtime_env),
            # the daemon's memory monitor prefers killing retriable work
            # (reference: worker_killing_policy retriable-first)
            "retriable": max_retries > 0,
        }
        if (self.auto_free and max_retries > 0
                and len(self._lineage) < self._lineage_cap):
            # max_retries=0 means the caller forbids re-execution (side
            # effects); such tasks are never rebuilt from lineage either
            record = {
                "payload": payload, "spec": spec, "arg_refs": list(arg_refs),
                "attempts": 2, "done": False, "inflight": True,
                "max_retries": max_retries,
            }
            for rid in return_ids:
                self._lineage[rid] = record
        else:
            record = None
        fut = self._submitter.submit(
            self._drive_task, payload, spec, max_retries, arg_refs
        )
        if record is not None:
            def _done(_f, rec=record):
                rec["done"] = True
                rec["inflight"] = False

            fut.add_done_callback(_done)
        refs = [ClusterObjectRef(rid, self, desc, owned=True) for rid in return_ids]
        return refs[0] if num_returns == 1 else refs

    def _maybe_reconstruct(self, object_id: bytes) -> bool:
        """If `object_id` is a finished task's return that no node holds
        anymore, re-execute the producing task (same return ids). Returns
        True when a reconstruction was dispatched."""
        rec = self._lineage.get(object_id)
        if rec is None or rec["inflight"] or not rec["done"] or rec["attempts"] <= 0:
            return False
        try:
            locs = self.gcs.call(
                "locate_object", {"object_id": object_id}, timeout=10
            )
        except Exception:  # noqa: BLE001 — treat a flaky GCS as "not lost"
            return False
        if locs:
            return False  # stored somewhere; the fetch path will find it
        with self._lineage_guard:
            # re-check under the lock: concurrent get()/wait() callers on
            # the same lost task must dispatch exactly ONE re-execution
            if rec["inflight"] or not rec["done"] or rec["attempts"] <= 0:
                return False
            rec["attempts"] -= 1
            rec["inflight"] = True
            rec["done"] = False
        logger.warning(
            "object %s lost with its node; re-executing task %r via lineage",
            object_id.hex()[:12], rec["payload"]["desc"],
        )
        for oid in rec["arg_refs"]:
            self._incref(oid)
        fut = self._submitter.submit(
            self._drive_task, rec["payload"], rec["spec"],
            rec.get("max_retries", 3), rec["arg_refs"],
        )

        def _done(_f, r=rec):
            r["done"] = True
            r["inflight"] = False

        fut.add_done_callback(_done)
        return True

    _FUNC_PICKLE_CACHE_MAX = 256

    def _dumps_func(self, func) -> bytes:
        """Memoized pickle of the task function (by value where it cannot
        be imported, ``core/serialization.py``): a task storm over
        one function pays the (closure-walking) pickle once, not per
        submit. Keyed by identity — a redefined function is a new
        object.

        Semantics note (matches the reference): ray exports a remote
        function ONCE and reuses the pickled form, so globals/closure
        cells are snapshotted at first submission — mutating a captured
        global between submits does not reach later tasks. Pass changing
        values as ARGUMENTS."""
        cache = getattr(self, "_func_pickles", None)
        if cache is None:
            cache = self._func_pickles = {}
        key = id(func)
        hit = cache.get(key)
        # id() recycles after GC: keep a strong ref to the function in
        # the cache entry so the key can't be reused by a different one
        if hit is not None and hit[0] is func:
            return hit[1]
        data = _dumps_by_value(func)
        if len(cache) >= self._FUNC_PICKLE_CACHE_MAX:
            cache.clear()
        cache[key] = (func, data)
        return data

    def _drive_task(self, payload: dict, spec: dict, max_retries: int,
                    arg_refs: Sequence[bytes] = ()) -> None:
        attempt = 0
        exclude: list = []
        # jittered exponential retry delay: N submitters whose tasks died
        # with one node must not re-lease in synchronized 0.1s waves
        backoff = ExponentialBackoff(base=0.1, cap=2.0)
        try:
            while True:
                try:
                    self._run_once(payload, spec, exclude)
                    return
                except (RpcError, RemoteError) as e:
                    if self._closed:
                        return  # the driver detached: nobody reads the result
                    attempt += 1
                    if attempt > max_retries:
                        err = _ErrorValue(
                            RuntimeError(f"task lost after {max_retries} retries: {e}"),
                            "", payload["desc"],
                        )
                        for rid in payload["return_ids"]:
                            try:
                                self.local_daemon.call(
                                    "put_object",
                                    {"object_id": rid, "data": dumps_value(err)},
                                )
                            except Exception:
                                logger.exception("cannot store task-lost error")
                        return
                    logger.warning(
                        "%s attempt %d failed (%s); retrying", payload["desc"],
                        attempt, e,
                    )
                    backoff.sleep()
        finally:
            for oid in arg_refs:  # unpin the task's argument objects
                self._decref(oid)

    def _lease(self, spec: dict, exclude: list) -> tuple[dict, RpcClient]:
        """Lease a worker, following spillback hops. Nodes that refused
        this lease are excluded for subsequent hops (prevents ping-pong on
        stale availability views); the visited set resets when the whole
        cluster is saturated and we fall back to waiting."""
        addr = self.local_daemon_addr
        pinned = False
        if spec.get("affinity_node_id") is not None:
            # NodeAffinity: lease directly on the named node (reference:
            # scheduling_strategies.py NodeAffinitySchedulingStrategy)
            nodes = {n["node_id"]: n for n in self.gcs.call("list_nodes", None)}
            target = nodes.get(spec["affinity_node_id"])
            if target is None or not target["alive"]:
                if not spec.get("affinity_soft"):
                    raise RemoteError(RuntimeError(
                        f"node {spec['affinity_node_id']} not alive (hard affinity)"
                    ))
            else:
                addr = tuple(target["addr"])
                pinned = not spec.get("affinity_soft", False)
        if spec.get("pg_id") is not None:
            # placement-group tasks go straight to the node holding the
            # reserved bundle (reference: PG scheduling strategy bypasses
            # the hybrid policy); bundle_index -1 = any bundle that fits
            # (reference wildcard semantics, placement_group.py)
            return self._lease_pg(spec)
        deadline = time.monotonic() + 120.0
        visited: set = set()
        hops = 0
        # lease re-poll: jittered exponential (floored by the daemon's
        # retry_after hint) so saturated-cluster waiters decorrelate
        # instead of hammering the daemon queue in phase
        backoff = ExponentialBackoff(base=0.05, cap=1.0)
        while time.monotonic() < deadline:
            daemon = self.pool.get(addr)
            r = daemon.call(
                "request_worker_lease",
                {**spec, "exclude": list(set(exclude) | visited),
                 "pinned": pinned},
                timeout=90,
            )
            if "grant" in r:
                return r["grant"], daemon
            if "node_id" in r:
                visited.add(r["node_id"])
            if "spillback" in r and hops < 16 and not pinned:
                addr = tuple(r["spillback"])
                hops += 1
                continue
            if "error" in r:
                raise RemoteError(RuntimeError(r["error"]))
            backoff.sleep(floor=r.get("retry_after", 0.0))
            visited.clear()  # capacity may have freed anywhere
            hops = 0
            if not pinned:
                addr = self.local_daemon_addr  # re-evaluate from home
        raise RpcError("lease request timed out")

    def _lease_pg(self, spec: dict) -> tuple[dict, RpcClient]:
        """Lease inside a placement group: a fixed bundle (index >= 0) or
        any bundle that grants (index -1), sweeping until the deadline."""
        deadline = time.monotonic() + 120.0
        backoff = ExponentialBackoff(base=0.05, cap=1.0)
        while time.monotonic() < deadline:
            info = self.gcs.call("get_pg", {"pg_id": spec["pg_id"]})
            if info is None:
                raise RemoteError(RuntimeError("placement group removed"))
            idx = spec.get("bundle_index", 0)
            candidates = [idx] if idx >= 0 else list(range(len(info["bundles"])))
            nodes = {n["node_id"]: tuple(n["addr"]) for n in
                     self.gcs.call("list_nodes", None)}
            delay = 0.05
            # a fixed bundle queues server-side for the full window; a
            # wildcard sweep queues briefly per bundle so it keeps rotating
            queue_timeout = 30.0 if idx >= 0 else 0.5
            for i in candidates:
                bundle = info["bundles"][i]
                if bundle["node_id"] is None:
                    continue  # not (re)placed yet
                daemon = self.pool.get(nodes[bundle["node_id"]])
                r = daemon.call(
                    "request_worker_lease",
                    {**spec, "bundle_index": i, "queue_timeout": queue_timeout},
                    timeout=90,
                )
                if "grant" in r:
                    return r["grant"], daemon
                if "error" in r and idx >= 0:
                    raise RemoteError(RuntimeError(r["error"]))
                delay = min(delay, r.get("retry_after", 0.05))
            backoff.sleep(floor=delay)
        raise RpcError("placement-group lease timed out")

    def _release_lease_now(self, grant, daemon_addr, kill: bool = False):
        try:
            self.pool.get(daemon_addr).call(
                "release_lease",
                {"lease_id": grant["lease_id"], "kill": kill},
                timeout=10,
            )
        except (RpcError, RemoteError):
            pass  # daemon died with its node; lease died with it

    def _run_once(self, payload: dict, spec: dict, exclude: list) -> None:
        t0 = time.monotonic()
        grant, daemon = self._lease(spec, exclude)
        t_leased = time.monotonic()
        worker_addr = tuple(grant["worker_addr"])
        kill = False
        try:
            if _chaos.ACTIVE is not None:
                for _f in _chaos.fire(
                    "cluster.push",
                    kinds=(_chaos.KILL_WORKER, _chaos.DROP_RPC,
                           _chaos.DELAY_RPC),
                    desc=payload.get("desc", "task"),
                    node_id=grant.get("node_id", ""),
                ):
                    if _f.kind == _chaos.KILL_WORKER:
                        # kill the granted worker out from under the push:
                        # the connection error below is exactly what a real
                        # worker death mid-lease looks like to the driver
                        self._release_lease_now(
                            grant,
                            tuple(grant.get("node_addr")
                                  or self.local_daemon_addr),
                            kill=True,
                        )
                    elif _f.kind == _chaos.DROP_RPC:
                        raise RpcError(
                            f"chaos: dropped push of {payload.get('desc')!r}"
                        )
                    elif _f.kind == _chaos.DELAY_RPC:
                        time.sleep(_f.delay_s)
            w = self.pool.get(worker_addr)
            r = w.call("push_task", payload, timeout=3600)
            if not r.get("ok"):
                # user-level failure: error value already stored; done
                return
        except (RpcError, RemoteError):
            kill = True
            exclude.append(grant["node_id"])
            self.pool.invalidate(worker_addr)
            raise
        finally:
            self._record_span(
                payload.get("desc", "task"), grant.get("node_id"), t0,
                t_leased, time.monotonic(), trace=payload.get("trace"),
            )
            # the daemon queues lease requests and its idle-worker pool
            # makes re-grant instant, so a lease is released at once
            self._release_lease_now(
                grant, tuple(grant.get("node_addr") or self.local_daemon_addr), kill=kill)

    # -- tracing --------------------------------------------------------------

    def _record_span(self, desc: str, node_id, t0: float, t_leased: float,
                     t_done: float, trace: Optional[dict] = None) -> None:
        """Per-task spans (lease wait + execution), bounded buffer.
        Reference analog: per-task ProfileEvents batched into
        GcsTaskManager powering `ray timeline` (core_worker/
        task_event_buffer.h); here driver-side, exported Chrome-trace."""
        span = {"desc": desc, "node": node_id, "start": t0,
                "leased": t_leased, "end": t_done}
        if trace:
            span["trace_id"] = trace.get("trace_id")
            span["span_id"] = trace.get("span_id")
        self._spans.append(span)

    def timeline(self) -> list:
        """Chrome-trace events (chrome://tracing / Perfetto) for this
        driver's cluster tasks: a `lease` slice and an `exec` slice per
        task, rows grouped by node (the `ray timeline` analog for the
        cluster plane)."""
        spans = list(getattr(self, "_spans", ()))
        events = []
        for i, s in enumerate(spans):
            trace_args = (
                {"trace_id": s["trace_id"], "span_id": s.get("span_id")}
                if s.get("trace_id") else {}
            )
            for name, a, b in (("lease", "start", "leased"),
                               ("exec", "leased", "end")):
                events.append({
                    "name": f"{s['desc']}:{name}",
                    "ph": "X",
                    "ts": s[a] * 1e6,
                    "dur": max(0.0, (s[b] - s[a])) * 1e6,
                    "pid": s["node"] or "cluster",
                    "tid": i % 64,
                    "cat": name,
                    **({"args": trace_args} if trace_args else {}),
                })
        return events

    def task_stats(self) -> dict:
        """Aggregate latency split across recorded spans (ms)."""
        spans = list(getattr(self, "_spans", ()))
        if not spans:
            return {"tasks": 0}
        lease = [(s["leased"] - s["start"]) * 1e3 for s in spans]
        ex = [(s["end"] - s["leased"]) * 1e3 for s in spans]
        lease.sort()
        ex.sort()

        def pct(a, p):
            return round(a[min(len(a) - 1, int(len(a) * p))], 2)

        return {
            "tasks": len(spans),
            "lease_ms_p50": pct(lease, 0.5), "lease_ms_p99": pct(lease, 0.99),
            "exec_ms_p50": pct(ex, 0.5), "exec_ms_p99": pct(ex, 0.99),
        }

    # -- actors ---------------------------------------------------------------

    def create_actor(
        self,
        cls,
        args: tuple = (),
        kwargs: Optional[dict] = None,
        *,
        resources: Optional[dict] = None,
        name: Optional[str] = None,
        namespace: str = "default",
        max_restarts: int = 0,
        pg_id: Optional[bytes] = None,
        bundle_index: int = 0,
        runtime_env: Optional[dict] = None,
    ) -> ClusterActorHandle:
        actor_id = _new_id()
        # ctor-arg objects must outlive the actor (restarts replay the
        # creation_spec); pin them until kill_actor
        ctor_refs: list[bytes] = []
        creation_spec = dumps_value(
            (cls, args, dict(kwargs or {})), ctor_refs.append
        )
        for oid in ctor_refs:
            self._incref(oid)
        spec = {
            # None -> default 1 CPU; an explicit {} means "costs nothing"
            "resources": dict({"num_cpus": 1} if resources is None else resources),
            "pg_id": pg_id,
            "bundle_index": bundle_index,
            "runtime_env": self._package_runtime_env(runtime_env),
            # OOM victim policy: a max_restarts=0 actor is NOT retriable
            "retriable": max_restarts > 0,
        }
        grant, daemon = self._lease(spec, [])
        worker_addr = tuple(grant["worker_addr"])
        w = self.pool.get(worker_addr)
        r = w.call(
            "create_actor",
            {"actor_id": actor_id, "creation_spec": creation_spec,
             # registration metadata rides to the worker too: the node's
             # reconcile report can then resurrect this actor (name and
             # all) on a GCS whose snapshot predates it
             "meta": {"name": name, "namespace": namespace,
                      "max_restarts": max_restarts,
                      "lease_resources": dict(spec["resources"])}},
            timeout=300,
        )
        if not r.get("ok"):
            daemon.call("release_lease", {"lease_id": grant["lease_id"], "kill": True})
            raise ClusterTaskError(
                f"actor {getattr(cls, '__name__', cls)}",
                RuntimeError(r.get("error", "creation failed")),
                r.get("tb", ""),
            )
        reg = self.gcs.call(
            "register_actor",
            {
                "actor_id": actor_id,
                "name": name,
                "namespace": namespace,
                "node_id": grant["node_id"],
                "worker_addr": worker_addr,
                "state": "ALIVE",
                "max_restarts": max_restarts,
                "creation_spec": creation_spec,
                "lease": {"resources": spec["resources"]},
                "lease_id": grant["lease_id"],
                "node_addr": grant.get("node_addr"),
            },
        )
        if not reg.get("ok"):
            raise ValueError(reg.get("error", "actor registration failed"))
        # NOTE: the lease stays held for the actor's lifetime (the worker is
        # dedicated to it); kill_actor releases it.
        self._lock_actor_meta(actor_id, grant, worker_addr, ctor_refs)
        return ClusterActorHandle(
            actor_id, self, desc=getattr(cls, "__name__", "actor")
        )

    def _lock_actor_meta(self, actor_id, grant, worker_addr, ctor_refs=()):
        with self._lock:
            if not hasattr(self, "_actor_meta"):
                self._actor_meta = {}
            self._actor_meta[actor_id] = {
                "grant": grant, "worker_addr": worker_addr,
                "ctor_refs": list(ctor_refs),
            }

    def _actor_worker(self, actor_id: bytes, wait_restart: float = 30.0) -> tuple:
        """Resolve the actor's current worker address (GCS lookup with
        restart-aware waiting)."""
        with self._lock:
            meta = getattr(self, "_actor_meta", {}).get(actor_id)
        if meta is not None:
            return meta["worker_addr"]
        deadline = time.monotonic() + wait_restart
        backoff = ExponentialBackoff(base=0.05, cap=0.5)
        while time.monotonic() < deadline:
            info = self.gcs.call("get_actor", {"actor_id": actor_id})
            if info is None:
                raise ActorDiedError(f"actor {actor_id.hex()} unknown")
            if info["state"] == "ALIVE" and info["worker_addr"]:
                return tuple(info["worker_addr"])
            if info["state"] == "DEAD":
                raise ActorDiedError(f"actor {actor_id.hex()} is dead")
            backoff.sleep()
        raise ActorDiedError(f"actor {actor_id.hex()} not available (restarting?)")

    def submit_actor_task(
        self, actor_id: bytes, method: str, args: tuple, kwargs: dict,
        num_returns: int = 1,
    ):
        return_ids = [_new_id() for _ in range(num_returns)]
        arg_refs: list[bytes] = []
        payload = {
            "actor_id": actor_id,
            "method": method,
            "args": dumps_value((args, dict(kwargs or {})), arg_refs.append),
            "return_ids": return_ids,
            "num_returns": num_returns,
            "trace": _current_trace_dict(),
        }
        for oid in arg_refs:
            self._incref(oid)
        self._submitter.submit(self._drive_actor_task, actor_id, payload, arg_refs)
        refs = [
            ClusterObjectRef(rid, self, f"actor.{method}", owned=True)
            for rid in return_ids
        ]
        return refs[0] if num_returns == 1 else refs

    def _drive_actor_task(self, actor_id: bytes, payload: dict,
                          arg_refs: Sequence[bytes] = ()) -> None:
        backoff = ExponentialBackoff(base=0.2, cap=1.0)
        try:
            for attempt in range(2):
                try:
                    addr = self._actor_worker(actor_id)
                    w = self.pool.get(addr)
                    r = w.call("actor_call", payload, timeout=3600)
                    if r.get("actor_missing") and attempt == 0:
                        # stale address (restart happened): force GCS lookup
                        self._forget_actor_addr(actor_id)
                        continue
                    return
                except (RpcError, RemoteError):
                    self._forget_actor_addr(actor_id)
                    if attempt == 1:
                        break
                    backoff.sleep()
                except ActorDiedError as e:
                    self._store_actor_error(payload, e)
                    return
            self._store_actor_error(
                payload, ActorDiedError(f"actor {actor_id.hex()} unreachable")
            )
        finally:
            for oid in arg_refs:
                self._decref(oid)

    def _forget_actor_addr(self, actor_id: bytes) -> None:
        with self._lock:
            getattr(self, "_actor_meta", {}).pop(actor_id, None)

    def _store_actor_error(self, payload: dict, exc: Exception) -> None:
        err = _ErrorValue(exc, "", f"actor.{payload['method']}")
        for rid in payload["return_ids"]:
            try:
                self.local_daemon.call(
                    "put_object", {"object_id": rid, "data": dumps_value(err)}
                )
            except Exception:
                pass

    def get_named_actor(self, name: str, namespace: str = "default") -> ClusterActorHandle:
        info = self.gcs.call(
            "get_named_actor", {"name": name, "namespace": namespace}
        )
        if info is None or info["state"] == "DEAD":
            raise ValueError(f"no live actor named {name!r}")
        return ClusterActorHandle(info["actor_id"], self, desc=name)

    def kill_actor(self, actor_id: bytes) -> None:
        with self._lock:
            meta = getattr(self, "_actor_meta", {}).pop(actor_id, None)
        for oid in (meta or {}).get("ctor_refs", ()):
            self._decref(oid)  # unpin the ctor args (no more restarts)
        info = self.gcs.call("get_actor", {"actor_id": actor_id})
        if info and info["worker_addr"]:
            try:
                self.pool.get(tuple(info["worker_addr"])).call(
                    "destroy_actor", {"actor_id": actor_id}, timeout=5
                )
            except (RpcError, RemoteError):
                pass
        self.gcs.call(
            "update_actor", {"actor_id": actor_id, "state": "DEAD"}
        )
        # release the backing lease on the daemon that GRANTED it — the
        # GCS entry is authoritative (it tracks restarts onto new nodes;
        # a locally cached grant would go stale after the first restart)
        if info and info.get("lease_id") and info.get("node_addr"):
            try:
                self.pool.get(tuple(info["node_addr"])).call(
                    "release_lease",
                    {"lease_id": info["lease_id"], "kill": True},
                    timeout=5,
                )
            except (RpcError, RemoteError):
                pass

    # -- runtime envs ---------------------------------------------------------

    def _package_runtime_env(self, runtime_env: Optional[dict]) -> Optional[dict]:
        """Zip + stage a runtime env's directories, memoizing the WHOLE
        wire form by (spec, directory fingerprints) so a task storm pays
        one stat-walk per submit instead of a re-zip; staged packages are
        PINNED for the client's lifetime (workers fetch them on every
        env-dedicated worker spawn)."""
        if not runtime_env:
            return None
        import hashlib
        import json
        import os as _os

        from ray_tpu_torch.cluster.runtime_env import (
            package_runtime_env,
            validate_keys,
            walk_dir,
        )

        # validate BEFORE the cache: a cached wire form must not let a
        # later request smuggle a rejected key (pip/conda) past the check
        validate_keys(runtime_env)
        if not hasattr(self, "_env_packages"):
            self._env_packages: dict[str, ClusterObjectRef] = {}
            self._env_wire_cache: dict[str, dict] = {}

        def fingerprint(path: str) -> tuple:
            # mirrors _zip_dir's walk (cycle-safe, __pycache__-free) so
            # pyc churn can't invalidate a byte-identical package
            out = []
            for root, dirs, files in walk_dir(path):
                for f in sorted(files):
                    try:
                        st = _os.stat(_os.path.join(root, f))
                        out.append((_os.path.relpath(_os.path.join(root, f), path),
                                    st.st_size, st.st_mtime_ns))
                    except OSError:
                        pass
            return tuple(out)

        spec_key = json.dumps(
            {
                "env_vars": runtime_env.get("env_vars", {}),
                "working_dir": [runtime_env.get("working_dir"),
                                fingerprint(runtime_env["working_dir"])
                                if runtime_env.get("working_dir") else None],
                "py_modules": [(m, fingerprint(m))
                               for m in runtime_env.get("py_modules", ())],
            },
            sort_keys=True, default=str,
        )
        cached = self._env_wire_cache.get(spec_key)
        if cached is not None:
            return cached

        def put_pkg(data: bytes) -> bytes:
            key = hashlib.sha256(data).hexdigest()
            ref = self._env_packages.get(key)
            if ref is None:
                ref = self.put(data)
                self._env_packages[key] = ref  # pinned until close
            return ref.id

        wire = package_runtime_env(runtime_env, put_pkg)
        self._env_wire_cache[spec_key] = wire
        return wire

    # -- placement groups -----------------------------------------------------

    def create_placement_group(
        self, bundles: list, strategy: str = "PACK", name: Optional[str] = None,
        timeout: float = 30.0,
    ) -> dict:
        pg_id = _new_id()
        deadline = time.monotonic() + timeout
        info = self.gcs.call(
            "create_pg",
            {"pg_id": pg_id, "bundles": bundles, "strategy": strategy, "name": name},
        )
        while info["state"] not in ("CREATED",):
            if time.monotonic() > deadline:
                raise TimeoutError(f"placement group not placed: {info['state']}")
            time.sleep(0.05)
            info = self.gcs.call("get_pg", {"pg_id": pg_id})
        # reserve the bundles on their nodes. The GCS placed against its
        # availability view, which can run ~1 heartbeat ahead of the node
        # (e.g. a just-removed PG's resources flight back) — retry briefly
        # before declaring the reservation failed.
        nodes = {n["node_id"]: tuple(n["addr"]) for n in self.gcs.call("list_nodes", None)}
        for i, b in enumerate(info["bundles"]):
            addr = nodes[b["node_id"]]
            # jittered backoff up to the remaining deadline: under load the
            # daemon's availability can trail the GCS view by several
            # heartbeats (freed resources still in flight), and the old
            # fixed 6x0.2s budget gave up inside that window
            backoff = ExponentialBackoff(base=0.1, cap=1.0)
            while True:
                r = self.pool.get(addr).call(
                    "reserve_pg_bundle",
                    {"pg_id": pg_id, "bundle_index": i, "resources": b["resources"]},
                )
                if r.get("ok") or time.monotonic() >= deadline:
                    break
                backoff.sleep()
            if not r.get("ok"):
                raise RuntimeError(
                    f"bundle {i} reservation failed on {b['node_id']}: {r}"
                )
        return info

    def remove_placement_group(self, pg_id: bytes) -> None:
        nodes = {n["node_id"]: tuple(n["addr"]) for n in self.gcs.call("list_nodes", None)}
        info = self.gcs.call("get_pg", {"pg_id": pg_id})
        if info:
            for b in info["bundles"]:
                addr = nodes.get(b["node_id"])
                if addr:
                    try:
                        self.pool.get(addr).call(
                            "release_pg_all", {"pg_id": pg_id}, timeout=5
                        )
                    except (RpcError, RemoteError):
                        pass
        self.gcs.call("remove_pg", {"pg_id": pg_id})

    # -- cluster state --------------------------------------------------------

    def nodes(self) -> list:
        return self.gcs.call("list_nodes", None)

    # -- telemetry plane ------------------------------------------------------

    def cluster_metrics(self) -> dict:
        """GCS-aggregated cluster metrics: counter sums + windowed rates,
        gauge rollups, merged histograms, per-reporter staleness."""
        return self.gcs.call("telemetry_cluster", {})

    def slo_report(self, thresholds: Optional[dict] = None) -> dict:
        """Per-model-tag green/yellow/red grades from the MERGED SLO
        histograms (the autoscaler's input)."""
        return self.gcs.call(
            "telemetry_slo",
            {"thresholds": thresholds} if thresholds else {},
        )

    def telemetry_status(self, thresholds: Optional[dict] = None) -> dict:
        """Everything `ray_tpu status` prints, in ONE GCS query."""
        return self.gcs.call(
            "telemetry_status",
            {"thresholds": thresholds} if thresholds else {},
        )

    def cluster_resources(self) -> dict:
        total: dict[str, float] = {}
        for n in self.nodes():
            if n["alive"]:
                for k, v in n["resources"].items():
                    total[k] = total.get(k, 0.0) + v
        return total
