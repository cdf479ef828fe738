"""Cluster worker process: executes tasks and hosts actors.

Reference analog: the core-worker side of task execution
(src/ray/core_worker/core_worker.h:165 — TaskReceiver, direct
worker<->worker PushTask; actor scheduling queues in
src/ray/core_worker/transport/actor_task_submitter.h:75). Redesigned:
each worker is a spawned-clean Python process running one RPC server;
normal tasks run on an executor thread; actor calls serialize through a
per-actor FIFO asyncio lock (per-connection pipelining preserves caller
order, the lock preserves execution order — the reference's
ActorSchedulingQueue role).

Serialization: the port's stdlib pickler with persistent ids
(``cluster/serialization.py``; the reference uses cloudpickle) —
ObjectRefs travel as ("objref", id) and are materialized through the
node daemon's fetch path on the executing side (the reference inlines
resolved values via the plasma provider; here the daemon is the
provider).

A copy of ``ray_tpu/cluster/worker_main.py``. The daemon starts the
worker with ``CUDA_VISIBLE_DEVICES`` set to its lease's cards ("" for a
CPU lease), so torch, imported only by the code a task runs, sees exactly
those. Of the reference's framework methods of process actors,
``__ray_tpu_dag_exec_loop__`` runs a compiled DAG's loop under the actor's
FIFO lock; ``__ray_tpu_collective_init__`` raises, naming ROADMAP.md Queue
1, item 10 (D4). The ``--gcs`` address
may name a primary and its standby; a schedule the driver exported
(``chaos.install(propagate_env=True)``) is adopted at start.
"""

from __future__ import annotations

import argparse
import asyncio
import io
import threading
import traceback
from typing import Any, Optional

import pickle

from ray_tpu_torch.cluster.rpc import RpcClient, RpcServer, parse_gcs_addr
from ray_tpu_torch.cluster.serialization import _ErrorValue, dumps_value, loads_value
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.cluster.worker")

def _framework_actor_method(actor, name: str):
    """Framework-injected actor methods of process actors (the in-process
    twin is ``core/actor_runtime.py``'s ``Actor._framework_method``): a
    compiled DAG's exec loop, which holds the actor until its channels
    close. The collective group's setup call waits for its item."""
    if name == "__ray_tpu_collective_init__":
        raise NotImplementedError(
            f"{name}: the collective groups (ROADMAP.md Queue 1, item 10, D4) are not "
            "ported yet")
    if name == "__ray_tpu_dag_exec_loop__":
        from ray_tpu_torch.dag.compiled import _actor_exec_loop

        return lambda plan, input_source: _actor_exec_loop(actor, plan, input_source)
    return None


class WorkerRuntime:
    def __init__(self, daemon_addr: tuple, worker_id: str,
                 gcs_addr: Optional[tuple] = None):
        self.worker_id = worker_id
        self.daemon_addr = tuple(daemon_addr)
        self.gcs_addr = tuple(gcs_addr) if gcs_addr else None
        self.daemon = RpcClient(*daemon_addr, timeout=120.0).connect(retries=20)
        self.node_id: Optional[str] = None
        self.shm = None  # attached after registration (daemon owns the file)
        self.actors: dict[bytes, Any] = {}
        self._actor_locks: dict[bytes, asyncio.Lock] = {}
        # registration metadata per hosted actor (name/namespace/
        # max_restarts/creation_spec...) — the data-plane ground truth a
        # reconciling GCS rebuilds its actor table from after a restart
        # with a stale or lost snapshot (rpc_actor_inventory)
        self._actor_meta: dict[bytes, dict] = {}
        self.rpc = RpcServer(self)
        # execution-side tracing: spans buffered here, flushed to the node
        # daemon in batches off the hot path (reference: per-worker
        # ProfileEvents batched to the GCS task-event pipeline,
        # core_worker/task_event_buffer.h)
        from collections import deque

        self._spans: "deque[dict]" = deque(maxlen=4096)
        self._span_flusher = threading.Thread(
            target=self._flush_spans_loop, name="span-flush", daemon=True
        )
        self._span_flusher.start()

    def _flush_spans_loop(self) -> None:
        import time as _time

        while True:
            _time.sleep(0.5)
            if not self._spans:
                continue
            batch = []
            while self._spans and len(batch) < 512:
                batch.append(self._spans.popleft())
            try:
                self.daemon.call("record_spans", {"spans": batch}, timeout=10)
            except Exception:  # noqa: BLE001 — tracing must never hurt tasks
                pass

    # -- object plumbing ------------------------------------------------------
    # Same-node objects ride the shared-memory store (plasma-equivalent):
    # reads hit the mapping directly, returns are sealed in place and only
    # the 16-byte id crosses the RPC (reference: plasma client over the
    # raylet's in-process store). RPC paths remain the fallback.

    def resolve_ref(self, object_id: bytes) -> Any:
        data = None
        if self.shm is not None:
            try:
                data = self.shm.get_bytes(object_id)
            except OSError:
                data = None
        if data is None:
            data = self.daemon.call(
                "fetch_object", {"object_id": object_id}, timeout=60
            )
        if data is None:
            raise RuntimeError(f"object {object_id.hex()} unavailable")
        value = loads_value(data, self.resolve_ref)
        if isinstance(value, _ErrorValue):
            raise RuntimeError(
                f"dependency failed: {value.task_desc}: {value.exc!r}"
            )
        return value

    SHM_MIN_BYTES = 64 << 10  # small returns: one RPC beats the shm protocol

    def put_return(self, object_id: bytes, value: Any) -> None:
        data = dumps_value(value)
        if (
            self.shm is not None
            and len(data) >= self.SHM_MIN_BYTES
            and self.shm.put_pinned(object_id, data)
        ):
            try:
                r = self.daemon.call(
                    "object_sealed", {"object_id": object_id}, timeout=60
                )
            finally:
                # drop the creator ref only after the daemon pinned it
                # (no zero-ref window for the LRU to evict through)
                try:
                    self.shm.release(object_id)
                except OSError:
                    pass
            if r.get("ok"):
                return
            try:  # daemon would not adopt: reclaim and fall back
                self.shm.force_delete(object_id)
            except OSError:
                pass
        self.daemon.call(
            "put_object",
            {"object_id": object_id, "data": data},
            timeout=60,
        )

    # -- task execution -------------------------------------------------------

    @staticmethod
    def _trace_ids(tctx) -> dict:
        """Span-dict fields for the attached trace context (empty when
        the envelope carried no trace)."""
        if tctx is None:
            return {}
        return {"trace_id": tctx.trace_id, "span_id": tctx.span_id}

    def _execute(self, payload) -> dict:
        import time as _time

        from ray_tpu_torch.obs import context as trace_context

        desc = payload.get("desc", "task")
        return_ids = payload["return_ids"]
        t0 = _time.time()
        # restore the envelope's trace so task code and nested submits on
        # this worker stay in the caller's trace
        with trace_context.use_from(payload.get("trace")) as tctx:
            trace_ids = self._trace_ids(tctx)
            try:
                func = pickle.loads(payload["func"])
                args, kwargs = loads_value(payload["args"], self.resolve_ref)
                result = func(*args, **kwargs)
                self._store_returns(return_ids, result, payload.get("num_returns", 1))
                self._spans.append({
                    "desc": desc, "task_id": payload.get("task_id", b"").hex(),
                    "worker_id": self.worker_id, "start": t0, "end": _time.time(),
                    "ok": True, **trace_ids,
                })
                return {"ok": True}
            except BaseException as e:  # noqa: BLE001
                tb = traceback.format_exc()
                err = _ErrorValue(e, tb, desc)
                for rid in return_ids:
                    try:
                        self.put_return(rid, err)
                    except Exception:
                        pass
                self._spans.append({
                    "desc": desc, "task_id": payload.get("task_id", b"").hex(),
                    "worker_id": self.worker_id, "start": t0, "end": _time.time(),
                    "ok": False, **trace_ids,
                })
                return {"ok": False, "error": repr(e), "tb": tb,
                        "retryable": not isinstance(e, (SystemExit,))}

    def _store_returns(self, return_ids, result, num_returns: int) -> None:
        if num_returns == 1:
            self.put_return(return_ids[0], result)
            return
        if not isinstance(result, (tuple, list)) or len(result) != num_returns:
            raise ValueError(
                f"task declared num_returns={num_returns} but returned "
                f"{type(result).__name__}"
            )
        for rid, val in zip(return_ids, result):
            self.put_return(rid, val)

    async def rpc_push_task(self, payload, peer):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self._execute, payload)

    # -- actors ---------------------------------------------------------------

    async def rpc_create_actor(self, payload, peer):
        loop = asyncio.get_running_loop()

        def _create():
            try:
                cls, args, kwargs = loads_value(
                    payload["creation_spec"], self.resolve_ref
                )
                self.actors[payload["actor_id"]] = cls(*args, **kwargs)
                meta = dict(payload.get("meta") or {})
                meta["creation_spec"] = payload["creation_spec"]
                self._actor_meta[payload["actor_id"]] = meta
                return {"ok": True}
            except BaseException as e:  # noqa: BLE001
                return {"ok": False, "error": repr(e), "tb": traceback.format_exc()}

        self._actor_locks.setdefault(payload["actor_id"], asyncio.Lock())
        return await loop.run_in_executor(None, _create)

    async def rpc_actor_call(self, payload, peer):
        actor_id = payload["actor_id"]
        actor = self.actors.get(actor_id)
        if actor is None:
            return {"ok": False, "error": f"actor {actor_id.hex()} not here",
                    "actor_missing": True}
        lock = self._actor_locks.setdefault(actor_id, asyncio.Lock())
        loop = asyncio.get_running_loop()

        def _invoke():
            method = _framework_actor_method(actor, payload["method"]) or getattr(
                actor, payload["method"]
            )
            args, kwargs = loads_value(payload["args"], self.resolve_ref)
            result = method(*args, **kwargs)
            if asyncio.iscoroutine(result):
                result = asyncio.run(result)
            return result

        desc = f"{type(actor).__name__}.{payload['method']}"
        import time as _time

        from ray_tpu_torch.obs import context as trace_context

        t0 = _time.time()
        with trace_context.use_from(payload.get("trace")) as tctx:
            trace_ids = self._trace_ids(tctx)
            try:
                # only METHOD EXECUTION needs the FIFO lock (per-caller
                # order); storing the result is an independent RPC to the
                # daemon and serializing it under the lock would cap the
                # actor's call rate at the store round-trip
                import contextvars as _cv

                # run_in_executor does not propagate contextvars: ship the
                # coroutine's context (with the attached trace) to the pool
                call_ctx = _cv.copy_context()
                async with lock:
                    result = await loop.run_in_executor(None, call_ctx.run, _invoke)
                await loop.run_in_executor(
                    None,
                    self._store_returns,
                    payload["return_ids"], result, payload.get("num_returns", 1),
                )
                # span only after the returns landed: a store failure takes
                # the except path and must record ONE ok=False span, not both
                self._spans.append({
                    "desc": desc, "worker_id": self.worker_id,
                    "actor_id": actor_id.hex(), "start": t0, "end": _time.time(),
                    "ok": True, **trace_ids,
                })
                return {"ok": True}
            except BaseException as e:  # noqa: BLE001
                tb = traceback.format_exc()
                err = _ErrorValue(e, tb, desc)
                for rid in payload["return_ids"]:
                    try:
                        self.put_return(rid, err)
                    except Exception:
                        pass
                self._spans.append({
                    "desc": desc, "worker_id": self.worker_id,
                    "actor_id": actor_id.hex(), "start": t0, "end": _time.time(),
                    "ok": False, **trace_ids,
                })
                return {"ok": False, "error": repr(e), "tb": tb}

    async def rpc_destroy_actor(self, payload, peer):
        self.actors.pop(payload["actor_id"], None)
        self._actor_locks.pop(payload["actor_id"], None)
        self._actor_meta.pop(payload["actor_id"], None)
        return {"ok": True}

    def rpc_actor_inventory(self, payload, peer):
        """Live actors hosted here, with their registration metadata —
        the node daemon forwards this in its reconcile report when a
        restarted GCS asks it to re-register."""
        out = []
        for aid in list(self.actors):
            meta = self._actor_meta.get(aid, {})
            out.append({"actor_id": aid, **meta})
        return out

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        addr = self.rpc.start()
        # install the ambient ClusterClient BEFORE registering: the moment
        # the daemon processes register_worker it may grant a lease and a
        # submitter may push a task carrying ObjectRefs/actor handles —
        # their rebuild path needs the ambient client already in place
        if self.gcs_addr is not None:
            from ray_tpu_torch.cluster.client import ClusterClient
            from ray_tpu_torch.core import api
            from ray_tpu_torch.core.cluster_backend import ClusterBackend

            client = ClusterClient(self.gcs_addr, self.daemon_addr)
            client.auto_free = False  # workers borrow; drivers own/free
            # nested api calls (tasks submitting tasks, actors creating
            # actors) ride the same cluster, not a private in-process
            # runtime (reference: workers share the driver's GCS plane)
            api._CLUSTER[0] = ClusterBackend.from_client(client)
        r = self.daemon.call(
            "register_worker", {"worker_id": self.worker_id, "addr": addr}
        )
        self.node_id = r.get("node_id")
        if r.get("shm_path"):
            try:
                from ray_tpu_torch.native.shm import ShmObjectStore

                self.shm = ShmObjectStore.open(r["shm_path"])
            except Exception:
                logger.warning("shm store unavailable; using RPC object path")
        if self.gcs_addr is None and r.get("gcs_addr") and r.get("daemon_addr"):
            # legacy fallback (daemon didn't pass --gcs): install late
            from ray_tpu_torch.cluster.client import ClusterClient

            ClusterClient(tuple(r["gcs_addr"]), tuple(r["daemon_addr"]))
        logger.info("worker %s serving at %s (node %s)",
                    self.worker_id, addr, self.node_id)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--daemon", required=True)
    p.add_argument("--worker-id", required=True)
    p.add_argument("--gcs", default=None)
    args = p.parse_args()
    from ray_tpu_torch.chaos import harness as _chaos

    _chaos.install_from_env()  # adopt a schedule the driver exported
    host, port = args.daemon.rsplit(":", 1)
    gcs = None
    if args.gcs:
        gcs = parse_gcs_addr(args.gcs)  # "h:p" or a primary and its standby "h1:p1,h2:p2"
    rt = WorkerRuntime((host, int(port)), args.worker_id, gcs_addr=gcs)
    rt.start()
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
