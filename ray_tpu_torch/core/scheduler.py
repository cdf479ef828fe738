"""Local task scheduling: dependency resolution + resource-gated dispatch
(counterpart of ``ray_tpu/core/scheduler.py``).

Upstream Ray's raylet ClusterTaskManager/LocalTaskManager pair
(src/ray/raylet/scheduling/cluster_task_manager.h, local_task_manager.cc:94
ScheduleAndDispatchTasks) collapsed for one node, with one deliberate
inversion: the reference leases *worker processes* because CPU Python
needs process isolation; a GPU host wants one process to own the card, so
the default execution vehicle is a thread of that process (arguments by
reference, one CUDA context). Process workers remain available
(``worker_mode="process"``, ``core/process_pool.py``) for CPU-heavy Python
tasks, for crash isolation (retries on worker death) and for GPU work in a
worker that owns its card: a task that holds ``"GPU"`` is granted cards
(``CardGrants``, recorded on the spec as ``gpu_ids``) and runs in a worker
pinned to them. Actors stay threads, as in the reference.
"""

from __future__ import annotations

import math
import threading
import traceback
from collections import deque
from typing import TYPE_CHECKING, Optional

from ray_tpu_torch.core import errors
from ray_tpu_torch.core.ref import ObjectRef
from ray_tpu_torch.core.resources import NodeResources, ResourceSet
from ray_tpu_torch.core.task import TaskSpec
from ray_tpu_torch.utils.ids import ObjectID
from ray_tpu_torch.utils.logging import get_logger

if TYPE_CHECKING:
    from ray_tpu_torch.core.runtime import Runtime

logger = get_logger("ray_tpu_torch.scheduler")


def resolve_pool(
    runtime: "Runtime", options, default_pool: Optional[NodeResources] = None
) -> tuple[NodeResources, ResourceSet]:
    """Resolve the resource pool a task/actor draws from: its placement-group
    bundle if one is attached (directly or via scheduling strategy), else the
    node pool. Single source of truth for tasks AND actor creation."""
    req = options.resource_set()
    pg = options.placement_group
    strategy = options.scheduling_strategy
    if strategy is not None and hasattr(strategy, "placement_group"):
        pg = strategy.placement_group
        idx = strategy.placement_group_bundle_index
    else:
        idx = options.placement_group_bundle_index
    if strategy is not None and hasattr(strategy, "node_id") and pg is None:
        # NodeAffinity against the single-node runtime: the only node is
        # runtime.node_id — a hard affinity to any other node must FAIL
        # the task, not silently run it here (reference semantics:
        # unschedulable hard affinity raises, scheduling_strategies.py)
        nid = strategy.node_id
        local = runtime.node_id
        matches = (
            nid == local
            or (isinstance(nid, str) and nid == local.hex())
            or (isinstance(nid, bytes) and nid == local.binary())
        )
        if nid is not None and not matches and not getattr(strategy, "soft", False):
            raise errors.RayTpuError(
                f"NodeAffinitySchedulingStrategy(node_id={nid!r}, soft=False): "
                f"no such node in this runtime (local node {runtime.node_id})"
            )
    if pg is not None:
        return pg.bundle_pool(idx, req), req
    return default_pool if default_pool is not None else runtime.node_resources, req


class CardGrants:
    """Which of the runtime's cards a process-mode task holds: whole cards
    (the lowest free indices) for ``num_gpus >= 1``, a share of one card
    (the lowest index with room) below 1. The ``"GPU"`` resource already
    gates the total; this picks the cards, so a worker can be pinned."""

    def __init__(self, num_cards: int):
        self._lock = threading.Lock()
        self._free = [1.0] * num_cards  # per card, the share not granted

    def acquire(self, amount: float) -> Optional[tuple]:
        """The cards granted for ``amount``, or None if no card has room."""
        with self._lock:
            if amount >= 1:
                whole = [i for i, f in enumerate(self._free) if f >= 1.0 - 1e-9]
                need = math.ceil(amount - 1e-9)
                if len(whole) < need:
                    return None
                for i in whole[:need]:
                    self._free[i] = 0.0
                return tuple(whole[:need])
            for i, f in enumerate(self._free):
                if f >= amount - 1e-9:
                    self._free[i] = f - amount
                    return (i,)
            return None

    def release(self, ids: tuple, amount: float) -> None:
        with self._lock:
            share = 1.0 if amount >= 1 else amount
            for i in ids:
                self._free[i] = min(1.0, self._free[i] + share)


class LocalScheduler:
    """FIFO-with-skipping dispatch over a resource pool (the hybrid policy's
    local leg)."""

    def __init__(self, runtime: "Runtime", node_resources: NodeResources):
        self._runtime = runtime
        self._node = node_resources
        self._queue: deque[TaskSpec] = deque()
        self._cv = threading.Condition()
        self._shutdown = False
        self._running: dict = {}  # task_id -> spec
        total_gpus = node_resources.total.get("GPU", 0)
        self._cards = CardGrants(math.ceil(total_gpus) if total_gpus > 0 else 0)
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, name="ray_tpu_torch-dispatch", daemon=True
        )
        self._dispatch_thread.start()

    # -- submission ----------------------------------------------------------

    def submit(self, spec: TaskSpec) -> None:
        deps = self._collect_deps(spec)
        if not deps:
            self._enqueue(spec)
            return
        remaining = {"n": len(deps)}
        lock = threading.Lock()

        def _dep_ready(_obj_id: ObjectID) -> None:
            with lock:
                remaining["n"] -= 1
                if remaining["n"] != 0:
                    return
            self._enqueue(spec)

        for dep in deps:
            self._runtime.object_store.wait_async(dep, _dep_ready)

    def _collect_deps(self, spec: TaskSpec) -> list[ObjectID]:
        deps = []
        for a in list(spec.args) + list(spec.kwargs.values()):
            if isinstance(a, ObjectRef):
                deps.append(a.id)
        return deps

    def _enqueue(self, spec: TaskSpec) -> None:
        with self._cv:
            self._queue.append(spec)
            self._cv.notify_all()

    # -- dispatch ------------------------------------------------------------

    def _pool_for(self, spec: TaskSpec) -> tuple[NodeResources, ResourceSet]:
        return resolve_pool(self._runtime, spec.options, default_pool=self._node)

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._shutdown:
                    self._cv.wait(timeout=0.2)
                if self._shutdown:
                    return
                # scan for the first task whose resources fit (skip blocked
                # heads: small tasks shouldn't starve behind a big one)
                picked: Optional[TaskSpec] = None
                pool = req = None
                for i, spec in enumerate(self._queue):
                    try:
                        pool, req = self._pool_for(spec)
                    except errors.RayTpuError as e:
                        del self._queue[i]
                        self._fail_task(spec, e)
                        self._runtime.on_task_finished(spec)
                        picked = None
                        break
                    if pool.try_acquire(req):
                        if not self._grant_cards(spec, req):
                            pool.release(req)  # the GPU total fits, no one card does
                            continue
                        picked = spec
                        del self._queue[i]
                        break
                if picked is None:
                    # nothing fits right now; wait for a release/notify
                    self._cv.wait(timeout=0.05)
                    continue
            self._launch(picked, pool, req)

    def _in_process(self, spec: TaskSpec) -> bool:
        return self._runtime.worker_mode == "process" and spec.actor_id is None

    def _grant_cards(self, spec: TaskSpec, req: ResourceSet) -> bool:
        """Process mode: grant the cards a task's worker is pinned to."""
        amount = req.get("GPU", 0)
        if not self._in_process(spec) or amount <= 0:
            return True
        spec.gpu_ids = self._cards.acquire(amount)
        return spec.gpu_ids is not None

    def notify(self) -> None:
        with self._cv:
            self._cv.notify_all()

    def _launch(self, spec: TaskSpec, pool: NodeResources, req: ResourceSet) -> None:
        self._running[spec.task_id] = spec

        def _run():
            try:
                execute_task(self._runtime, spec)
            finally:
                self._running.pop(spec.task_id, None)
                pool.release(req)
                self.notify()

        if self._in_process(spec):
            t = threading.Thread(target=self._run_in_process, args=(spec, pool, req),
                                 name=f"ray_tpu_torch-proxy-{spec.describe()}", daemon=True)
        else:
            t = threading.Thread(target=_run, name=f"ray_tpu_torch-{spec.describe()}",
                                 daemon=True)
        t.start()

    # -- process-mode execution (crash isolation + retries) -----------------

    def _run_in_process(self, spec: TaskSpec, pool: NodeResources, req: ResourceSet) -> None:
        from ray_tpu_torch.obs import context as trace_context

        with trace_context.use_from(spec.trace):
            return self._run_in_process_body(spec, pool, req)

    def _run_in_process_body(self, spec: TaskSpec, pool: NodeResources,
                             req: ResourceSet) -> None:
        from ray_tpu_torch.core.events import TaskState

        runtime = self._runtime
        finished = True
        # this attempt's cards: a retry is granted its own at its dispatch
        gpu_ids = spec.gpu_ids
        runtime.task_events.record(spec.task_id, spec.describe(), TaskState.RUNNING)
        try:
            try:
                result = runtime.process_pool.run(spec)
            except errors.WorkerCrashedError as e:
                if spec.attempt < spec.options.max_retries:
                    spec.attempt += 1
                    logger.warning(
                        "%s: worker crashed, retry %d/%d",
                        spec.describe(), spec.attempt, spec.options.max_retries,
                    )
                    finished = False
                    self._enqueue(spec)
                    return
                self._fail_task(spec, e)
                return
            except errors.TaskError as e:
                if spec.options.retry_exceptions and spec.attempt < spec.options.max_retries:
                    spec.attempt += 1
                    finished = False
                    self._enqueue(spec)
                    return
                self._fail_task(spec, e)
                return
            except BaseException as e:  # noqa: BLE001 — stored on the returns
                self._fail_task(
                    spec,
                    errors.TaskError(e, traceback.format_exc(), spec.describe()),
                )
                return
            _store_results(runtime, spec, result)
            runtime.task_events.record(
                spec.task_id, spec.describe(), TaskState.FINISHED
            )
        finally:
            self._running.pop(spec.task_id, None)
            if gpu_ids is not None:
                self._cards.release(gpu_ids, req.get("GPU", 0))
            pool.release(req)
            self.notify()
            if finished:
                runtime.on_task_finished(spec)

    def _fail_task(self, spec: TaskSpec, err: BaseException) -> None:
        """Store the error on all returns (caller handles on_task_finished)."""
        from ray_tpu_torch.core.events import TaskState

        self._runtime.task_events.record(
            spec.task_id, spec.describe(), TaskState.FAILED, error=repr(err)
        )
        for rid in spec.return_ids:
            self._runtime.object_store.put_error(rid, err)
        gen = self._runtime.streaming_generators.pop(spec.task_id, None)
        if gen is not None:
            # surface the failure to the consumer as an error-carrying ref
            # (a bare _finish() would look like a clean empty stream)
            gen._append(ObjectRef(spec.return_ids[0], self._runtime, spec.describe()))
            gen._finish()

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._queue)

    def shutdown(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()


# ---------------------------------------------------------------------------
# In-thread task execution.
# ---------------------------------------------------------------------------


def resolve_args(runtime: "Runtime", args: tuple, kwargs: dict) -> tuple[tuple, dict]:
    def res(a):
        if isinstance(a, ObjectRef):
            return runtime.object_store.get(a.id)
        return a

    return tuple(res(a) for a in args), {k: res(v) for k, v in kwargs.items()}


def execute_task(runtime: "Runtime", spec: TaskSpec) -> None:
    """Run a task inline on the current thread and store its results.

    Runs under the submitter's trace context (when the spec carries
    one): task events carry the caller's trace/span ids, nested submits
    chain further."""
    from ray_tpu_torch.obs import context as trace_context

    with trace_context.use_from(spec.trace):
        return _execute_task_body(runtime, spec)


def _execute_task_body(runtime: "Runtime", spec: TaskSpec) -> None:
    from ray_tpu_torch.core.events import TaskState

    runtime.task_events.record(spec.task_id, spec.describe(), TaskState.RUNNING)
    try:
        args, kwargs = resolve_args(runtime, spec.args, spec.kwargs)
        if spec.streaming:
            _execute_streaming(runtime, spec, args, kwargs)  # records terminal
            return
        result = spec.func(*args, **kwargs)
    except errors.RayTpuError as e:
        # dependency failed or task-level framework error: propagate as-is
        for rid in spec.return_ids:
            runtime.object_store.put_error(rid, e)
        runtime.on_task_finished(spec)
        runtime.task_events.record(
            spec.task_id, spec.describe(), TaskState.FAILED, error=str(e)
        )
        return
    except BaseException as e:  # noqa: BLE001 - user exception
        if spec.options.retry_exceptions and spec.attempt < spec.options.max_retries:
            spec.attempt += 1
            runtime.scheduler.submit(spec)
            return
        err = errors.TaskError(e, traceback.format_exc(), spec.describe())
        for rid in spec.return_ids:
            runtime.object_store.put_error(rid, err)
        runtime.on_task_finished(spec)
        runtime.task_events.record(
            spec.task_id, spec.describe(), TaskState.FAILED, error=repr(e)
        )
        return
    _store_results(runtime, spec, result)
    runtime.task_events.record(spec.task_id, spec.describe(), TaskState.FINISHED)
    runtime.on_task_finished(spec)


def _execute_streaming(
    runtime: "Runtime", spec: TaskSpec, args, kwargs, fn=None
) -> None:
    """Drive a generator task, publishing each yield as an object. `fn`
    overrides spec.func (actor methods pass the bound method)."""
    from ray_tpu_torch.core.events import TaskState

    gen = runtime.streaming_generators.get(spec.task_id)
    failure: Optional[str] = None
    try:
        it = (fn or spec.func)(*args, **kwargs)
        for i, item in enumerate(it):
            obj_id = ObjectID.for_task_return(spec.task_id, i + 1)
            runtime.object_store.put(obj_id, item)
            if gen is not None:
                gen._append(ObjectRef(obj_id, runtime, spec.describe()))
    except BaseException as e:  # noqa: BLE001
        failure = repr(e)
        err = errors.TaskError(e, traceback.format_exc(), spec.describe())
        if gen is not None:
            obj_id = ObjectID.for_task_return(spec.task_id, 0)
            runtime.object_store.put_error(obj_id, err)
            gen._append(ObjectRef(obj_id, runtime, spec.describe()))
    finally:
        if gen is not None:
            gen._finish()
        runtime.streaming_generators.pop(spec.task_id, None)
        runtime.on_task_finished(spec)
        runtime.task_events.record(
            spec.task_id, spec.describe(),
            TaskState.FAILED if failure else TaskState.FINISHED,
            kind="actor_task" if spec.actor_id is not None else "task",
            actor_id=spec.actor_id, error=failure,
        )


def _store_results(runtime: "Runtime", spec: TaskSpec, result) -> None:
    n = spec.options.num_returns
    if n == 1:
        runtime.object_store.put(spec.return_ids[0], result)
    else:
        if not isinstance(result, (tuple, list)) or len(result) != n:
            err = errors.TaskError(
                ValueError(
                    f"task declared num_returns={n} but returned "
                    f"{type(result).__name__} of length "
                    f"{len(result) if isinstance(result, (tuple, list)) else 'n/a'}"
                ),
                "",
                spec.describe(),
            )
            for rid in spec.return_ids:
                runtime.object_store.put_error(rid, err)
            return
        for rid, val in zip(spec.return_ids, result):
            runtime.object_store.put(rid, val)
