"""Per-process runtime: the CoreWorker equivalent (counterpart of
``ray_tpu/core/runtime.py``).

Upstream Ray's CoreWorker (src/ray/core_worker/core_worker.h:165, "root
class of the worker process, language-independent functionalities"): owns
the object store, task submission, ownership/ref-counting and the
scheduler. One node, in process. The accelerator resource is ``"GPU"``:
``Runtime(num_gpus=)``, detected by ``_detect_gpus`` when not given.
``worker_mode="process"`` runs tasks in worker processes
(``core/process_pool.py``, built at the first such task), each pinned to
the cards its task was granted. Remote nodes are the cluster runtime's
(``ray_tpu_torch.cluster``), which ``init(address=...)`` attaches to in
place of this runtime.
"""

from __future__ import annotations

import atexit
import os
import threading
import time
from typing import Any, Optional

from ray_tpu_torch.core import errors
from ray_tpu_torch.core.gcs import Gcs, NodeInfo
from ray_tpu_torch.core.object_store import ObjectStore
from ray_tpu_torch.core.ref import ObjectRef, ObjectRefGenerator
from ray_tpu_torch.core.resources import NodeResources, ResourceSet
from ray_tpu_torch.core.scheduler import LocalScheduler
from ray_tpu_torch.core.task import TaskOptions, TaskSpec
from ray_tpu_torch.utils import config
from ray_tpu_torch.utils.ids import NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.runtime")

_runtime_lock = threading.Lock()
_runtime: Optional["Runtime"] = None


class Runtime:
    def __init__(
        self,
        num_cpus: Optional[float] = None,
        num_gpus: Optional[float] = None,
        resources: Optional[dict] = None,
        worker_mode: Optional[str] = None,
        namespace: str = "default",
    ):
        if num_cpus is None:
            # RAY_TPU_NUM_CPUS overrides the physical core count: local
            # actors are THREADS, so the CPU resource is a logical
            # concurrency budget — a 1-core CI box must still run a
            # world_size=2 gang (tests/conftest.py sets a floor of 8)
            env_cpus = os.environ.get("RAY_TPU_NUM_CPUS")
            num_cpus = float(env_cpus) if env_cpus else float(os.cpu_count() or 1)
        if num_gpus is None:
            num_gpus = _detect_gpus()
        total = dict(resources or {})
        total["CPU"] = num_cpus
        if num_gpus:
            total["GPU"] = num_gpus
        total.setdefault("memory", 8 * 1024**3)

        self.namespace = namespace
        self.worker_mode = worker_mode or config.get("worker_mode")
        self.node_id = NodeID.from_random()
        self.worker_id = WorkerID.from_random()
        self.object_store = ObjectStore()
        self.gcs = Gcs()
        self.node_resources = NodeResources(ResourceSet(total))
        self.gcs.register_node(NodeInfo(self.node_id, self.node_resources))
        from ray_tpu_torch.core.events import TaskEventBuffer

        self.scheduler = LocalScheduler(self, self.node_resources)
        self.task_events = TaskEventBuffer()
        self.streaming_generators: dict[TaskID, ObjectRefGenerator] = {}
        self._put_counter = 0
        self._task_counter = 0
        self._lock = threading.Lock()
        self._pending_tasks: set[TaskID] = set()
        self._process_pool = None
        # its own lock: the first process task builds the store (g++) under it
        self._pool_lock = threading.Lock()

    # -- lazily built process pool ------------------------------------------

    @property
    def process_pool(self):
        with self._pool_lock:
            if self._process_pool is None:
                from ray_tpu_torch.core.process_pool import ProcessPool

                self._process_pool = ProcessPool()
            return self._process_pool

    # -- object API ----------------------------------------------------------

    def put(self, value: Any) -> ObjectRef:
        with self._lock:
            self._put_counter += 1
            idx = self._put_counter
        obj_id = ObjectID.for_put(TaskID(self.worker_id.binary()), idx)
        self.object_store.put(obj_id, value)
        return ObjectRef(obj_id, self, "put")

    def get(self, refs: list[ObjectRef], timeout: Optional[float] = None) -> list[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for ref in refs:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            try:
                out.append(self.object_store.get(ref.id, remaining))
            except errors.GetTimeoutError:
                raise errors.GetTimeoutError(
                    f"get() timed out after {timeout}s waiting for {ref}"
                ) from None
        return out

    def wait(
        self,
        refs: list[ObjectRef],
        num_returns: int = 1,
        timeout: Optional[float] = None,
    ) -> tuple[list[ObjectRef], list[ObjectRef]]:
        if num_returns > len(refs):
            raise ValueError("num_returns exceeds number of refs")
        if len({r.id for r in refs}) != len(refs):
            raise ValueError("wait() got duplicate ObjectRefs")
        cv = threading.Condition()
        ready_ids: set[ObjectID] = set()

        def on_ready(obj_id: ObjectID) -> None:
            with cv:
                ready_ids.add(obj_id)
                cv.notify_all()

        for ref in refs:
            self.object_store.wait_async(ref.id, on_ready)
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            with cv:
                while len(ready_ids) < num_returns:
                    remaining = None if deadline is None else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        break
                    cv.wait(remaining if remaining is not None else 0.5)
                # at most num_returns in the ready list (reference ray.wait
                # contract, python/ray/_private/worker.py:2878)
                ready = [r for r in refs if r.id in ready_ids][:num_returns]
                ready_set = {r.id for r in ready}
                not_ready = [r for r in refs if r.id not in ready_set]
            return ready, not_ready
        finally:
            # deregister unfired callbacks (polling wait() must not leak)
            for ref in refs:
                self.object_store.cancel_wait(ref.id, on_ready)

    # -- task submission -----------------------------------------------------

    def submit_task(
        self,
        func,
        args: tuple,
        kwargs: dict,
        options: TaskOptions,
    ) -> list[ObjectRef] | ObjectRefGenerator:
        task_id = TaskID.from_random()
        streaming = options.num_returns == "streaming"
        n = 1 if streaming else int(options.num_returns)
        from ray_tpu_torch.obs import context as trace_context

        ctx = trace_context.current()
        spec = TaskSpec(
            task_id=task_id,
            func=func,
            args=args,
            kwargs=kwargs,
            options=options,
            return_ids=[ObjectID.for_task_return(task_id, i) for i in range(n)],
            streaming=streaming,
            trace=ctx.to_dict() if ctx is not None else None,
        )
        self._retain_arg_refs(spec)
        with self._lock:
            self._pending_tasks.add(task_id)
        from ray_tpu_torch.core.events import TaskState

        self.task_events.record(
            task_id, spec.describe(), TaskState.SUBMITTED
        )
        if streaming:
            gen = ObjectRefGenerator(self, spec.describe())
            self.streaming_generators[task_id] = gen
            self.scheduler.submit(spec)
            return gen
        refs = [ObjectRef(rid, self, spec.describe()) for rid in spec.return_ids]
        self.scheduler.submit(spec)
        return refs

    def _retain_arg_refs(self, spec: TaskSpec) -> None:
        # Hold arg objects alive while the task is in flight (the reference
        # tracks this as task dependencies in ReferenceCounter).
        for a in list(spec.args) + list(spec.kwargs.values()):
            if isinstance(a, ObjectRef):
                self.object_store.add_ref(a.id)

    def on_task_finished(self, spec: TaskSpec) -> None:
        for a in list(spec.args) + list(spec.kwargs.values()):
            if isinstance(a, ObjectRef):
                self.object_store.remove_ref(a.id)
        with self._lock:
            self._pending_tasks.discard(spec.task_id)

    def pending_task_count(self) -> int:
        with self._lock:
            return len(self._pending_tasks)

    # -- ref counting hooks --------------------------------------------------

    def on_ref_serialized(self, obj_id: ObjectID) -> None:
        self.object_store.add_ref(obj_id)

    def on_ref_deleted(self, obj_id: ObjectID) -> None:
        self.object_store.remove_ref(obj_id)

    # -- shutdown ------------------------------------------------------------

    def shutdown(self) -> None:
        self.scheduler.shutdown()
        with self._pool_lock:
            pool, self._process_pool = self._process_pool, None
        if pool is not None:
            pool.shutdown()


def _detect_gpus() -> float:
    """The NVIDIA cards this process may use: the entries of
    ``CUDA_VISIBLE_DEVICES`` when it is set (an empty value or a negative
    index hides the rest, as CUDA reads it), else
    ``torch.cuda.device_count()`` (0 without a card or a CUDA build)."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        n = 0
        for tok in env.split(","):
            tok = tok.strip()
            if not tok or tok.startswith("-"):
                break
            n += 1
        return float(n)
    try:
        import torch
    except ImportError:
        return 0.0
    return float(torch.cuda.device_count())


def _shutdown_at_exit() -> None:
    # every holder of _runtime_lock only reads or swaps the global (no wait
    # under it), so taking it here at interpreter exit cannot hang
    with _runtime_lock:
        rt = _runtime
    if rt is not None:
        rt.shutdown()


def get_runtime() -> Runtime:
    global _runtime
    with _runtime_lock:
        if _runtime is None:
            _runtime = Runtime()
            atexit.register(_shutdown_at_exit)
        return _runtime


def init_runtime(**kwargs) -> Runtime:
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            raise RuntimeError("ray_tpu_torch already initialized; call shutdown() first")
        _runtime = Runtime(**kwargs)
        return _runtime


def shutdown_runtime() -> None:
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            _runtime.shutdown()
            _runtime = None


def is_initialized() -> bool:
    with _runtime_lock:
        return _runtime is not None
