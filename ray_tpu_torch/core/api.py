"""Public core API: init/remote/get/put/wait + actors + placement groups
(counterpart of ``ray_tpu/core/api.py``).

Upstream Ray's public surface (python/ray/_private/worker.py:1285 init,
:143-387 remote, :2645 get, :2813 put, :2878 wait; python/ray/actor.py
ActorClass/ActorHandle; python/ray/util/placement_group.py), so a user of
either maps a program 1:1. Tasks and actors are threads of the process
that owns the card, and objects pass by reference (core/scheduler.py,
core/object_store.py); under ``init(worker_mode="process")`` tasks run in
crash-isolated worker processes instead (actors stay threads), their
arguments and results by value (core/process_pool.py). The accelerator
resource is ``num_gpus`` -> ``"GPU"``; in process mode a task that holds
it runs in a worker pinned to its cards.

``init(address="host:port")`` (or ``"ray://host:port"``, or a primary GCS
and its standby, ``"h1:p1,h2:p2"``) attaches this driver to a running GCS
(``ray_tpu_torch.cluster``) instead: tasks and
actors then run in worker processes leased from node daemons, objects live
in the nodes' shared-memory stores, and every call below goes through the
cluster backend (``core/cluster_backend.py``), as in the reference.
``.bind`` on remote functions and actor methods builds the DAG nodes of
``ray_tpu_torch.dag`` (``experimental_compile`` lowers actor-method
graphs to compiled DAGs).
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Optional, Sequence, Union

from ray_tpu_torch.core import errors, runtime as rt
from ray_tpu_torch.core.actor_runtime import Actor, ActorState
from ray_tpu_torch.core.placement import PlacementGroup, create_placement_group
from ray_tpu_torch.core.ref import ObjectRef, ObjectRefGenerator
from ray_tpu_torch.core.task import ActorOptions, TaskOptions
from ray_tpu_torch.utils.ids import ActorID, ObjectID, TaskID

# Re-exported error types
from ray_tpu_torch.core.errors import (  # noqa: F401
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)

__all__ = [
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "put",
    "wait",
    "kill",
    "get_actor",
    "method",
    "cluster_resources",
    "available_resources",
    "nodes",
    "placement_group",
    "remove_placement_group",
    "PlacementGroupSchedulingStrategy",
    "NodeAffinitySchedulingStrategy",
    "ObjectRef",
    "ObjectRefGenerator",
    "TaskError",
    "ActorDiedError",
    "GetTimeoutError",
]


# ---------------------------------------------------------------------------
# init / shutdown
# ---------------------------------------------------------------------------


_RUNTIME_ENV = ("runtime_env needs process-isolated workers: attach to a cluster first "
                "(ray_tpu_torch.init(address=...))")

# The cluster backend, when init(address=...) attached this driver to a
# GCS/node-daemon plane. One runtime per process: either in-process
# (threads of the process that owns the card) or cluster (leases + worker
# processes), the same split as the reference's local vs address= init
# (python/ray/_private/worker.py:1285).
_CLUSTER: list = [None]


def init(
    *,
    address: Optional[str] = None,
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[dict] = None,
    worker_mode: Optional[str] = None,
    namespace: str = "default",
    ignore_reinit_error: bool = False,
):
    """Start the per-process runtime, or attach to a running cluster.

    With no ``address``, boots the in-process runtime. ``num_gpus``
    defaults to the cards this process sees (``runtime._detect_gpus``).
    ``worker_mode``: "thread" (the default, flag ``worker_mode``) or
    "process" (tasks in worker processes, ``core/process_pool.py``).

    With ``address="host:port"`` (a GCS address; ``"ray://host:port"`` is
    an alias; ``"h1:p1,h2:p2"`` names a primary and its standby, and calls
    follow the primary across a failover), attaches this driver to that
    cluster: tasks and actors become leases on node daemons, run in worker
    processes cluster-wide.
    """
    if address is not None:
        if address.startswith("ray://"):
            address = address[len("ray://"):]
        if _CLUSTER[0] is not None:
            if ignore_reinit_error:
                return _CLUSTER[0]
            raise RuntimeError(
                "ray_tpu_torch.init(address=...) called twice; pass ignore_reinit_error=True"
            )
        from ray_tpu_torch.core.cluster_backend import ClusterBackend

        _CLUSTER[0] = ClusterBackend(address, namespace=namespace)
        return _CLUSTER[0]
    if rt.is_initialized():
        if ignore_reinit_error:
            return rt.get_runtime()
        raise RuntimeError("ray_tpu_torch.init() called twice; pass ignore_reinit_error=True")
    return rt.init_runtime(
        num_cpus=num_cpus,
        num_gpus=num_gpus,
        resources=resources,
        worker_mode=worker_mode,
        namespace=namespace,
    )


def shutdown() -> None:
    if _CLUSTER[0] is not None:
        _CLUSTER[0].close()
        _CLUSTER[0] = None
    rt.shutdown_runtime()


def is_initialized() -> bool:
    return _CLUSTER[0] is not None or rt.is_initialized()


def _auto_init() -> rt.Runtime:
    return rt.get_runtime()


def _cluster():
    """The attached ClusterBackend, or None (in-process mode)."""
    return _CLUSTER[0]


# ---------------------------------------------------------------------------
# scheduling strategies (reference: python/ray/util/scheduling_strategies.py)
# ---------------------------------------------------------------------------


class PlacementGroupSchedulingStrategy:
    def __init__(
        self,
        placement_group: PlacementGroup,
        placement_group_bundle_index: int = -1,
        placement_group_capture_child_tasks: bool = False,
    ):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = placement_group_capture_child_tasks


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id, soft: bool = False):
        self.node_id = node_id
        self.soft = soft


# ---------------------------------------------------------------------------
# remote functions
# ---------------------------------------------------------------------------

_TASK_OPTION_NAMES = {f.name for f in __import__("dataclasses").fields(TaskOptions)}
_ACTOR_OPTION_NAMES = {f.name for f in __import__("dataclasses").fields(ActorOptions)}


def _split_task_options(opts: dict) -> TaskOptions:
    unknown = set(opts) - _TASK_OPTION_NAMES
    if unknown:
        raise TypeError(f"unknown task options: {sorted(unknown)}")
    opts = {k: v for k, v in opts.items() if k in _TASK_OPTION_NAMES}
    return TaskOptions(**opts)


def _split_actor_options(opts: dict) -> ActorOptions:
    unknown = set(opts) - _ACTOR_OPTION_NAMES
    if unknown:
        raise TypeError(f"unknown actor options: {sorted(unknown)}")
    opts = {k: v for k, v in opts.items() if k in _ACTOR_OPTION_NAMES}
    return ActorOptions(**opts)


class RemoteFunction:
    """Wrapper returned by @remote on a function (reference:
    python/ray/remote_function.py:41)."""

    def __init__(self, func, options: Optional[TaskOptions] = None):
        self._func = func
        self._options = options or TaskOptions()
        functools.update_wrapper(self, func)

    def remote(self, *args, **kwargs):
        backend = _cluster()
        if backend is not None:
            out = backend.submit_task(self._func, args, kwargs, self._options)
            return out[0] if self._options.num_returns == 1 else out
        if self._options.runtime_env:
            raise ValueError(_RUNTIME_ENV)
        runtime = _auto_init()
        out = runtime.submit_task(self._func, args, kwargs, self._options)
        if isinstance(out, ObjectRefGenerator):
            return out
        if self._options.num_returns == 1:
            return out[0]
        return out

    def options(self, **opts) -> "RemoteFunction":
        import dataclasses

        # shallow field copy (asdict would deepcopy placement groups)
        merged = {
            f.name: getattr(self._options, f.name)
            for f in dataclasses.fields(self._options)
        }
        merged.update(opts)
        return RemoteFunction(self._func, _split_task_options(merged))

    def bind(self, *args, **kwargs):
        """Record a DAG node for workflows and compiled graphs."""
        from ray_tpu_torch.dag.nodes import FunctionNode

        return FunctionNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self._func.__name__} cannot be called directly; "
            f"use .remote()"
        )


# ---------------------------------------------------------------------------
# actors
# ---------------------------------------------------------------------------


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns: Union[int, str] = 1):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    def remote(self, *args, **kwargs):
        return self._handle._invoke(self._name, args, kwargs, self._num_returns)

    def options(self, num_returns: Union[int, str] = 1) -> "ActorMethod":
        return ActorMethod(self._handle, self._name, num_returns)

    def bind(self, *args, **kwargs):
        """Record a compiled-graph node instead of submitting."""
        from ray_tpu_torch.dag.nodes import ClassMethodNode

        return ClassMethodNode(self._handle, self._name, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor method {self._name} cannot be called directly; use .remote()"
        )


def method(num_returns: Union[int, str] = 1):
    """Per-method decorator (reference @ray.method)."""

    def deco(f):
        f._ray_tpu_num_returns = num_returns
        return f

    return deco


class ActorHandle:
    def __init__(self, actor: Actor, runtime: rt.Runtime):
        object.__setattr__(self, "_actor", actor)
        object.__setattr__(self, "_runtime", runtime)

    def _invoke(self, method_name: str, args, kwargs, num_returns=1):
        runtime: rt.Runtime = self._runtime
        actor: Actor = self._actor
        task_id = TaskID.from_random()
        streaming = num_returns == "streaming"
        n = 1 if streaming else int(num_returns)
        from ray_tpu_torch.core.task import TaskSpec
        from ray_tpu_torch.obs import context as trace_context

        ctx = trace_context.current()
        spec = TaskSpec(
            task_id=task_id,
            func=actor.cls,  # carrier for describe(); not called
            args=args,
            kwargs=kwargs,
            options=TaskOptions(num_cpus=0, num_returns=num_returns, name=actor.cls.__name__),
            return_ids=[ObjectID.for_task_return(task_id, i) for i in range(n)],
            actor_id=actor.actor_id,
            method_name=method_name,
            streaming=streaming,
            trace=ctx.to_dict() if ctx is not None else None,
        )
        runtime._retain_arg_refs(spec)
        with runtime._lock:
            runtime._pending_tasks.add(task_id)
        from ray_tpu_torch.core.events import TaskState

        runtime.task_events.record(
            task_id, spec.describe(), TaskState.SUBMITTED,
            kind="actor_task", actor_id=actor.actor_id,
        )
        if streaming:
            gen = ObjectRefGenerator(runtime, spec.describe())
            runtime.streaming_generators[task_id] = gen
            actor.submit(spec)
            return gen
        refs = [ObjectRef(rid, runtime, spec.describe()) for rid in spec.return_ids]
        actor.submit(spec)
        return refs[0] if n == 1 else refs

    def __getattr__(self, name: str):
        actor: Actor = object.__getattribute__(self, "_actor")
        target = getattr(actor.cls, name, None)
        if target is None or not callable(target):
            raise AttributeError(f"actor {actor.cls.__name__} has no method {name!r}")
        num_returns = getattr(target, "_ray_tpu_num_returns", 1)
        return ActorMethod(self, name, num_returns)

    @property
    def state(self) -> str:
        return self._actor.state

    def __repr__(self):
        a: Actor = self._actor
        return f"ActorHandle({a.cls.__name__}, {a.actor_id.hex()[:8]})"

    def __reduce__(self):
        return (_rebuild_actor_handle, (self._actor.actor_id,))

    def __del__(self):
        try:
            actor: Actor = object.__getattribute__(self, "_actor")
            runtime: rt.Runtime = object.__getattribute__(self, "_runtime")
        except Exception:
            return
        try:
            _on_handle_dropped(runtime, actor)
        except Exception:
            pass


def _rebuild_actor_handle(actor_id: ActorID) -> ActorHandle:
    runtime = rt.get_runtime()
    actor = runtime.gcs.get_actor(actor_id)
    if actor is None:
        raise errors.ActorDiedError(f"actor {actor_id} no longer exists")
    actor.num_handles += 1
    return ActorHandle(actor, runtime)


def _on_handle_dropped(runtime: rt.Runtime, actor: Actor) -> None:
    actor.num_handles -= 1
    if actor.num_handles <= 0 and actor.options.lifetime != "detached":
        # all handles gone: terminate (reference: actor GC on handle count)
        actor.kill(no_restart=True)
        runtime.gcs.remove_actor(actor.actor_id)


class ActorClass:
    """Wrapper returned by @remote on a class (reference:
    python/ray/actor.py:605)."""

    def __init__(self, cls: type, options: Optional[ActorOptions] = None):
        self._cls = cls
        self._options = options or ActorOptions()
        functools.update_wrapper(self, cls, updated=[])

    def remote(self, *args, **kwargs) -> ActorHandle:
        backend = _cluster()
        if backend is not None:
            return backend.create_actor(self._cls, args, kwargs, self._options)
        if self._options.runtime_env:
            raise ValueError(_RUNTIME_ENV)
        runtime = _auto_init()
        opts = self._options
        if opts.name:
            existing = runtime.gcs.get_named_actor(opts.name, runtime.namespace)
            if existing is not None and existing.state != ActorState.DEAD:
                if opts.get_if_exists:
                    existing.num_handles += 1
                    return ActorHandle(existing, runtime)
                # check BEFORE acquiring resources/running the ctor, so a
                # name collision can't leak a live actor + its reservation
                raise ValueError(
                    f"actor name {opts.name!r} already taken in namespace "
                    f"{runtime.namespace!r}"
                )
        # actor resources are held for the actor's lifetime
        from ray_tpu_torch.core.scheduler import resolve_pool

        pool, req = resolve_pool(runtime, opts)
        if not pool.try_acquire(req):
            raise errors.RayTpuError(
                f"cannot create actor {self._cls.__name__}: resources {dict(req)} "
                f"unavailable (available: {dict(pool.available)})"
            )
        actor = Actor(
            runtime, ActorID.from_random(), self._cls, args, kwargs, opts
        )
        actor._resource_pool = pool
        actor._resource_req = req
        if actor.state == ActorState.DEAD:
            # ctor already failed before we attached the reservation
            actor._release_resources()
        try:
            runtime.gcs.register_actor(actor, opts.name, runtime.namespace)
        except Exception:
            # registration race lost: tear the orphan down, free resources
            actor.kill(no_restart=True)
            raise
        return ActorHandle(actor, runtime)

    def options(self, **opts) -> "ActorClass":
        import dataclasses

        merged = {
            f.name: getattr(self._options, f.name)
            for f in dataclasses.fields(self._options)
        }
        merged.update(opts)
        return ActorClass(self._cls, _split_actor_options(merged))

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self._cls.__name__} cannot be instantiated directly; "
            f"use .remote()"
        )


# ---------------------------------------------------------------------------
# the @remote decorator
# ---------------------------------------------------------------------------


def remote(*args, **kwargs):
    """@remote / @remote(num_cpus=..., resources=..., ...) on fn or class."""
    if len(args) == 1 and not kwargs and (callable(args[0]) or inspect.isclass(args[0])):
        target = args[0]
        if inspect.isclass(target):
            return ActorClass(target)
        return RemoteFunction(target)
    if args:
        raise TypeError("@remote takes keyword options only")

    def deco(target):
        if inspect.isclass(target):
            return ActorClass(target, _split_actor_options(kwargs))
        return RemoteFunction(target, _split_task_options(kwargs))

    return deco


# ---------------------------------------------------------------------------
# object API
# ---------------------------------------------------------------------------


def put(value: Any) -> ObjectRef:
    backend = _cluster()
    if backend is not None:
        return backend.put(value)
    return _auto_init().put(value)


def get(refs, timeout: Optional[float] = None):
    backend = _cluster()
    if backend is not None and not isinstance(refs, ObjectRef):
        return backend.get(refs, timeout=timeout)
    runtime = _auto_init()
    if isinstance(refs, ObjectRef):
        return runtime.get([refs], timeout)[0]
    return runtime.get(list(refs), timeout)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
):
    if not refs:
        return [], []
    backend = _cluster()
    if backend is not None and not isinstance(refs[0], ObjectRef):
        return backend.wait(list(refs), num_returns, timeout)
    return _auto_init().wait(list(refs), num_returns, timeout)


def free(refs) -> None:
    """Explicitly delete objects from the store (upstream:
    ray._private.internal_api.free), e.g. fire-and-forget acks in
    long-running loops."""
    if not isinstance(refs, (list, tuple)):
        refs = [refs]
    backend = _cluster()
    if backend is not None and refs and not isinstance(refs[0], ObjectRef):
        backend.client.free(list(refs))
        return
    runtime = _auto_init()
    for r in refs:
        # drop the producer's primary reference; the entry frees when the
        # remaining handle refs release
        runtime.object_store.remove_ref(r.id)


def kill(handle, *, no_restart: bool = True) -> None:
    if hasattr(handle, "_actor"):  # in-process handle
        handle._actor.kill(no_restart=no_restart)
    else:  # ClusterActorHandle: the worker dies with the actor's lease
        handle.kill()


def get_actor(name: str, namespace: Optional[str] = None):
    backend = _cluster()
    if backend is not None:
        return backend.get_named_actor(name, namespace)
    runtime = _auto_init()
    actor = runtime.gcs.get_named_actor(name, namespace or runtime.namespace)
    if actor is None or actor.state == ActorState.DEAD:
        raise ValueError(f"named actor {name!r} not found")
    actor.num_handles += 1
    return ActorHandle(actor, runtime)


def cluster_resources() -> dict:
    backend = _cluster()
    if backend is not None:
        return backend.cluster_resources()
    return _auto_init().gcs.cluster_resources()


def available_resources() -> dict:
    backend = _cluster()
    if backend is not None:
        return backend.available_resources()
    return _auto_init().gcs.available_resources()


def nodes() -> list:
    """The nodes of the attached cluster (``node_id``, ``addr``,
    ``resources``, ``available``, ``labels``, ``alive``, ``draining``), or
    the one node of the in-process runtime."""
    backend = _cluster()
    if backend is not None:
        return backend.nodes()
    runtime = _auto_init()
    return [{"node_id": runtime.node_id.hex(), "addr": None,
             "resources": runtime.gcs.cluster_resources(),
             "available": runtime.gcs.available_resources(), "labels": {},
             "alive": True, "draining": False}]


# ---------------------------------------------------------------------------
# placement groups
# ---------------------------------------------------------------------------


def placement_group(
    bundles: list[dict],
    strategy: str = "PACK",
    name: str = "",
) -> PlacementGroup:
    backend = _cluster()
    if backend is not None:
        return backend.placement_group(bundles, strategy, name)
    runtime = _auto_init()
    pg = create_placement_group(runtime, bundles, strategy, name)
    runtime.gcs.register_placement_group(pg)
    return pg


def remove_placement_group(pg) -> None:
    backend = _cluster()
    if backend is not None and not isinstance(pg, PlacementGroup):
        backend.remove_placement_group(pg)
        return
    runtime = _auto_init()
    pg.remove()
    runtime.gcs.remove_placement_group(pg.id)
