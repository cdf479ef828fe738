"""Actor runtime: stateful workers with ordered mailboxes (counterpart of
``ray_tpu/core/actor_runtime.py``).

Upstream Ray's actor machinery (GcsActorManager
src/ray/gcs/gcs_server/gcs_actor_manager.h:324 for lifecycle,
ActorTaskSubmitter src/ray/core_worker/transport/actor_task_submitter.h:75
for ordered delivery, ConcurrencyGroupManager + fiber.h for async actors).
Actors are threads (or asyncio tasks on the actor's own event loop) of
the process that owns the card, so "submission order == execution order"
falls out of a FIFO mailbox rather than sequence-number resequencing over
gRPC. An async actor's coroutines run on the loop its thread created: an
``asyncio.get_running_loop()`` inside a method is that loop. Restart
semantics (`max_restarts`) re-run the constructor in a fresh mailbox.
"""

from __future__ import annotations

import asyncio
import inspect
import queue
import threading
import traceback
from typing import TYPE_CHECKING, Any, Optional

from ray_tpu_torch.core import errors
from ray_tpu_torch.core.scheduler import resolve_args
from ray_tpu_torch.core.task import ActorOptions, TaskSpec
from ray_tpu_torch.utils.ids import ActorID, ObjectID
from ray_tpu_torch.utils.logging import get_logger

if TYPE_CHECKING:
    from ray_tpu_torch.core.runtime import Runtime

logger = get_logger("ray_tpu_torch.actors")

_KILL = object()  # mailbox sentinel


class ActorState:
    PENDING = "PENDING_CREATION"
    ALIVE = "ALIVE"
    RESTARTING = "RESTARTING"
    DEAD = "DEAD"


class Actor:
    """Server side of one actor: instance + mailbox + executor thread(s)."""

    def __init__(
        self,
        runtime: "Runtime",
        actor_id: ActorID,
        cls: type,
        ctor_args: tuple,
        ctor_kwargs: dict,
        options: ActorOptions,
    ):
        self.runtime = runtime
        self.actor_id = actor_id
        self.cls = cls
        self.ctor_args = ctor_args
        self.ctor_kwargs = ctor_kwargs
        self.options = options
        self.state = ActorState.PENDING
        self.instance: Any = None
        self.death_cause: Optional[BaseException] = None
        self.restarts_used = 0
        self.num_handles = 1
        # set by ActorClass.remote after construction; released once on death
        self._resource_pool = None
        self._resource_req = None
        self._resources_released = False
        self._mailbox: queue.Queue = queue.Queue()
        self._is_async = any(
            inspect.iscoroutinefunction(m) or inspect.isasyncgenfunction(m)
            for _, m in inspect.getmembers(cls, inspect.isfunction)
        )
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._main,
            args=(self._mailbox,),
            name=f"ray_tpu_torch-actor-{actor_id.hex()[:8]}",
            daemon=True,
        )
        self._thread.start()

    # -- lifecycle -----------------------------------------------------------

    def _construct(self) -> bool:
        try:
            args, kwargs = resolve_args(self.runtime, self.ctor_args, self.ctor_kwargs)
            self.instance = self.cls(*args, **kwargs)
            self.state = ActorState.ALIVE
            return True
        except BaseException as e:  # noqa: BLE001
            self.death_cause = errors.TaskError(
                e, traceback.format_exc(), f"{self.cls.__name__}.__init__"
            )
            self.state = ActorState.DEAD
            return False

    def _main(self, mailbox: queue.Queue) -> None:
        if not self._construct():
            self._drain_dead(mailbox)
            return
        if self._is_async:
            self._async_main(mailbox)
        else:
            self._sync_main(mailbox)
        self._drain_dead(mailbox)

    def _stale(self, mailbox: queue.Queue) -> bool:
        """True if this thread's mailbox was swapped out by a restart."""
        with self._lock:
            # the restart path (kill with restarts left) swaps _mailbox
            # under _lock; an unlocked read here could let a dying
            # incarnation mark the RESTARTED actor DEAD in _drain_dead
            return mailbox is not self._mailbox

    def _sync_main(self, mailbox: queue.Queue) -> None:
        conc = max(1, self.options.max_concurrency)
        if conc == 1:
            while True:
                item = mailbox.get()
                if item is _KILL:
                    break
                self._execute(item)
        else:
            import concurrent.futures

            with concurrent.futures.ThreadPoolExecutor(max_workers=conc) as pool:
                while True:
                    item = mailbox.get()
                    if item is _KILL:
                        break
                    pool.submit(self._execute, item)

    def _async_main(self, mailbox: queue.Queue) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        sem = asyncio.Semaphore(max(1, self.options.max_concurrency or 1000))

        async def runner():
            while True:
                item = await loop.run_in_executor(None, mailbox.get)
                if item is _KILL:
                    return
                asyncio.ensure_future(self._execute_async(item, sem))

        try:
            loop.run_until_complete(runner())
            pending = asyncio.all_tasks(loop)
            for t in pending:
                t.cancel()
            if pending:
                # let cancellations actually run so in-flight calls deliver
                # ActorDiedError instead of hanging their callers
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True)
                )
        finally:
            loop.close()

    def _drain_dead(self, mailbox: queue.Queue) -> None:
        """After this mailbox's actor incarnation ends: fail queued work, and
        drop the instance, so what it holds (an engine's KV cache and graphs)
        is freed although the actor's record and handles live on."""
        if not self._stale(mailbox):
            self.state = ActorState.DEAD
            self.instance = None
            self._release_resources()
        while True:
            try:
                item = mailbox.get_nowait()
            except queue.Empty:
                return
            if item is _KILL:
                continue
            self._fail(item, self._died_error())

    def _died_error(self) -> BaseException:
        return errors.ActorDiedError(
            f"actor {self.cls.__name__}[{self.actor_id.hex()[:8]}] is dead"
            + (f": {self.death_cause}" if self.death_cause else "")
        )

    # -- execution -----------------------------------------------------------

    def _framework_method(self, name: str):
        """Framework-injected actor methods, run on the actor's own executor
        thread so thread-local state lands where the actor's calls see it:
        a compiled DAG's exec loop. The collective group's setup call waits
        for the collective groups (ROADMAP.md Queue 1, item 10, D4)."""
        if name == "__ray_tpu_collective_init__":
            raise NotImplementedError(
                f"{name}: the collective groups (ROADMAP.md Queue 1, item 10, D4) are not "
                "ported yet")
        if name == "__ray_tpu_dag_exec_loop__":
            from ray_tpu_torch.dag.compiled import _actor_exec_loop

            return lambda plan, input_source: _actor_exec_loop(self.instance, plan, input_source)
        return None

    def _execute(self, spec: TaskSpec) -> None:
        # caller's context restored around execution: actor-task events
        # carry the trace, and user code in the method inherits it
        # (nested calls, obs.span blocks, serve replicas)
        from ray_tpu_torch.obs import context as trace_context

        with trace_context.use_from(spec.trace):
            return self._execute_body(spec)

    def _execute_body(self, spec: TaskSpec) -> None:
        from ray_tpu_torch.core.events import TaskState

        self.runtime.task_events.record(
            spec.task_id, spec.describe(), TaskState.RUNNING,
            kind="actor_task", actor_id=self.actor_id,
        )
        try:
            args, kwargs = resolve_args(self.runtime, spec.args, spec.kwargs)
            method = self._framework_method(spec.method_name) or getattr(
                self.instance, spec.method_name)
            if spec.streaming:
                from ray_tpu_torch.core.scheduler import _execute_streaming

                _execute_streaming(self.runtime, spec, args, kwargs, fn=method)
                return
            result = method(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001
            self._fail(
                spec, errors.TaskError(e, traceback.format_exc(), spec.describe())
            )
            return
        self._store(spec, result)

    async def _execute_async(self, spec: TaskSpec, sem: asyncio.Semaphore) -> None:
        # contextvar set inside the coroutine is task-local (asyncio
        # copies the context per task), so concurrent calls don't leak
        from ray_tpu_torch.obs import context as trace_context

        with trace_context.use_from(spec.trace):
            await self._execute_async_body(spec, sem)

    async def _execute_async_body(self, spec: TaskSpec, sem: asyncio.Semaphore) -> None:
        from ray_tpu_torch.core.events import TaskState

        async with sem:
            self.runtime.task_events.record(
                spec.task_id, spec.describe(), TaskState.RUNNING,
                kind="actor_task", actor_id=self.actor_id,
            )
            try:
                args, kwargs = resolve_args(self.runtime, spec.args, spec.kwargs)
                method = self._framework_method(spec.method_name) or getattr(
                    self.instance, spec.method_name)
                if spec.streaming:
                    await self._stream_async(spec, method, args, kwargs)
                    return
                result = method(*args, **kwargs)
                if inspect.isawaitable(result):
                    result = await result
            except asyncio.CancelledError:
                # actor killed while this call was in flight
                self._fail(spec, self._died_error())
                raise
            except BaseException as e:  # noqa: BLE001
                self._fail(
                    spec, errors.TaskError(e, traceback.format_exc(), spec.describe())
                )
                return
            self._store(spec, result)

    async def _stream_async(self, spec: TaskSpec, method, args, kwargs) -> None:
        from ray_tpu_torch.core.events import TaskState
        from ray_tpu_torch.core.ref import ObjectRef

        gen = self.runtime.streaming_generators.get(spec.task_id)
        failure = None
        try:
            it = method(*args, **kwargs)
            i = 0
            if hasattr(it, "__aiter__"):
                async for item in it:
                    obj_id = ObjectID.for_task_return(spec.task_id, i + 1)
                    self.runtime.object_store.put(obj_id, item)
                    if gen is not None:
                        gen._append(ObjectRef(obj_id, self.runtime, spec.describe()))
                    i += 1
            else:
                for item in it:
                    obj_id = ObjectID.for_task_return(spec.task_id, i + 1)
                    self.runtime.object_store.put(obj_id, item)
                    if gen is not None:
                        gen._append(ObjectRef(obj_id, self.runtime, spec.describe()))
                    i += 1
        except BaseException as e:  # noqa: BLE001
            failure = repr(e)
            err = errors.TaskError(e, traceback.format_exc(), spec.describe())
            if gen is not None:
                obj_id = ObjectID.for_task_return(spec.task_id, 0)
                self.runtime.object_store.put_error(obj_id, err)
                gen._append(ObjectRef(obj_id, self.runtime, spec.describe()))
        finally:
            if gen is not None:
                gen._finish()
            self.runtime.streaming_generators.pop(spec.task_id, None)
            self.runtime.on_task_finished(spec)
            self.runtime.task_events.record(
                spec.task_id, spec.describe(),
                TaskState.FAILED if failure else TaskState.FINISHED,
                kind="actor_task", actor_id=self.actor_id, error=failure,
            )

    def _store(self, spec: TaskSpec, result) -> None:
        from ray_tpu_torch.core.events import TaskState
        from ray_tpu_torch.core.scheduler import _store_results

        _store_results(self.runtime, spec, result)
        self.runtime.on_task_finished(spec)
        self.runtime.task_events.record(
            spec.task_id, spec.describe(), TaskState.FINISHED,
            kind="actor_task", actor_id=self.actor_id,
        )

    def _fail(self, spec: TaskSpec, err: BaseException) -> None:
        from ray_tpu_torch.core.events import TaskState

        for rid in spec.return_ids:
            self.runtime.object_store.put_error(rid, err)
        self.runtime.on_task_finished(spec)
        self.runtime.task_events.record(
            spec.task_id, spec.describe(), TaskState.FAILED,
            kind="actor_task", actor_id=self.actor_id, error=repr(err),
        )

    def _release_resources(self) -> None:
        with self._lock:
            if self._resources_released or self._resource_pool is None:
                return
            self._resources_released = True
        self._resource_pool.release(self._resource_req)
        self.runtime.scheduler.notify()

    # -- client side ---------------------------------------------------------

    def submit(self, spec: TaskSpec) -> None:
        with self._lock:
            if self.state == ActorState.DEAD:
                self._fail(spec, self._died_error())
                return
            self._mailbox.put(spec)

    def kill(self, no_restart: bool = True) -> None:
        with self._lock:
            if self.state == ActorState.DEAD:
                return
            if not no_restart and self.restarts_used < self.options.max_restarts:
                self.restarts_used += 1
                self.state = ActorState.RESTARTING
                old_thread = self._thread
                self._mailbox.put(_KILL)
                # fresh mailbox + thread re-running the constructor
                self._mailbox = queue.Queue()
                self._thread = threading.Thread(
                    target=self._main,
                    args=(self._mailbox,),
                    name=f"ray_tpu_torch-actor-{self.actor_id.hex()[:8]}-r{self.restarts_used}",
                    daemon=True,
                )
                self._thread.start()
                return
            self.state = ActorState.DEAD
            self.death_cause = errors.ActorDiedError("killed via ray_tpu_torch.kill")
            self._mailbox.put(_KILL)
