"""Serve replica: the actor that hosts one copy of a user callable
(counterpart of ``ray_tpu/serve/replica.py``).

Upstream analog: python/ray/serve/_private/replica.py (ReplicaActor
:883, handle_request/handle_request_streaming :988-1016). A replica is an
async actor: its constructor (the user's, e.g. ``LLMServer`` building its
engine on the card) runs on the actor's thread, its coroutines on the
actor's own event loop, and sync user callables on that loop's executor,
so the loop stays free for health checks and metrics while a call runs.
"""

from __future__ import annotations

import asyncio
import inspect
import time
from typing import Any, Optional

from ray_tpu_torch.chaos import harness as _chaos


class Replica:
    """User-code host. Instantiated as an async actor (max_concurrency
    bounds in-flight requests, matching max_ongoing_requests)."""

    def __init__(
        self,
        deployment_name: str,
        app_name: str,
        callable_factory,
        init_args: tuple,
        init_kwargs: dict,
        is_function: bool,
        user_config: Any = None,
        max_ongoing_requests: int = 100,
    ):
        self._deployment_name = deployment_name
        self._app_name = app_name
        self._is_function = is_function
        # Data-plane concurrency cap. The actor itself runs with a high
        # max_concurrency so control-plane calls (metrics, health checks,
        # reconfigure) never queue behind user requests.
        self._request_sem = asyncio.Semaphore(max(1, max_ongoing_requests))
        self._num_ongoing = 0
        self._num_processed = 0
        self._started_at = time.time()
        cls_or_fn = callable_factory
        if is_function:
            self._callable = cls_or_fn
        else:
            self._callable = cls_or_fn(*init_args, **init_kwargs)
        if user_config is not None:
            self._apply_user_config(user_config)

    # -- control-plane surface ------------------------------------------------

    def _apply_user_config(self, user_config) -> None:
        reconfigure = getattr(self._callable, "reconfigure", None)
        if reconfigure is None:
            raise ValueError(
                f"user_config was set but {type(self._callable).__name__} "
                f"defines no reconfigure() method"
            )
        reconfigure(user_config)

    async def reconfigure(self, user_config) -> None:
        self._apply_user_config(user_config)

    async def check_health(self) -> bool:
        check = getattr(self._callable, "check_health", None)
        if check is not None:
            out = check()
            if inspect.isawaitable(out):
                await out
        return True

    async def metrics(self) -> dict:
        return {
            "num_ongoing_requests": self._num_ongoing,
            "num_processed": self._num_processed,
            "uptime_s": time.time() - self._started_at,
        }

    async def ping(self) -> dict:
        """Controller health sweep: run the user's check_health hook, then
        report metrics. A raising hook fails the ping → replica replaced."""
        await self.check_health()
        return await self.metrics()

    async def prepare_shutdown(self, timeout_s: float) -> None:
        """Drain in-flight requests, then run the user's cleanup hook
        (graceful_shutdown_timeout_s)."""
        deadline = time.time() + timeout_s
        while self._num_ongoing > 0 and time.time() < deadline:
            await asyncio.sleep(0.01)
        if self._is_function:
            return
        # Prefer a dedicated shutdown() hook. For a user __del__, DROP our
        # reference instead of calling it — CPython refcounting then invokes
        # __del__ exactly once, here, rather than twice (explicit call + GC).
        hook = getattr(self._callable, "shutdown", None)
        if hook is not None and callable(hook):
            try:
                out = hook()
                if inspect.isawaitable(out):
                    await out
            except Exception:
                pass  # cleanup errors must not block teardown
        elif getattr(type(self._callable), "__del__", None) is not None:
            self._callable = None

    # -- data plane -----------------------------------------------------------

    def _resolve_target(self, method_name: Optional[str]):
        if self._is_function:
            return self._callable
        if method_name:
            target = getattr(self._callable, method_name, None)
            if target is None or not callable(target):
                raise AttributeError(
                    f"deployment {self._deployment_name} has no method {method_name!r}"
                )
            return target
        target = getattr(self._callable, "__call__", None)
        if target is None:
            raise AttributeError(
                f"deployment {self._deployment_name} is not callable; "
                f"specify a method name"
            )
        return target

    @staticmethod
    async def _resolve_refs(args, kwargs):
        """Upstream DeploymentResponses arrive as ObjectRefs nested in the
        args tuple (core only resolves top-level task args); fetch them here,
        off-loop so pending upstream calls don't block the replica."""
        from ray_tpu_torch.core.ref import ObjectRef

        if not any(isinstance(a, ObjectRef) for a in args) and not any(
            isinstance(v, ObjectRef) for v in kwargs.values()
        ):
            return args, kwargs
        import ray_tpu_torch

        loop = asyncio.get_running_loop()

        async def get(ref):
            return await loop.run_in_executor(None, lambda: ray_tpu_torch.get(ref))

        args = tuple(
            [(await get(a)) if isinstance(a, ObjectRef) else a for a in args]
        )
        kwargs = {
            k: (await get(v)) if isinstance(v, ObjectRef) else v
            for k, v in kwargs.items()
        }
        return args, kwargs

    def _request_span(self, method_name: Optional[str]):
        """`serve.replica` span (queue-wait + execution) when the call
        arrived under a trace; no-op context otherwise so untraced traffic
        doesn't fill the flight recorder."""
        import contextlib

        from ray_tpu_torch import obs

        if obs.current() is None:
            return contextlib.nullcontext()
        return obs.span("serve.replica", attrs={
            "deployment": self._deployment_name,
            "app": self._app_name,
            "method": method_name or "__call__",
        })

    def _chaos_hook(self, method_name: Optional[str]) -> None:
        """KILL_REPLICA injection: the request dies the way it would if
        this replica's process/actor crashed mid-call — callers see a
        system failure (ReplicaCrashed), the router's failover path
        retries elsewhere, the controller's health sweep replaces us."""
        if _chaos.ACTIVE is None:
            return
        for _f in _chaos.fire(
            "serve.replica", kinds=(_chaos.KILL_REPLICA,),
            deployment=self._deployment_name, app=self._app_name,
            method=method_name or "__call__",
        ):
            if _f.kind == _chaos.KILL_REPLICA:
                raise _chaos.ReplicaCrashed(
                    f"chaos: replica of {self._app_name}/"
                    f"{self._deployment_name} crashed mid-request"
                )

    async def handle_request(self, method_name: Optional[str], args, kwargs):
        """Unary request path. _num_ongoing counts queued + executing — the
        autoscaling signal wants in-replica load, not just active slots."""
        self._num_ongoing += 1
        try:
            async with self._request_sem:
                self._chaos_hook(method_name)
                with self._request_span(method_name):
                    args, kwargs = await self._resolve_refs(args, kwargs)
                    target = self._resolve_target(method_name)
                    if inspect.iscoroutinefunction(target):
                        return await target(*args, **kwargs)
                    # Sync callable: run off-loop so long computations don't
                    # starve the replica's event loop. copy_context ships
                    # the trace contextvar to the executor thread.
                    import contextvars

                    loop = asyncio.get_running_loop()
                    call_ctx = contextvars.copy_context()
                    out = await loop.run_in_executor(
                        None, lambda: call_ctx.run(target, *args, **kwargs)
                    )
                    if inspect.isawaitable(out):
                        out = await out
                    return out
        finally:
            self._num_ongoing -= 1
            self._num_processed += 1

    async def handle_request_streaming(self, method_name: Optional[str], args, kwargs):
        """Streaming path: the target must return an (a)sync generator;
        items are yielded through the framework's ObjectRefGenerator."""
        self._num_ongoing += 1
        try:
            async with self._request_sem:  # same cap as the unary path
                self._chaos_hook(method_name)
                with self._request_span(method_name):
                    args, kwargs = await self._resolve_refs(args, kwargs)
                    target = self._resolve_target(method_name)
                    out = target(*args, **kwargs)
                    if inspect.isawaitable(out):
                        out = await out
                    if hasattr(out, "__aiter__"):
                        async for item in out:
                            yield item
                    elif hasattr(out, "__iter__"):
                        for item in out:
                            yield item
                    else:
                        yield out
        finally:
            self._num_ongoing -= 1
            self._num_processed += 1
