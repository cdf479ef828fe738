"""DeploymentHandle / DeploymentResponse: the composition API (counterpart
of ``ray_tpu/serve/handle.py``).

Upstream analog: python/ray/serve/handle.py (DeploymentHandle.remote
:625,701, DeploymentResponse, DeploymentResponseGenerator). A response
can be passed directly as an argument to another handle call: the
underlying ObjectRef is substituted, so the downstream replica receives
the resolved value (dataflow composition). Arguments travel by
reference: a handle call hands the replica the caller's objects.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from ray_tpu_torch.serve.router import Router


class _RouteSlot:
    """One dispatch's inflight accounting; shared with a GC finalizer so
    fire-and-forget calls (response dropped without .result()) still
    decrement the router's count exactly once. When the caller carried a
    TraceContext, completion also records the `serve.request` span
    (dispatch -> result consumed) into the flight recorder."""

    def __init__(self, router: Router, rid: str, span_info: Optional[tuple] = None):
        self._router = router
        self._rid = rid
        self._span_info = span_info  # (ctx, parent_span_id, t0, attrs)
        self._done = False
        self._lock = threading.Lock()

    def complete(self, record_span: bool = True):
        with self._lock:
            if self._done:
                return
            self._done = True
        self._router.complete(self._rid)
        # record_span=False on the GC-finalizer path: a fire-and-forget
        # response may be collected seconds after the call finished, and
        # stamping end=now there would invent phantom request latency
        if record_span and self._span_info is not None:
            try:
                import time

                from ray_tpu_torch.obs import Span, get_recorder

                ctx, parent_span_id, t0, attrs = self._span_info
                get_recorder().add(Span(
                    trace_id=ctx.trace_id,
                    span_id=ctx.span_id,
                    parent_id=parent_span_id,
                    name="serve.request",
                    start=t0,
                    end=time.time(),
                    attrs=attrs,
                ))
            except Exception:  # noqa: BLE001 — tracing must not fail calls
                pass


def _is_replica_failure(exc: BaseException) -> bool:
    """Did this call die with the REPLICA (system failure) rather than in
    user code? Matched by type name so the core errors
    (ray_tpu_torch.core.errors) and chaos-injected crashes
    (``ReplicaCrashed``) count, wherever they sit in a TaskError cause
    chain."""
    names = {
        "ActorDiedError", "ActorUnavailableError", "WorkerCrashedError",
        "ReplicaCrashed",
    }
    seen: set = set()
    stack: list = [exc]
    while stack:
        e = stack.pop()
        if e is None or id(e) in seen:
            continue
        seen.add(id(e))
        if type(e).__name__ in names:
            return True
        stack.append(getattr(e, "cause", None))
        stack.append(e.__cause__)
    return False


def _record_failover(app: str, deployment: str, failed_rid: str,
                     exc: BaseException, attempt: int) -> None:
    """serve.failover event into the flight recorder: the post-mortem
    shows which replica died and that the request re-homed."""
    try:
        import time

        from ray_tpu_torch.obs import get_recorder

        now = time.time()
        get_recorder().record(
            "serve.failover", now, now,
            attrs={
                "app": app, "deployment": deployment,
                "failed_replica": failed_rid, "attempt": attempt,
                "error": f"{type(exc).__name__}: {exc}"[:200],
            },
            status="error",
        )
    except Exception:  # noqa: BLE001
        pass


class DeploymentResponse:
    """Future for one unary handle call.

    When the call carries retry info (unary, retries enabled on the
    handle), a SYSTEM failure — the replica died or crashed mid-request,
    not a user exception — re-dispatches onto a healthy replica, with the
    dead one evicted from the router set. User-code errors and timeouts
    propagate untouched; in-flight work on a dead replica is assumed
    idempotent by the caller that left retries on (reference: serve
    retries actor-death failures at the handle layer)."""

    def __init__(self, router: Router, rid: str, ref, span_info=None,
                 retry: Optional[tuple] = None):
        import weakref

        self._router = router
        self._rid = rid
        self._slot = _RouteSlot(router, rid, span_info)
        self._ref = ref
        self._retry = retry  # (method_name, args, kwargs, max_retries)
        self._failed: set = set()   # replica ids to avoid on re-dispatch
        self._attempts = 0          # the budget: ATTEMPTS, not unique rids
        weakref.finalize(self, self._slot.complete, False)

    def _complete(self):
        self._slot.complete()

    def _reroute(self) -> None:
        """Re-dispatch this request excluding every replica it died on.
        The original call's child TraceContext (span_info[0]) is
        re-attached around the dispatch so the retried execution's spans
        land in the same trace — result() may run on a thread with no
        ambient context at all."""
        import contextlib
        import weakref

        from ray_tpu_torch.obs import context as trace_context

        method_name, args, kwargs, _ = self._retry
        span_info = self._slot._span_info
        self._slot.complete(record_span=False)
        ctx = (
            trace_context.use(span_info[0]) if span_info is not None
            else contextlib.nullcontext()
        )
        with ctx:
            rid, ref = self._router.dispatch(
                method_name, args, kwargs, False, exclude=set(self._failed)
            )
        self._rid = rid
        self._ref = ref
        self._slot = _RouteSlot(self._router, rid, span_info)
        weakref.finalize(self, self._slot.complete, False)

    def result(self, timeout_s: Optional[float] = None) -> Any:
        import time

        import ray_tpu_torch

        # ONE overall deadline across failover attempts: the caller's
        # timeout bounds the call, not each retry individually
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            remaining = (
                None if deadline is None
                else max(0.001, deadline - time.monotonic())
            )
            try:
                out = ray_tpu_torch.get(self._ref, timeout=remaining)
                self._complete()
                return out
            except BaseException as e:  # noqa: BLE001 — filtered below
                # budget counts ATTEMPTS (a set of failed rids would never
                # grow when the only replica keeps crashing — infinite loop)
                if (
                    self._retry is None
                    or self._attempts >= self._retry[3]
                    or not _is_replica_failure(e)
                ):
                    self._complete()
                    raise
                self._attempts += 1
                failed = self._rid
                self._failed.add(failed)
                self._router.report_failure(failed)
                _record_failover(
                    self._router._app, self._router._deployment, failed, e,
                    attempt=self._attempts,
                )
                self._reroute()

    def __await__(self):
        import asyncio

        def _get():
            return self.result()

        loop = asyncio.get_event_loop()
        return loop.run_in_executor(None, _get).__await__()

    def _to_object_ref(self):
        """Expose the raw ref (for composition / ray_tpu_torch.get interop).
        Marks routing complete — the caller owns the ref from here."""
        self._complete()
        return self._ref


class DeploymentResponseGenerator:
    """Iterator over a streaming handle call."""

    def __init__(self, router: Router, rid: str, gen, span_info=None):
        import weakref

        self._slot = _RouteSlot(router, rid, span_info)
        self._gen = gen
        weakref.finalize(self, self._slot.complete, False)

    def __iter__(self):
        import ray_tpu_torch

        try:
            for item_ref in self._gen:
                yield ray_tpu_torch.get(item_ref)
        finally:
            self._slot.complete()

    async def __aiter__(self):
        import asyncio

        loop = asyncio.get_event_loop()
        it = iter(self)
        while True:
            try:
                item = await loop.run_in_executor(None, lambda: next(it, _SENTINEL))
            except StopIteration:
                return
            if item is _SENTINEL:
                return
            yield item


_SENTINEL = object()


def _substitute_responses(args: tuple, kwargs: dict) -> tuple[tuple, dict]:
    def sub(x):
        if isinstance(x, DeploymentResponse):
            return x._to_object_ref()
        return x

    return tuple(sub(a) for a in args), {k: sub(v) for k, v in kwargs.items()}


# One Router per (app, deployment) process-wide: every handle copy —
# including the throwaway handles created by attribute access — shares the
# same in-flight accounting, so power-of-two-choices and max_queued
# backpressure see the true load.
_ROUTERS: dict[tuple, Router] = {}
_ROUTERS_LOCK = threading.Lock()


def _shared_router(app_name: str, deployment_name: str) -> Router:
    key = (app_name, deployment_name)
    with _ROUTERS_LOCK:
        router = _ROUTERS.get(key)
        if router is None:
            from ray_tpu_torch.serve.api import _get_controller_handle

            # max_queued_requests arrives with the first replica-set refresh
            # (and tracks redeploys) — no snapshot RPC here
            router = Router(deployment_name, app_name, _get_controller_handle())
            _ROUTERS[key] = router
        return router


def _drop_routers() -> None:
    """Called by serve.shutdown: routers hold dead controller/replica handles."""
    with _ROUTERS_LOCK:
        _ROUTERS.clear()


class DeploymentHandle:
    """Client-side handle to a deployment; cheap to copy; safe to pass into
    other deployments' constructors (model composition)."""

    def __init__(
        self,
        deployment_name: str,
        app_name: str,
        method_name: Optional[str] = None,
        streaming: bool = False,
        system_retries: int = 2,
        pin_replica: Optional[str] = None,
        prefer_replica: Optional[str] = None,
    ):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self._method_name = method_name
        self._streaming = streaming
        # failover: how many times a unary call may re-dispatch after a
        # REPLICA death (user errors never retry). 0 opts a non-idempotent
        # endpoint out via .options(system_retries=0).
        self._system_retries = system_retries
        # replica pin (KV affinity): route to exactly this replica or
        # raise ReplicaPinError; pinned calls never failover-retry, the
        # state they target died with the replica
        self._pin_replica = pin_replica
        # soft prefix affinity (prefix-aware routing): PREFER this replica
        # (it already holds the request's KV prefix in some tier) but fall
        # back to p2c when it is dead, suspected, or overloaded; unlike a
        # pin, a stale hint can never fail a call
        self._prefer_replica = prefer_replica

    # Handles carry no live state (the router is process-local, looked up
    # on each dispatch), so pickling is trivially safe.
    def __getstate__(self):
        return {
            "deployment_name": self.deployment_name,
            "app_name": self.app_name,
            "_method_name": self._method_name,
            "_streaming": self._streaming,
            "_system_retries": self._system_retries,
            "_pin_replica": self._pin_replica,
            "_prefer_replica": self._prefer_replica,
        }

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.__dict__.setdefault("_system_retries", 2)
        self.__dict__.setdefault("_pin_replica", None)
        self.__dict__.setdefault("_prefer_replica", None)

    def _get_router(self) -> Router:
        return _shared_router(self.app_name, self.deployment_name)

    def options(
        self,
        *,
        method_name: Optional[str] = None,
        stream: Optional[bool] = None,
        system_retries: Optional[int] = None,
        pin_replica: Optional[str] = None,
        prefer_replica: Optional[str] = None,
        use_new_handle_api: bool = True,  # accepted for reference parity
    ) -> "DeploymentHandle":
        return DeploymentHandle(
            self.deployment_name,
            self.app_name,
            method_name if method_name is not None else self._method_name,
            stream if stream is not None else self._streaming,
            self._system_retries if system_retries is None else system_retries,
            pin_replica if pin_replica is not None else self._pin_replica,
            prefer_replica if prefer_replica is not None else self._prefer_replica,
        )

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.options(method_name=name)

    def remote(self, *args, **kwargs):
        args, kwargs = _substitute_responses(args, kwargs)
        router = self._get_router()
        from ray_tpu_torch.obs import context as trace_context

        parent = trace_context.current()
        span_info = None
        if parent is not None:
            # dispatch under a child context: the actor envelope the router
            # submits captures it, so the replica's spans nest under this
            # call's serve.request span (recorded when the response is
            # consumed — _RouteSlot.complete)
            import time

            child = parent.child()
            span_info = (child, parent.span_id, time.time(), {
                "app": self.app_name,
                "deployment": self.deployment_name,
                "method": self._method_name or "__call__",
            })
            with trace_context.use(child):
                rid, ref = router.dispatch(
                    self._method_name, args, kwargs, self._streaming,
                    pin=self._pin_replica, prefer=self._prefer_replica,
                )
        else:
            rid, ref = router.dispatch(
                self._method_name, args, kwargs, self._streaming,
                pin=self._pin_replica, prefer=self._prefer_replica,
            )
        if self._streaming:
            # streaming calls never auto-retry: items may already have
            # been consumed (not idempotent to replay)
            return DeploymentResponseGenerator(router, rid, ref, span_info)
        # pinned calls never failover-retry either: the replica-resident
        # state they target (an imported KV sequence) died with the pin
        retry = (
            (self._method_name, args, kwargs, self._system_retries)
            if self._system_retries > 0 and self._pin_replica is None else None
        )
        return DeploymentResponse(router, rid, ref, span_info, retry=retry)
