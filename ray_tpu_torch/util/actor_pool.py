"""ActorPool: round-robin work distribution over a fixed set of actors (a
copy of ``ray_tpu/util/actor_pool.py``).

Reference analog: python/ray/util/actor_pool.py (same API surface:
map/map_unordered/submit/get_next/get_next_unordered/has_next). The actors
are the in-process runtime's handles or a cluster's
``ClusterActorHandle``s: ``ray_tpu_torch.get`` / ``wait`` route each kind
of future to its runtime. A timed-out ``get_next`` leaves the slot in
place with either kind of future (the reference's cluster futures raise a
timeout the pool does not recognise, so there it consumes the slot).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable


def _timeout_errors() -> tuple:
    """The timeouts of both runtimes' ``get``: the in-process runtime's
    ``GetTimeoutError`` and the cluster client's."""
    from ray_tpu_torch.cluster.client import GetTimeoutError as ClusterGetTimeoutError
    from ray_tpu_torch.core.errors import GetTimeoutError

    return GetTimeoutError, ClusterGetTimeoutError


class ActorPool:
    def __init__(self, actors: list):
        self._idle = list(actors)
        self._future_to_actor: dict = {}
        self._index_to_future: dict[int, Any] = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits: list = []

    def submit(self, fn: Callable, value: Any) -> None:
        """fn(actor, value) -> ObjectRef."""
        if self._idle:
            actor = self._idle.pop()
            future = fn(actor, value)
            self._future_to_actor[future] = actor
            self._index_to_future[self._next_task_index] = future
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._index_to_future) or bool(self._pending_submits)

    def _return_actor(self, actor) -> None:
        self._idle.append(actor)
        if self._pending_submits:
            self.submit(*self._pending_submits.pop(0))

    def _consume(self, future) -> None:
        del self._index_to_future[self._next_return_index]
        self._next_return_index += 1
        self._return_actor(self._future_to_actor.pop(future))

    def get_next(self, timeout: float | None = None) -> Any:
        """Next result in submission order."""
        import ray_tpu_torch

        if self._next_return_index >= self._next_task_index:
            raise StopIteration("no pending results")
        future = self._index_to_future[self._next_return_index]
        try:
            value = ray_tpu_torch.get(future, timeout=timeout)
        except _timeout_errors():
            raise  # state untouched: the caller can retry the same slot
        except Exception:
            # task FAILED (completed with error): consume the slot and
            # recycle the actor, then surface the error
            self._consume(future)
            raise
        self._consume(future)
        return value

    def get_next_unordered(self, timeout: float | None = None) -> Any:
        """Next result in completion order."""
        import ray_tpu_torch

        if not self._index_to_future:
            raise StopIteration("no pending results")
        ready, _ = ray_tpu_torch.wait(
            list(self._index_to_future.values()), num_returns=1, timeout=timeout
        )
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        future = ready[0]
        for idx, f in list(self._index_to_future.items()):
            if f is future:
                del self._index_to_future[idx]
                break
        self._return_actor(self._future_to_actor.pop(future))
        return ray_tpu_torch.get(future)

    def map(self, fn: Callable, values: Iterable) -> Iterable:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable) -> Iterable:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def pop_idle(self):
        return self._idle.pop() if self._idle else None

    def push(self, actor) -> None:
        self._return_actor(actor)
