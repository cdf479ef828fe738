"""Distributed queue backed by an actor (a copy of ``ray_tpu/util/queue.py``).

Reference analog: python/ray/util/queue.py (Queue wrapping an _QueueActor;
Empty/Full re-exported with the same semantics). ``_QueueActor`` is an
async actor of whichever runtime the creating process runs: the in-process
runtime's, or, after ``init(address=...)``, a cluster's. A ``Queue`` pickles
as its actor handle, so a cluster task or actor that receives it (a GPU
actor draining requests, say) reaches the same actor through its own
worker's client.
"""

from __future__ import annotations

import asyncio
from typing import Any, Optional


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int = 0):
        self._q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)

    async def put(self, item, timeout: Optional[float] = None) -> bool:
        try:
            await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    def put_nowait(self, item) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def get(self, timeout: Optional[float] = None):
        try:
            return True, await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    def get_nowait(self):
        try:
            return True, self._q.get_nowait()
        except asyncio.QueueEmpty:
            return False, None

    def qsize(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()

    def full(self) -> bool:
        return self._q.full()


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        import ray_tpu_torch

        opts = dict(actor_options or {"num_cpus": 0})
        # the queue actor must serve get() while a put() blocks on a full
        # queue (and vice versa) — concurrency 1 would deadlock both sides
        opts.setdefault("max_concurrency", 1000)
        self.actor = ray_tpu_torch.remote(_QueueActor).options(**opts).remote(maxsize)

    def put(self, item: Any, block: bool = True, timeout: Optional[float] = None) -> None:
        import ray_tpu_torch

        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                raise Full("queue is full")
            return
        if not ray_tpu_torch.get(self.actor.put.remote(item, timeout)):
            raise Full(f"put timed out after {timeout}s")

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        import ray_tpu_torch

        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty("queue is empty")
            return item
        ok, item = ray_tpu_torch.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty(f"get timed out after {timeout}s")
        return item

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def qsize(self) -> int:
        import ray_tpu_torch

        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        import ray_tpu_torch

        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        import ray_tpu_torch

        return ray_tpu_torch.get(self.actor.full.remote())

    def shutdown(self) -> None:
        import ray_tpu_torch

        ray_tpu_torch.kill(self.actor)
