"""ObjectRef: a first-class future naming an object (counterpart of
``ray_tpu/core/ref.py``).

Upstream Ray's ObjectRef (python/ray/_raylet.pyx ObjectRef +
ownership in src/ray/core_worker/reference_count.h:66): the creating
process owns the object and its lifetime; refs are reference-counted and
the store entry is freed when the last ref drops.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Optional

from ray_tpu_torch.utils.ids import ObjectID

if TYPE_CHECKING:
    from ray_tpu_torch.core.runtime import Runtime


class ObjectRef:
    __slots__ = ("id", "_runtime", "_task_desc", "__weakref__")

    def __init__(self, obj_id: ObjectID, runtime: "Runtime", task_desc: str = ""):
        self.id = obj_id
        self._runtime = runtime
        self._task_desc = task_desc

    def future(self):
        """concurrent.futures.Future resolving to the object's value."""
        import concurrent.futures

        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _on_ready(_):
            try:
                fut.set_result(self._runtime.get([self], timeout=0)[0])
            except BaseException as e:  # noqa: BLE001 - propagate to future
                fut.set_exception(e)

        self._runtime.object_store.wait_async(self.id, _on_ready)
        return fut

    def hex(self) -> str:
        return self.id.hex()

    def __reduce__(self):
        # Serialized refs travel between workers of the same runtime; on
        # deserialization we re-attach to the process-local runtime.
        self._runtime.on_ref_serialized(self.id)
        return (_rebuild_ref, (self.id, self._task_desc))

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()[:12]}{', ' + self._task_desc if self._task_desc else ''})"

    def __del__(self):
        runtime = getattr(self, "_runtime", None)
        if runtime is not None:
            try:
                runtime.on_ref_deleted(self.id)
            except Exception:
                pass

    def __await__(self):
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()


def _rebuild_ref(obj_id: ObjectID, task_desc: str) -> ObjectRef:
    from ray_tpu_torch.core.runtime import get_runtime

    return ObjectRef(obj_id, get_runtime(), task_desc)


class ObjectRefGenerator:
    """Streaming returns: iterate refs as the task yields them (analog of
    reference ObjectRefGenerator, python/ray/_raylet.pyx:294)."""

    def __init__(self, runtime: "Runtime", task_desc: str = ""):
        self._runtime = runtime
        self._task_desc = task_desc
        self._items: list[ObjectRef] = []
        self._cursor = 0
        self._done = False
        self._cv = threading.Condition()

    # producer side (runtime)
    def _append(self, ref: ObjectRef) -> None:
        with self._cv:
            self._items.append(ref)
            self._cv.notify_all()

    def _finish(self) -> None:
        with self._cv:
            self._done = True
            self._cv.notify_all()

    # consumer side (single shared cursor: __iter__ and next_ready compose)
    def __iter__(self):
        while True:
            item = self.next_ready()
            if item is None:
                return
            yield item

    def next_ready(self, timeout: Optional[float] = None) -> Optional[ObjectRef]:
        with self._cv:
            while self._cursor >= len(self._items) and not self._done:
                if not self._cv.wait(timeout):
                    return None
            if self._cursor < len(self._items):
                item = self._items[self._cursor]
                self._cursor += 1
                return item
            return None
