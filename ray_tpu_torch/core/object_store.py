"""In-process object store (counterpart of ``ray_tpu/core/object_store.py``).

The runtime's objects (``put``, task returns, streamed items) are held BY
REFERENCE: tasks and actors are threads of the process that owns the
card, so a value handed to ``put`` or returned by a task is the very
object ``get`` returns, never a copy. A dict of CUDA tensors (a model's
16 GB of weights) passes through ``put``/``get``, a task's arguments or a
Serve deployment's constructor arguments without a byte moved.
Refcounted, thread-safe, with ready callbacks for ``wait`` and for the
scheduler's dependency resolution.

The tiered KV cache's object tier (``llm/kvtier``) keeps its entries here
as serialized bytes (``put_serialized`` / ``serialized_get``).
``serialize`` is pickle protocol 5 with out-of-band buffers (numpy arrays
ride beside the payload without a copy into it); the reference uses
``cloudpickle``, which the card's host is not promised to have, and
nothing serialized here needs it.

``KVTierConfig(object_store=...)`` takes any object with the three
methods the tier calls (``put_serialized``, ``serialized_get``,
``remove_ref``), as the reference does; ``tier_store`` refuses one that
lacks them when the config is built, with a ``TypeError`` naming the
missing methods, where the reference fails at the first spill.
"""

from __future__ import annotations

import pickle
import sys
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from ray_tpu_torch.core.errors import GetTimeoutError
from ray_tpu_torch.utils.ids import ObjectID

__all__ = ["GetTimeoutError", "ObjectID", "ObjectStore", "deserialize", "serialize",
           "tier_store"]

TIER_METHODS = ("put_serialized", "serialized_get", "remove_ref")


@dataclass
class _Entry:
    """ref_count semantics: starts at 0 for placeholder entries (waiters,
    tombstones); the producing put() adds the primary reference. A negative
    count is a tombstone: the owner ObjectRef died before production, so
    the value is dropped the moment it lands (fire-and-forget tasks must
    not leak)."""

    value: Any = None
    serialized: Optional[tuple] = None  # (payload, out-of-band buffers)
    ready: threading.Event = field(default_factory=threading.Event)
    error: Optional[BaseException] = None
    ref_count: int = 0
    nbytes: int = 0


def serialize(value: Any) -> tuple[bytes, list]:
    """pickle protocol 5; PickleBuffers (numpy arrays) go out of band."""
    buffers: list = []
    payload = pickle.dumps(value, protocol=5, buffer_callback=buffers.append)
    return payload, [np.frombuffer(b, dtype=np.uint8) for b in buffers]


def deserialize(payload: bytes, buffers: list) -> Any:
    return pickle.loads(payload, buffers=buffers)


def tier_store(store: Any) -> Any:
    """The tiered cache's object store: ``store`` itself when it has the
    methods the tier calls (None: a new private ObjectStore)."""
    if store is None:
        return ObjectStore()
    missing = [m for m in TIER_METHODS if not callable(getattr(store, m, None))]
    if missing:
        raise TypeError(f"object store {store!r} lacks {', '.join(missing)}")
    return store


class ObjectStore:
    """Per-process store. Thread-safe. Values are stored by reference;
    ``serialized_get`` materializes bytes only for a caller that asks."""

    def __init__(self, capacity_bytes: int = 0):
        self._entries: dict[ObjectID, _Entry] = {}
        self._lock = threading.Lock()
        self._capacity = capacity_bytes  # 0 = unbounded (host RAM)
        self._used = 0
        self._on_ready: dict[ObjectID, list[Callable[[ObjectID], None]]] = {}

    # -- write paths ---------------------------------------------------------

    def put(self, obj_id: ObjectID, value: Any) -> None:
        with self._lock:
            entry = self._entries.setdefault(obj_id, _Entry())
            entry.ref_count += 1  # the producer's primary reference
            entry.value = value
            entry.nbytes = _estimate_nbytes(value)
            self._used += entry.nbytes
            entry.ready.set()
            callbacks = self._on_ready.pop(obj_id, [])
            self._maybe_free_locked(obj_id, entry)
        for cb in callbacks:
            cb(obj_id)

    def put_error(self, obj_id: ObjectID, error: BaseException) -> None:
        with self._lock:
            entry = self._entries.setdefault(obj_id, _Entry())
            entry.ref_count += 1
            entry.error = error
            entry.ready.set()
            callbacks = self._on_ready.pop(obj_id, [])
            self._maybe_free_locked(obj_id, entry)
        for cb in callbacks:
            cb(obj_id)

    def put_serialized(self, obj_id: ObjectID, payload: bytes, buffers: list) -> None:
        with self._lock:
            entry = self._entries.setdefault(obj_id, _Entry())
            entry.ref_count += 1
            entry.serialized = (payload, buffers)
            entry.nbytes = len(payload) + sum(int(getattr(b, "nbytes", len(b))) for b in buffers)
            self._used += entry.nbytes
            entry.ready.set()
            callbacks = self._on_ready.pop(obj_id, [])
            self._maybe_free_locked(obj_id, entry)
        for cb in callbacks:
            cb(obj_id)

    # -- read paths ----------------------------------------------------------

    def contains(self, obj_id: ObjectID) -> bool:
        with self._lock:
            e = self._entries.get(obj_id)
            return e is not None and e.ready.is_set()

    def _wait_entry(self, obj_id: ObjectID, timeout: Optional[float]) -> _Entry:
        with self._lock:
            entry = self._entries.get(obj_id)
            if entry is None:
                # not produced yet (a pending task return): a waiter's placeholder
                entry = self._entries[obj_id] = _Entry()
        if not entry.ready.wait(timeout):
            raise GetTimeoutError(f"timed out waiting for {obj_id}")
        return entry

    def get(self, obj_id: ObjectID, timeout: Optional[float] = None) -> Any:
        entry = self._wait_entry(obj_id, timeout)
        if entry.error is not None:
            raise entry.error
        if entry.value is None and entry.serialized is not None:
            payload, buffers = entry.serialized
            entry.value = deserialize(payload, buffers)
        return entry.value

    def wait_async(self, obj_id: ObjectID, callback: Callable[[ObjectID], None]) -> None:
        """Invoke callback when the object is ready (immediately if already)."""
        with self._lock:
            entry = self._entries.get(obj_id)
            if entry is None or not entry.ready.is_set():
                self._on_ready.setdefault(obj_id, []).append(callback)
                if entry is None:
                    self._entries[obj_id] = _Entry()
                return
        callback(obj_id)

    def cancel_wait(self, obj_id: ObjectID, callback: Callable[[ObjectID], None]) -> None:
        """Deregister a wait_async callback (polling wait() must not leak)."""
        with self._lock:
            cbs = self._on_ready.get(obj_id)
            if cbs is None:
                return
            try:
                cbs.remove(callback)
            except ValueError:
                pass
            if not cbs:
                del self._on_ready[obj_id]

    def serialized_get(self, obj_id: ObjectID, timeout: Optional[float] = None) -> tuple:
        """(payload, buffers), waiting up to ``timeout`` for the put; a value
        put by reference is serialized once, here."""
        entry = self._wait_entry(obj_id, timeout)
        if entry.error is not None:
            raise entry.error
        with self._lock:
            if entry.serialized is None:
                entry.serialized = serialize(entry.value)
            return entry.serialized

    # -- ref counting --------------------------------------------------------

    def add_ref(self, obj_id: ObjectID, n: int = 1) -> None:
        with self._lock:
            entry = self._entries.setdefault(obj_id, _Entry())
            entry.ref_count += n

    def remove_ref(self, obj_id: ObjectID, n: int = 1) -> None:
        with self._lock:
            entry = self._entries.get(obj_id)
            if entry is None:
                # the ref died before the value: the later put frees it at once
                self._entries[obj_id] = _Entry(ref_count=-n)
                return
            entry.ref_count -= n
            self._maybe_free_locked(obj_id, entry)

    def _maybe_free_locked(self, obj_id: ObjectID, entry: _Entry) -> None:
        if entry.ref_count <= 0 and entry.ready.is_set() and not self._on_ready.get(obj_id):
            self._used -= entry.nbytes
            self._entries.pop(obj_id, None)

    def stats(self) -> dict:
        with self._lock:
            return {
                "num_objects": len(self._entries),
                "used_bytes": self._used,
                "capacity_bytes": self._capacity,
            }


def _estimate_nbytes(value: Any) -> int:
    """The bytes a value holds, for ``stats()``: an array's or a tensor's
    buffer (a tensor's whole storage, which a view keeps alive), a bytes
    object's length, else a nominal 64 for a small Python object."""
    if isinstance(value, np.ndarray):
        return value.nbytes
    if isinstance(value, (bytes, bytearray)):
        return len(value)
    torch = sys.modules.get("torch")  # nothing is a tensor before torch is imported
    if torch is not None and isinstance(value, torch.Tensor):
        try:
            return int(value.untyped_storage().nbytes())
        except (RuntimeError, NotImplementedError):  # no storage (a meta tensor)
            return int(value.nbytes)
    return 64
