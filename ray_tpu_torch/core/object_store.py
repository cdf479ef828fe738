"""In-process object store (counterpart of ``ray_tpu/core/object_store.py``).

The tiered KV cache's object tier (``llm/kvtier``) keeps its entries here:
refcounted, thread-safe, held as serialized bytes (``put_serialized`` /
``serialized_get``). ``serialize`` is pickle protocol 5
with out-of-band buffers (numpy arrays ride beside the payload without a
copy into it); the reference uses ``cloudpickle``, which the card's host
is not promised to have, and nothing stored here needs it (the tier
stores plain dataclasses and numpy arrays).

Not ported: a store shared across processes (the reference's plasma-shaped
boundary, shared-memory segments and the node runtime's transport), which
waits for the cluster runtime (ROADMAP.md Queue 1, B8). Anything but an
in-process ``ObjectStore`` handed to ``KVTierConfig(object_store=...)``
raises naming it (``require_local``).
"""

from __future__ import annotations

import pickle
import threading
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

_B8 = ("a store shared across processes is not ported to ray_tpu_torch yet "
       "(the cluster runtime, ROADMAP.md Queue 1, B8)")


class GetTimeoutError(TimeoutError):
    """``serialized_get`` waited its timeout for an object never produced."""


class ObjectID:
    """A 16-byte object id (the reference's ``ray_tpu.utils.ids.ObjectID``:
    hashable, comparable, hex-printable)."""

    SIZE = 16
    __slots__ = ("_bytes",)

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(f"ObjectID needs {self.SIZE} bytes, got {len(binary)}")
        self._bytes = bytes(binary)

    def hex(self) -> str:
        return self._bytes.hex()

    def __eq__(self, other) -> bool:
        return isinstance(other, ObjectID) and other._bytes == self._bytes

    def __hash__(self) -> int:
        return hash(self._bytes)

    def __repr__(self) -> str:
        return f"ObjectID({self.hex()})"


@dataclass
class _Entry:
    """ref_count starts at 0 for placeholders (a waiter) and goes negative
    for a tombstone (the last ref died before the value landed)."""

    serialized: Optional[tuple] = None  # (payload, out-of-band buffers)
    ready: threading.Event = field(default_factory=threading.Event)
    ref_count: int = 0
    nbytes: int = 0


def serialize(value: Any) -> tuple[bytes, list]:
    """pickle protocol 5; PickleBuffers (numpy arrays) go out of band."""
    buffers: list = []
    payload = pickle.dumps(value, protocol=5, buffer_callback=buffers.append)
    return payload, [np.frombuffer(b, dtype=np.uint8) for b in buffers]


def deserialize(payload: bytes, buffers: list) -> Any:
    return pickle.loads(payload, buffers=buffers)


def require_local(store: Any) -> "ObjectStore":
    """``store`` when it is an in-process ObjectStore (None: a new private
    one); anything else would be a store shared across processes."""
    if store is None:
        return ObjectStore()
    if not isinstance(store, ObjectStore):
        raise NotImplementedError(f"object store {store!r}: {_B8}")
    return store


class ObjectStore:
    """Per-process store. Thread-safe."""

    def __init__(self, capacity_bytes: int = 0):
        self._entries: dict[ObjectID, _Entry] = {}
        self._lock = threading.Lock()
        self._capacity = capacity_bytes  # 0 = unbounded (host RAM)
        self._used = 0

    def put_serialized(self, obj_id: ObjectID, payload: bytes, buffers: list) -> None:
        with self._lock:
            entry = self._entries.setdefault(obj_id, _Entry())
            entry.ref_count += 1  # the producer's primary reference
            entry.serialized = (payload, buffers)
            entry.nbytes = len(payload) + sum(int(getattr(b, "nbytes", len(b))) for b in buffers)
            self._used += entry.nbytes
            entry.ready.set()
            self._maybe_free_locked(obj_id, entry)

    def contains(self, obj_id: ObjectID) -> bool:
        with self._lock:
            e = self._entries.get(obj_id)
            return e is not None and e.ready.is_set()

    def serialized_get(self, obj_id: ObjectID, timeout: Optional[float] = None) -> tuple:
        """(payload, buffers), waiting up to ``timeout`` for the put."""
        with self._lock:
            entry = self._entries.get(obj_id)
            if entry is None:
                entry = self._entries[obj_id] = _Entry()  # a waiter's placeholder
        if not entry.ready.wait(timeout):
            raise GetTimeoutError(f"timed out waiting for {obj_id}")
        return entry.serialized

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
        if entry.ref_count <= 0 and entry.ready.is_set():
            self._used -= entry.nbytes
            self._entries.pop(obj_id, None)

    def stats(self) -> dict:
        with self._lock:
            return {
                "num_objects": len(self._entries),
                "used_bytes": self._used,
                "capacity_bytes": self._capacity,
            }
