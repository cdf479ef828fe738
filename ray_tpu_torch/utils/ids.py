"""Unique identifiers for framework entities (counterpart of
``ray_tpu/utils/ids.py``).

Flat random 128-bit ids with a type tag (task, object, actor, node, job,
worker, placement group). Object ids embed the owner task id and the
return index, so ownership is derived without a lookup (upstream Ray's
``ObjectID::FromIndex`` scheme, src/ray/common/id.h).
"""

from __future__ import annotations

import os
import threading

_ID_NBYTES = 16


class BaseID:
    """Immutable random identifier. Subclasses carry the entity type."""

    __slots__ = ("_bytes", "_hash", "_repr")

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != _ID_NBYTES:
            raise ValueError(f"expected {_ID_NBYTES} bytes, got {len(id_bytes)}")
        self._bytes = id_bytes
        self._hash = None
        self._repr = None

    @classmethod
    def from_random(cls):
        return cls(os.urandom(_ID_NBYTES))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * _ID_NBYTES)

    @classmethod
    def from_hex(cls, s: str):
        return cls(bytes.fromhex(s))

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * _ID_NBYTES

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        # cached: ids key every hot-path dict (object store, event table)
        h = self._hash
        if h is None:
            h = self._hash = hash((type(self).__name__, self._bytes))
        return h

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __repr__(self):
        r = self._repr
        if r is None:
            r = self._repr = f"{type(self).__name__}({self.hex()[:12]})"
        return r


class JobID(BaseID):
    pass


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class TaskID(BaseID):
    pass


class ActorID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass


class ObjectID(BaseID):
    """Object ids embed owner task id (first 12 bytes) + return index."""

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary()[:12] + index.to_bytes(4, "little"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # Put objects use the high bit of the index to avoid collision
        # with task returns.
        return cls(task_id.binary()[:12] + (put_index | 0x80000000).to_bytes(4, "little"))

    def task_prefix(self) -> bytes:
        return self._bytes[:12]

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[12:], "little") & 0x7FFFFFFF


class _Counter:
    """Thread-safe monotonically increasing counter."""

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value
