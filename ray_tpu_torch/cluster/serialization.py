"""Cluster value serialization: the port's pickler plus persistent-id
object refs (counterpart of ``ray_tpu/cluster/serialization.py``).

Reference analog: python/ray/_private/serialization.py
(SerializationContext) — object refs embedded anywhere in a value travel
as persistent ids and are re-materialized through the deserializer's
resolver (the daemon fetch path), so values never need the refs inlined
at submission time.

The reference builds these pickles with ``cloudpickle``; the port runs on
its own stdlib pickler (``core/serialization.py``), which the card's host
is sure to have: what cannot be imported goes by value, and a CUDA tensor
crosses by value through host memory and is rebuilt on the receiver's own
card (a receiver that sees no card raises ``TypeError``).
"""

from __future__ import annotations

import io
import pickle
from typing import Any

from ray_tpu_torch.core.serialization import Pickler


class _ErrorValue:
    """Stored under a return id when a task failed; get() re-raises."""

    def __init__(self, exc: BaseException, tb: str, task_desc: str):
        self.exc = exc
        self.tb = tb
        self.task_desc = task_desc


def dumps_value(value: Any, collect_refs=None) -> bytes:
    """Pickle a value, turning embedded cluster refs into persistent ids.

    ``collect_refs(object_id)`` is called for every embedded ref — the
    submit path uses it to pin argument objects until the task finishes
    (a slim slice of the reference's ReferenceCounter "submitted task
    references", reference_count.h:66)."""
    from ray_tpu_torch.cluster.client import ClusterObjectRef

    buf = io.BytesIO()

    class _P(Pickler):
        def persistent_id(self, o):
            if isinstance(o, ClusterObjectRef):
                if collect_refs is not None:
                    collect_refs(o.id)
                return ("objref", o.id)
            return None

    _P(buf, protocol=5).dump(value)
    return buf.getvalue()


def loads_value(data: bytes, resolver) -> Any:
    """Unpickle, materializing ("objref", id) through ``resolver(id)``."""

    class _U(pickle.Unpickler):
        def persistent_load(self, pid):
            kind, oid = pid
            if kind == "objref":
                return resolver(oid)
            raise pickle.UnpicklingError(f"unknown pid {kind!r}")

    return _U(io.BytesIO(data)).load()
