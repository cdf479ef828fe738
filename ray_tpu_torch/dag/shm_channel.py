"""Shared-memory channel: the cross-process data plane of compiled DAGs
(counterpart of ``ray_tpu/dag/shm_channel.py``).

A channel is a named ring of sealed objects in one ``ShmObjectStore``
mapping (the port's C++ store, ``native/shm.py``) that every participant
process opens:

  * the data slot of seq N: object id H(name|d|N), the serialized value;
  * the ack of reader R for seq N: an empty object H(name|a|N|R);
  * backpressure: before writing seq N the writer waits for every
    reader's ack of seq N-maxsize, then deletes that round's objects, so
    at most ``maxsize`` values are resident;
  * close: an out-of-band marker H(name|x) plus an in-stream sentinel;
    readers raise ChannelClosedError.

Values go through the port's pickler (``core/serialization.py``): a CUDA
tensor crosses by value through host memory and is rebuilt on the
reader's card. Readers poll with a short adaptive sleep. One host by
design; across hosts a compiled DAG uses ``socket_channel.py``.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import time
import uuid
from typing import Any, Optional

from ray_tpu_torch.core.serialization import dumps
from ray_tpu_torch.dag.channels import ChannelClosedError, chaos_channel_op

_CLOSE = b"__ray_tpu_torch_chan_closed__"
_DEFAULT_CAPACITY = 64 << 20


def _oid(name: str, kind: str, *parts) -> bytes:
    h = hashlib.md5(("%s|%s|%s" % (name, kind, "|".join(map(str, parts)))).encode())
    return h.digest()[:16]


class ShmChannel:
    """Single-writer, N-reader, bounded, named, cross-process."""

    def __init__(self, num_readers: int = 1, maxsize: int = 2,
                 name: Optional[str] = None, store_path: Optional[str] = None,
                 capacity: int = _DEFAULT_CAPACITY, _create: bool = True):
        if num_readers < 1:
            raise ValueError("channel needs at least one reader")
        self.name = name or uuid.uuid4().hex
        self.num_readers = num_readers
        self.maxsize = max(1, maxsize)
        from ray_tpu_torch.utils.shm import shm_dir

        self.store_path = store_path or os.path.join(
            shm_dir(), f"ray_tpu_torch-chan-{self.name[:16]}")
        self._capacity = capacity
        self._creator = False
        self._store = None
        self._write_seq = 0
        self._read_seq = [0] * num_readers
        if _create and not os.path.exists(self.store_path):
            from ray_tpu_torch.native.shm import ShmObjectStore

            self._store = ShmObjectStore.create(self.store_path, capacity)
            self._creator = True

    # -- plumbing -------------------------------------------------------------

    def _s(self):
        if self._store is None:
            from ray_tpu_torch.native.shm import ShmObjectStore

            deadline = time.monotonic() + 10.0
            while True:
                try:
                    self._store = ShmObjectStore.open(self.store_path)
                    break
                except OSError:
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(0.01)
        return self._store

    def __reduce__(self):
        return (_rebuild_shm_channel,
                (self.name, self.num_readers, self.maxsize, self.store_path,
                 self._capacity))

    def _wait_contains(self, oid: bytes, timeout: Optional[float]):
        """Park until `oid` exists. Pending data drains before the closed
        marker is honored (the marker is only consulted while waiting), so
        close() is an orderly drain-then-stop from ANY process — including
        ones that never wrote, which a seq-stream sentinel can't provide."""
        store = self._s()
        closed_oid = _oid(self.name, "x")
        deadline = None if timeout is None else time.monotonic() + timeout
        sleep = 0.0002
        while not store.contains(oid):
            if store.contains(closed_oid):
                raise ChannelClosedError("channel closed")
            if deadline is not None and time.monotonic() >= deadline:
                import queue as _q

                raise _q.Empty()
            time.sleep(sleep)
            sleep = min(sleep * 2, 0.002)

    # -- API (that of dag.channels.Channel) ------------------------------------

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        if chaos_channel_op("send", transport="shm"):
            return  # DROP_CHANNEL: lost in flight; readers' bounds surface it
        self._write_payload(dumps(value), timeout)

    def _write_payload(self, payload: bytes, timeout: Optional[float]) -> None:
        store = self._s()
        seq = self._write_seq
        # backpressure + GC: seq-maxsize must be fully consumed
        old = seq - self.maxsize
        if old >= 0:
            for r in range(self.num_readers):
                self._wait_contains(_oid(self.name, "a", old, r), timeout)
            store.delete(_oid(self.name, "d", old))
            for r in range(self.num_readers):
                store.delete(_oid(self.name, "a", old, r))
        store.put(_oid(self.name, "d", seq), payload)
        self._write_seq = seq + 1

    def read(self, reader_idx: int = 0, timeout: Optional[float] = None) -> Any:
        chaos_channel_op("recv", transport="shm")
        store = self._s()
        seq = self._read_seq[reader_idx]
        oid = _oid(self.name, "d", seq)
        self._wait_contains(oid, timeout)
        data = store.get_bytes(oid)
        if data is None:  # deleted between contains and get: already acked?
            raise ChannelClosedError("channel slot vanished")
        if data == _CLOSE:
            raise ChannelClosedError("channel closed")
        value = pickle.loads(data)
        store.put(_oid(self.name, "a", seq, reader_idx), b"")
        self._read_seq[reader_idx] = seq + 1
        return value

    def close(self) -> None:
        # out-of-band marker first: it unblocks read AND backpressure
        # waiters in every process regardless of whose write cursor this
        # handle holds
        try:
            self._s().put(_oid(self.name, "x"), b"")
        except Exception:  # noqa: BLE001 — already closed / store gone
            pass
        try:
            self._write_payload(_CLOSE, timeout=1.0)
        except Exception:  # noqa: BLE001 — best-effort in-stream sentinel
            pass

    def unlink(self) -> None:
        """Creator-side teardown of the backing mapping."""
        if self._store is not None:
            try:
                self._store.close()
            except Exception:  # noqa: BLE001
                pass
            self._store = None
        if self._creator:
            try:
                os.unlink(self.store_path)
            except OSError:
                pass


def _rebuild_shm_channel(name, num_readers, maxsize, store_path, capacity):
    ch = ShmChannel(num_readers=num_readers, maxsize=maxsize, name=name,
                    store_path=store_path, capacity=capacity, _create=False)
    return ch
