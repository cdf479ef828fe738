"""KVConnector: the transfer plane for prefill -> decode KV handoffs
(counterpart of ``ray_tpu/llm/disagg/connector.py``).

``InProcessConnector`` hands a handoff over a queue inside one process
(tests, one host serving both pools): the object crosses by reference,
and integrity still goes through the handoff's checksum where it arrives.
Its queues are process-global and namespaced, so two orchestrators never
cross-deliver.

Every send passes the ``disagg.kv_transfer`` chaos hook (``_chaos_gate``):
DROP_KV_TRANSFER raises KVTransferError (counted in ``num_dropped``),
CORRUPT_KV_TRANSFER flips bytes of the pages in flight (the receiver's
checksum catches it), DELAY_RPC sleeps.

Not ported: the cluster-RPC backend (``"rpc"``: the port has no cluster
RPC, ROADMAP.md Queue 1, C5/B8) and the device fabric (``"device"``, C1).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Optional

import torch

from ray_tpu_torch.chaos import harness as _chaos
from ray_tpu_torch.llm.disagg.handoff import KVHandoff


class KVTransferError(Exception):
    """A handoff was dropped, timed out, or arrived corrupt. The
    orchestrator's answer is always the same: re-prefill elsewhere."""


def _corrupt_handoff(handoff: KVHandoff) -> KVHandoff:
    """A deterministic bit-flip of a copy of the K pages (a span of bytes in
    their middle), the checksum NOT re-sealed: the receiver's ``verify()``
    fails as for a torn wire. The chaos gate applies it."""
    k = handoff.k_pages.clone()
    flat = k.reshape(-1).view(torch.uint8)
    if flat.numel():
        mid = flat.numel() // 2
        span = max(1, min(16, flat.numel() - mid))
        flat[mid : mid + span] ^= 0xFF
    return dataclasses.replace(handoff, k_pages=k)


class KVConnector:
    """The transfer-plane interface: register a target, send to it, poll it."""

    name = "base"

    def __init__(self):
        self.num_sent = 0
        self.num_received = 0
        self.num_dropped = 0
        self.bytes_sent = 0
        # senders and several decode loops count at once
        self._count_lock = threading.Lock()

    def _count(self, **deltas) -> None:
        with self._count_lock:
            for name, n in deltas.items():
                setattr(self, name, getattr(self, name) + n)

    def register_target(self, target_id: str) -> Any:
        """Create the receive side for ``target_id``; returns the opaque
        target token ``send`` addresses it by."""
        raise NotImplementedError

    def send(self, target: Any, handoff: KVHandoff, timeout_s: float = 30.0) -> None:
        raise NotImplementedError

    def recv(self, target_id: str, timeout_s: float = 0.1) -> Optional[KVHandoff]:
        """Bounded receive; None when nothing arrived within the timeout
        (callers poll: a transfer plane never parks a decode loop)."""
        raise NotImplementedError

    def close(self) -> None:
        pass

    def stats(self) -> dict:
        return {
            "connector": self.name,
            "num_sent": self.num_sent,
            "num_received": self.num_received,
            "num_dropped": self.num_dropped,
            "bytes_sent": self.bytes_sent,
        }

    def _chaos_gate(self, handoff: KVHandoff, target_label: str) -> KVHandoff:
        """The ``disagg.kv_transfer`` chaos hook, applied on every send."""
        if _chaos.ACTIVE is None:
            return handoff
        for f in _chaos.fire(
            "disagg.kv_transfer",
            kinds=(_chaos.DROP_KV_TRANSFER, _chaos.CORRUPT_KV_TRANSFER, _chaos.DELAY_RPC),
            request_id=handoff.request_id, connector=self.name, target=target_label,
        ):
            if f.kind == _chaos.DROP_KV_TRANSFER:
                self._count(num_dropped=1)
                raise KVTransferError(
                    f"chaos: dropped KV transfer of {handoff.request_id!r} to {target_label}"
                )
            if f.kind == _chaos.DELAY_RPC:
                time.sleep(f.delay_s)
            if f.kind == _chaos.CORRUPT_KV_TRANSFER:
                handoff = _corrupt_handoff(handoff)
        return handoff


_INPROC_LOCK = threading.Lock()
_INPROC_QUEUES: dict[tuple, "queue.Queue[KVHandoff]"] = {}


class InProcessConnector(KVConnector):
    name = "inproc"

    def __init__(self, namespace: str = "default"):
        super().__init__()
        self.namespace = namespace
        self._targets: set = set()

    def register_target(self, target_id: str) -> str:
        with _INPROC_LOCK:
            _INPROC_QUEUES.setdefault((self.namespace, target_id), queue.Queue())
        self._targets.add(target_id)
        return target_id

    def _queue(self, target_id: str) -> "queue.Queue[KVHandoff]":
        with _INPROC_LOCK:
            q = _INPROC_QUEUES.get((self.namespace, target_id))
        if q is None:
            raise KVTransferError(
                f"unknown KV target {target_id!r} in namespace {self.namespace!r} "
                "(register_target first)"
            )
        return q

    def send(self, target: str, handoff: KVHandoff, timeout_s: float = 30.0) -> None:
        handoff = self._chaos_gate(handoff, target)
        self._queue(target).put(handoff)
        self._count(num_sent=1, bytes_sent=handoff.nbytes)

    def recv(self, target_id: str, timeout_s: float = 0.1) -> Optional[KVHandoff]:
        try:
            h = self._queue(target_id).get(timeout=timeout_s)
        except queue.Empty:
            return None
        self._count(num_received=1)
        return h

    def close(self) -> None:
        with _INPROC_LOCK:
            for tid in self._targets:
                _INPROC_QUEUES.pop((self.namespace, tid), None)
        self._targets.clear()


def make_connector(kind: str, **kwargs) -> KVConnector:
    if kind in ("inproc", "in_process", "inprocess"):
        return InProcessConnector(**kwargs)
    if kind == "rpc":
        raise NotImplementedError(
            "the cluster-RPC KV connector is not ported to ray_tpu_torch: the port has no "
            "cluster RPC yet (ROADMAP.md, Queue 1, C5/B8)"
        )
    if kind == "device":
        raise NotImplementedError(
            "the device-fabric KV connector is not ported to ray_tpu_torch yet "
            "(ROADMAP.md, Queue 1, C1)"
        )
    raise ValueError(f"unknown KV connector {kind!r}; one of: inproc, rpc, device")
