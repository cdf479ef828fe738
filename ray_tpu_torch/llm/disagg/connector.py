"""KVConnector: the transfer plane for prefill -> decode KV handoffs
(counterpart of ``ray_tpu/llm/disagg/connector.py``). Three backends:

 * ``InProcessConnector`` hands a handoff over a queue inside one process
   (tests, one host serving both pools): the object crosses by reference,
   and integrity still goes through the handoff's checksum where it
   arrives. Its queues are process-global and namespaced, so two
   orchestrators never cross-deliver.
 * ``RpcKVConnector`` ships it over ``cluster/rpc.py``'s length-prefixed
   frames: each decode target is a queue behind one ``kv_put_chunk`` route
   of a shared server; sends go through a ``ClientPool`` with the transfer
   timeout bounding the whole transfer, so a stalled decode host fails the
   transfer (a re-prefill) instead of wedging the sender. A large handoff
   becomes more frames, never a failure.
 * ``fabric.device_connector.DeviceKVConnector`` moves the pages as device
   tensors (``ray_tpu_torch/fabric``), with the same failure modes.

Every host-path send passes the ``disagg.kv_transfer`` chaos hook
(``_chaos_gate``): DROP_KV_TRANSFER raises KVTransferError (counted in
``num_dropped``), CORRUPT_KV_TRANSFER flips bytes of the pages in flight
(the receiver's checksum catches it), DELAY_RPC sleeps.
"""

from __future__ import annotations

import dataclasses
import pickle
import queue
import threading
import time
import uuid
import zlib
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


# envelope headroom per chunk frame: the pickled RPC tuple around the raw
# chunk bytes (method name, target and transfer ids, sequence numbers, the
# CRC, the length prefix) is under 300 bytes; 4 KiB keeps every chunk
# frame strictly under the connector's frame budget
CHUNK_MARGIN = 4096


class RpcKVConnector(KVConnector):
    """KV transfer over ``cluster/rpc.py`` frames.

    One instance plays both sides: ``register_target`` starts one local
    RpcServer (shared by its targets) that routes ``kv_put_chunk`` frames
    into per-target queues; ``send`` dials the peer's (host, port) through
    a ClientPool.

    A handoff is pickled (protocol 5: its pages are CPU tensors, so
    ``handoff.to_host()`` first) and split into sequence-numbered chunks
    under ``max_frame_bytes`` (default the protocol's MAX_FRAME), joined on
    the receiving side and CRC-checked over the whole blob before it is
    unpickled. A torn multi-frame send (the sender gave up mid-transfer) is
    dropped after its deadline, and the orchestrator re-prefills as for a
    lost single frame.
    """

    name = "rpc"

    def __init__(self, host: str = "127.0.0.1", timeout_s: float = 30.0,
                 max_frame_bytes: Optional[int] = None):
        super().__init__()
        from ray_tpu_torch.cluster.rpc import MAX_FRAME, ClientPool

        self._host = host
        self._timeout = timeout_s
        self.max_frame_bytes = int(max_frame_bytes or MAX_FRAME)
        if self.max_frame_bytes <= CHUNK_MARGIN:
            raise ValueError(f"max_frame_bytes must exceed {CHUNK_MARGIN} (envelope headroom), "
                             f"got {self.max_frame_bytes}")
        self._pool = ClientPool(timeout=timeout_s)
        self._server = None
        self._queues: dict[str, "queue.Queue[KVHandoff]"] = {}
        # multi-frame transfers being joined: xfer id -> {target, total,
        # parts: {seq: bytes}, crc, deadline}
        self._partial: dict[str, dict] = {}
        self._lock = threading.Lock()

    def _ensure_server(self):
        from ray_tpu_torch.cluster.rpc import RpcServer

        with self._lock:
            if self._server is None:
                srv = RpcServer(host=self._host)
                srv.route("kv_put_chunk", self._on_kv_chunk)
                srv.start()
                self._server = srv
            return self._server

    def _on_kv_chunk(self, payload, peer):
        """One sequence-numbered chunk of a pickled handoff. The last one to
        arrive joins the blob, checks its CRC, unpickles and delivers it;
        what is mid-transfer is bounded by the deadline GC."""
        target_id = payload["target"]
        xfer = payload["xfer"]
        with self._lock:
            q = self._queues.get(target_id)
            if q is None:
                raise KVTransferError(f"no such KV target {target_id!r} here")
            now = time.time()
            # drop torn transfers whose sender gave up (and re-prefilled)
            for xid in [x for x, rec in self._partial.items() if rec["deadline"] < now]:
                del self._partial[xid]
            rec = self._partial.setdefault(xfer, {
                "target": target_id, "total": int(payload["total"]), "parts": {},
                "crc": int(payload["crc"]),
            })
            # the deadline moves on EVERY chunk: a live sender (each call of
            # which is bounded by ttl_s) may stream N chunks in N * ttl_s;
            # only a sender silent past ttl_s (whose call timed out, so it
            # re-prefilled already) loses the partial
            rec["deadline"] = now + float(payload.get("ttl_s", 60.0))
            rec["parts"][int(payload["seq"])] = payload["data"]
            done = len(rec["parts"]) == rec["total"]
            if done:
                del self._partial[xfer]
        if not done:
            return {"ok": True, "have": int(payload["seq"]) + 1}
        blob = b"".join(rec["parts"][i] for i in range(rec["total"]))
        if (zlib.crc32(blob) & 0xFFFFFFFF) != rec["crc"]:
            raise KVTransferError(f"reassembled KV transfer {xfer!r} failed its blob CRC "
                                  f"({rec['total']} chunks): torn in flight")
        q.put(pickle.loads(blob))
        return {"ok": True, "delivered": True}

    def register_target(self, target_id: str) -> tuple:
        srv = self._ensure_server()
        with self._lock:
            self._queues.setdefault(target_id, queue.Queue())
        host, port = srv.address
        return (host, port, target_id)

    def send(self, target: tuple, handoff: KVHandoff, timeout_s: Optional[float] = None) -> None:
        from ray_tpu_torch.cluster.rpc import RemoteError, RpcError

        host, port, target_id = target
        handoff = self._chaos_gate(handoff, f"{host}:{port}/{target_id}")
        timeout = timeout_s if timeout_s is not None else self._timeout
        blob = pickle.dumps(handoff, protocol=5)
        crc = zlib.crc32(blob) & 0xFFFFFFFF
        cap = self.max_frame_bytes - CHUNK_MARGIN
        chunks = [blob[i:i + cap] for i in range(0, len(blob), cap)] or [b""]
        xfer = f"{handoff.request_id}-{uuid.uuid4().hex[:8]}"
        # the timeout bounds the WHOLE transfer, not each chunk: a peer that
        # answers every chunk just under a per-call bound would otherwise
        # hold the sender for N * timeout, the re-prefill budget unconsulted
        deadline = time.monotonic() + timeout
        try:
            client = self._pool.get((host, port))
            for seq, data in enumerate(chunks):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise KVTransferError(
                        f"KV transfer of {handoff.request_id!r} to {host}:{port}/{target_id} "
                        f"exceeded {timeout}s after {seq}/{len(chunks)} chunks"
                    )
                client.call("kv_put_chunk",
                            {"target": target_id, "xfer": xfer, "seq": seq, "total": len(chunks),
                             "crc": crc, "data": data, "ttl_s": timeout},
                            timeout=remaining)
        except (RpcError, RemoteError) as e:
            # the frames may or may not have landed (the receiver drops a
            # torn set); the orchestrator's re-prefill is idempotent
            # (delivery watermarks), so at-most-once is the failure mode
            raise KVTransferError(
                f"KV transfer of {handoff.request_id!r} to {host}:{port}/{target_id} failed "
                f"({len(chunks)} chunks): {e}"
            ) from e
        self._count(num_sent=1, bytes_sent=handoff.nbytes)

    def recv(self, target_id: str, timeout_s: float = 0.1) -> Optional[KVHandoff]:
        with self._lock:
            q = self._queues.get(target_id)
        if q is None:
            raise KVTransferError(f"target {target_id!r} not registered here")
        try:
            h = q.get(timeout=timeout_s)
        except queue.Empty:
            return None
        self._count(num_received=1)
        return h

    def close(self) -> None:
        self._pool.close_all()
        with self._lock:
            srv, self._server = self._server, None
            self._queues.clear()
            self._partial.clear()
        if srv is not None:
            srv.stop()


def make_connector(kind: str, **kwargs) -> KVConnector:
    if kind in ("inproc", "in_process", "inprocess"):
        return InProcessConnector(**kwargs)
    if kind == "rpc":
        return RpcKVConnector(**kwargs)
    if kind == "device":
        # deferred: ray_tpu_torch.fabric builds on this interface
        from ray_tpu_torch.fabric.device_connector import DeviceKVConnector

        return DeviceKVConnector(**kwargs)
    raise ValueError(f"unknown KV connector {kind!r}; one of: inproc, rpc, device")
