"""KV fetch plane: cross-engine resurrection transport (counterpart of
``ray_tpu/llm/kvfetch/plane.py``).

A ``SpilledBlock`` (a CRC-sealed ``KVHandoff``) can be PULLED from another
same-weights engine's tiers over one of three backends:

 * ``LocalFetchClient`` — a direct registry call inside one process (the
   engines of one orchestrator).
 * ``DeviceFetchClient`` — the pages ride the fabric's transfer plane
   (``fabric.transport.DeviceTransport``): the source's blocks are sent as
   one device-tensor bundle to this client's endpoint, then staged back to
   host pages for the requester's host tier; which blocks rides the
   in-process registry.
 * ``RpcFetchClient`` / ``RpcFetchServer`` — the fallback across hosts: a
   ``kv_fetch`` route over ``cluster/rpc.py`` frames, the pickled block set
   split into sequence-numbered ``kv_fetch_chunk`` pulls under the frame
   budget, the whole pull bounded by one deadline.

Integrity is the requester's job: each fetched block re-verifies its seal
and token ids (``KVTierManager.verify_block``) before a page is scattered;
a corrupt fetch is a counted drop and a recompute. A dead source is a
typed ``KVFetchError``. The source side passes the ``llm.kvfetch`` chaos
site (``KVTierManager.serve_fetch``).
"""

from __future__ import annotations

import dataclasses
import pickle
import threading
import time
import uuid
import zlib
from typing import Any, Optional

import torch


class KVFetchError(Exception):
    """A cross-engine block fetch was dropped, timed out, or the source
    is gone. The requester's answer is always the same: serve what the
    LOCAL tiers hold and recompute the rest — never hang, never guess."""


# ---------------------------------------------------------------------------
# source registry (in-process control plane)
# ---------------------------------------------------------------------------

# process-global, namespaced like the in-process KV connector's queues:
# serve replicas and a same-process orchestrator meet on one registry,
# two apps never cross-resolve each other's engine keys
_REGISTRY_LOCK = threading.Lock()
_REGISTRIES: dict[str, "LocalFetchRegistry"] = {}


class LocalFetchRegistry:
    """engine_key -> fetch source (a ``KVTierManager``); the in-process
    face of the fetch plane's control side."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sources: dict[str, Any] = {}

    def register(self, engine_key: str, source: Any) -> None:
        with self._lock:
            self._sources[engine_key] = source

    def unregister(self, engine_key: str) -> None:
        with self._lock:
            self._sources.pop(engine_key, None)

    def get(self, engine_key: str) -> Any:
        with self._lock:
            src = self._sources.get(engine_key)
        if src is None:
            raise KVFetchError(
                f"no fetch source registered for engine {engine_key!r}"
            )
        return src


def get_local_fetch_registry(namespace: str) -> LocalFetchRegistry:
    with _REGISTRY_LOCK:
        reg = _REGISTRIES.get(namespace)
        if reg is None:
            reg = _REGISTRIES[namespace] = LocalFetchRegistry()
        return reg


# ---------------------------------------------------------------------------
# clients
# ---------------------------------------------------------------------------


class FetchClient:
    """Backend interface. ``fetch`` returns a list parallel to
    ``hashes``: a verified-shippable SpilledBlock per hash, or None for
    a hash the source no longer holds (the requester stops its chain
    walk there). Raises ``KVFetchError`` on transport-level loss —
    bounded by ``timeout_s`` in every backend."""

    name = "base"

    def __init__(self):
        self.num_fetches = 0
        self.num_blocks = 0
        self.num_failures = 0
        self.bytes_fetched = 0

    def fetch(self, engine_key: str, addr: Any, hashes: list,
              tokens_list: list, timeout_s: float = 5.0) -> list:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def stats(self) -> dict:
        return {
            "backend": self.name,
            "num_fetches": self.num_fetches,
            "num_blocks": self.num_blocks,
            "num_failures": self.num_failures,
            "bytes_fetched": self.bytes_fetched,
        }

    def _count(self, blocks: list) -> list:
        self.num_fetches += 1
        got = [b for b in blocks if b is not None]
        self.num_blocks += len(got)
        nbytes = sum(int(b.nbytes) for b in got)
        self.bytes_fetched += nbytes
        try:
            from ray_tpu_torch.llm.kvfetch import metrics as kvfetch_metrics

            kvfetch_metrics.fetch_bytes_counter().inc(
                nbytes, tags={"backend": self.name}
            )
        except Exception:  # noqa: BLE001 — observability never breaks a fetch
            pass
        return blocks


class LocalFetchClient(FetchClient):
    """Direct in-process pull through the shared registry."""

    name = "local"

    def __init__(self, registry: LocalFetchRegistry):
        super().__init__()
        self.registry = registry

    def fetch(self, engine_key: str, addr: Any, hashes: list,
              tokens_list: list, timeout_s: float = 5.0) -> list:
        src = self.registry.get(engine_key)
        try:
            blocks = src.serve_fetch(hashes, tokens_list)
        except KVFetchError:
            self.num_failures += 1
            raise
        return self._count(blocks)


class DeviceFetchClient(FetchClient):
    """The pages ride the fabric's transfer plane: the source's blocks are
    sent as one device-tensor bundle to THIS client's endpoint (moved onto
    the endpoint's device), then staged back to CPU pages for the host tier
    (the scatter into HBM happens at admission or at the prefetch tick).
    Which blocks: the in-process registry."""

    name = "device"

    def __init__(self, registry: LocalFetchRegistry, transport: Any = None,
                 endpoint_id: Optional[str] = None, namespace: str = "kvfetch"):
        super().__init__()
        from ray_tpu_torch.fabric.transport import DeviceTransport

        self.registry = registry
        self.transport = transport or DeviceTransport(namespace=namespace)
        self.endpoint_id = endpoint_id or f"kvfetch-{uuid.uuid4().hex[:8]}"
        self._target = self.transport.register_endpoint(self.endpoint_id)
        self._lock = threading.Lock()  # one fetch in flight per client

    def fetch(self, engine_key: str, addr: Any, hashes: list,
              tokens_list: list, timeout_s: float = 5.0) -> list:
        from ray_tpu_torch.fabric.transport import FabricTransferError
        from ray_tpu_torch.llm.kvtier.tiers import SpilledBlock

        src = self.registry.get(engine_key)
        xfer = uuid.uuid4().hex
        deadline = time.monotonic() + timeout_s
        with self._lock:
            try:
                blocks = src.serve_fetch(hashes, tokens_list)
            except KVFetchError:
                self.num_failures += 1
                raise
            arrays, rows = {}, []
            for i, sb in enumerate(blocks):
                if sb is None:
                    rows.append(None)
                    continue
                arrays[f"k{i}"] = sb.handoff.k_pages
                arrays[f"v{i}"] = sb.handoff.v_pages
                rows.append({
                    "i": i,
                    "header": dataclasses.replace(sb.handoff, k_pages=torch.empty(0),
                                                  v_pages=torch.empty(0)),
                    "parent_hash": sb.parent_hash,
                    "n_prefix_tokens": sb.n_prefix_tokens,
                })
            try:
                self.transport.send_arrays(self._target, arrays, meta={"xfer": xfer, "rows": rows},
                                           timeout_s=timeout_s, bundle_id=f"kvfetch-{xfer[:8]}",
                                           seal=False)
            except FabricTransferError as e:
                self.num_failures += 1
                raise KVFetchError(f"device fetch dropped: {e}") from e
            # drain until OUR bundle arrives: one left by an earlier fetch
            # that timed out is discarded, never taken for this one
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self.num_failures += 1
                    raise KVFetchError(f"device fetch from {engine_key!r} exceeded {timeout_s}s")
                b = self.transport.recv_arrays(self.endpoint_id, timeout_s=max(0.001, remaining))
                if b is not None and b.meta.get("xfer") == xfer:
                    break
        out: list = [None] * len(hashes)
        for row in b.meta["rows"]:
            if row is None:
                continue
            i = row["i"]
            # back to CPU pages: the destination is the requester's host tier
            h = dataclasses.replace(row["header"], k_pages=b.arrays[f"k{i}"].cpu(),
                                    v_pages=b.arrays[f"v{i}"].cpu())
            out[i] = SpilledBlock(handoff=h, parent_hash=row["parent_hash"],
                                  n_prefix_tokens=row["n_prefix_tokens"])
        return self._count(out)

    def close(self) -> None:
        self.transport.close()


# envelope headroom per chunk frame (the RpcKVConnector's margin)
CHUNK_MARGIN = 4096


class RpcFetchServer:
    """One ``kv_fetch`` route serving every registered local source.

    ``kv_fetch`` pickles the block set and returns the first chunk inline
    ({"xfer", "total", "crc", "data"}); the client pulls the rest with
    ``kv_fetch_chunk`` ({"xfer", "seq"}). A prepared blob past its deadline
    is dropped, so a client that died mid-pull strands no server memory."""

    def __init__(self, host: str = "127.0.0.1", max_frame_bytes: Optional[int] = None):
        from ray_tpu_torch.cluster.rpc import MAX_FRAME

        # chunks well under the protocol's ceiling: a multi-MB block set
        # becomes more pulls, never a frame-size failure
        self.max_frame_bytes = int(max_frame_bytes or min(MAX_FRAME, 8 << 20))
        if self.max_frame_bytes <= CHUNK_MARGIN:
            raise ValueError(f"max_frame_bytes must exceed {CHUNK_MARGIN}, "
                             f"got {self.max_frame_bytes}")
        self._host = host
        self._lock = threading.Lock()
        self._sources: dict[str, Any] = {}
        self._blobs: dict[str, dict] = {}  # xfer -> {chunks, deadline}
        self._server = None

    def register_source(self, engine_key: str, source: Any) -> tuple:
        """Register a KVTierManager under ``engine_key``; returns this
        server's (host, port), the engine's ``fetch_addr`` in the index."""
        srv = self._ensure_server()
        with self._lock:
            self._sources[engine_key] = source
        return srv.address

    def _ensure_server(self):
        from ray_tpu_torch.cluster.rpc import RpcServer

        with self._lock:
            if self._server is None:
                srv = RpcServer(host=self._host)
                srv.route("kv_fetch", self._on_fetch)
                srv.route("kv_fetch_chunk", self._on_chunk)
                srv.start()
                self._server = srv
            return self._server

    @property
    def address(self) -> tuple:
        return self._ensure_server().address

    def _on_fetch(self, payload, peer):
        engine_key = payload["engine"]
        with self._lock:
            src = self._sources.get(engine_key)
            now = time.time()
            for xid in [x for x, rec in self._blobs.items() if rec["deadline"] < now]:
                del self._blobs[xid]
        if src is None:
            raise KVFetchError(f"no fetch source {engine_key!r} here")
        # serve_fetch holds the llm.kvfetch chaos gate (a DROP raises out of
        # this handler: RemoteError, a typed KVFetchError at the client);
        # called outside the lock, since it may wait for a pending spill
        blocks = src.serve_fetch(payload["hashes"], [tuple(t) for t in payload["tokens"]])
        blob = pickle.dumps(blocks, protocol=5)
        crc = zlib.crc32(blob) & 0xFFFFFFFF
        cap = self.max_frame_bytes - CHUNK_MARGIN
        chunks = [blob[i:i + cap] for i in range(0, len(blob), cap)] or [b""]
        xfer = uuid.uuid4().hex
        if len(chunks) > 1:
            with self._lock:
                self._blobs[xfer] = {"chunks": chunks,
                                     "deadline": time.time() + float(payload.get("ttl_s", 60.0))}
        return {"xfer": xfer, "total": len(chunks), "crc": crc, "data": chunks[0]}

    def _on_chunk(self, payload, peer):
        with self._lock:
            rec = self._blobs.get(payload["xfer"])
            if rec is None:
                raise KVFetchError(f"fetch transfer {payload['xfer']!r} unknown or expired")
            rec["deadline"] = time.time() + 60.0
            seq = int(payload["seq"])
            data = rec["chunks"][seq]
            if seq == len(rec["chunks"]) - 1:
                del self._blobs[payload["xfer"]]
        return {"data": data}

    def stop(self) -> None:
        with self._lock:
            srv, self._server = self._server, None
            self._blobs.clear()
        if srv is not None:
            srv.stop()


class RpcFetchClient(FetchClient):
    """Pull blocks from a remote ``RpcFetchServer``: one ``kv_fetch`` call and
    sequence-numbered ``kv_fetch_chunk`` pulls, the WHOLE transfer bounded
    by one monotonic deadline (a peer answering each pull just under a
    per-call bound cannot hold the prefetch worker for N * timeout). A dead
    source is a typed, bounded ``KVFetchError``."""

    name = "rpc"

    def __init__(self, timeout_s: float = 5.0):
        super().__init__()
        from ray_tpu_torch.cluster.rpc import ClientPool

        self._pool = ClientPool(timeout=timeout_s)

    def fetch(self, engine_key: str, addr: Any, hashes: list,
              tokens_list: list, timeout_s: float = 5.0) -> list:
        from ray_tpu_torch.cluster.rpc import RemoteError, RpcError

        if not (isinstance(addr, (tuple, list)) and len(addr) == 2):
            self.num_failures += 1
            raise KVFetchError(f"engine {engine_key!r} published no usable fetch_addr ({addr!r})")
        host, port = addr
        deadline = time.monotonic() + timeout_s
        try:
            client = self._pool.get((host, int(port)))
            got = client.call("kv_fetch", {"engine": engine_key, "hashes": list(hashes),
                                           "tokens": [list(t) for t in tokens_list],
                                           "ttl_s": timeout_s}, timeout=timeout_s)
            parts = [got["data"]]
            for seq in range(1, got["total"]):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise KVFetchError(f"fetch from {engine_key!r} exceeded {timeout_s}s "
                                       f"after {seq}/{got['total']} chunks")
                parts.append(client.call("kv_fetch_chunk", {"xfer": got["xfer"], "seq": seq},
                                         timeout=remaining)["data"])
        except (RpcError, RemoteError, OSError) as e:
            self.num_failures += 1
            raise KVFetchError(f"fetch from {engine_key!r} at {host}:{port} failed: {e}") from e
        blob = b"".join(parts)
        if (zlib.crc32(blob) & 0xFFFFFFFF) != got["crc"]:
            self.num_failures += 1
            raise KVFetchError(f"fetch from {engine_key!r} failed its blob CRC "
                               f"({got['total']} chunks): torn in flight")
        return self._count(pickle.loads(blob))

    def close(self) -> None:
        self._pool.close_all()


def make_fetch_client(kind: str, **kwargs) -> FetchClient:
    if kind == "local":
        return LocalFetchClient(**kwargs)
    if kind == "device":
        return DeviceFetchClient(**kwargs)
    if kind == "rpc":
        return RpcFetchClient(**kwargs)
    raise ValueError(f"unknown fetch backend {kind!r}; one of: local, device, rpc")
