"""KV fetch plane: cross-engine resurrection transport (counterpart of
``ray_tpu/llm/kvfetch/plane.py``).

A ``SpilledBlock`` (a CRC-sealed ``KVHandoff``) can be PULLED from another
same-weights engine's tiers:

 * ``LocalFetchClient`` — a direct registry call inside one process (the
   engines of one orchestrator), the backend the port has.
 * ``DeviceFetchClient`` — pages over the device fabric: waits for the
   fabric (ROADMAP.md Queue 1, C1).
 * ``RpcFetchClient`` / ``RpcFetchServer`` — the chunked ``kv_fetch`` RPC
   route across hosts: waits for the cluster runtime (C5/B8).

Integrity is the requester's job: each fetched block re-verifies its seal
and token ids (``KVTierManager.verify_block``) before a page is scattered;
a corrupt fetch is a counted drop and a recompute. A dead source is a
typed ``KVFetchError``. The source side passes the ``llm.kvfetch`` chaos
site (``KVTierManager.serve_fetch``).
"""

from __future__ import annotations

import threading
from typing import Any

_C1 = ("the device fetch client (pages over the device fabric) is not ported to "
       "ray_tpu_torch yet (ROADMAP.md, Queue 1, C1)")
_C5 = ("the RPC fetch plane is not ported to ray_tpu_torch yet (the cluster runtime, "
       "ROADMAP.md, Queue 1, C5/B8)")


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
    """Pages over the device fabric's transfer plane: not ported."""

    name = "device"

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"DeviceFetchClient: {_C1}")


class RpcFetchServer:
    """The ``kv_fetch`` RPC route serving local sources: not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"RpcFetchServer: {_C5}")


class RpcFetchClient(FetchClient):
    """Pulls over the ``kv_fetch`` RPC route: not ported."""

    name = "rpc"

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"RpcFetchClient: {_C5}")


def make_fetch_client(kind: str, **kwargs) -> FetchClient:
    """``local`` (in-process); ``device`` and ``rpc`` raise naming their
    ROADMAP item."""
    if kind == "local":
        return LocalFetchClient(**kwargs)
    if kind == "device":
        return DeviceFetchClient(**kwargs)
    if kind == "rpc":
        return RpcFetchClient(**kwargs)
    raise ValueError(f"unknown fetch backend {kind!r}; one of: local, device, rpc")
