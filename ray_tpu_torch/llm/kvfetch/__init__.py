"""Cross-engine KV resurrection and prefetch-at-admission (counterpart of
``ray_tpu/llm/kvfetch``).

 * the fetch plane (``plane.py``): a spilled ``SpilledBlock`` is a sealed
   ``KVHandoff``, so another same-weights engine can PULL it: in process
   (``LocalFetchClient``), over the device fabric (``DeviceFetchClient``)
   or over RPC frames (``RpcFetchClient`` / ``RpcFetchServer``);
 * prefetch-at-admission (``manager.KVFetchManager``): a bounded worker
   verifies, deserializes and fetches a queued request's prefix while it
   waits; the engine thread scatters it before the request's admission.

The async batched spill lives in ``kvtier/tiers.py``. Every fetched or
prefetched block re-verifies its seal and token ids before a page is
scattered: corrupt means a counted drop and a recompute, a dead source a
typed ``KVFetchError`` and a recompute.
"""

from ray_tpu_torch.llm.kvfetch.manager import KVFetchManager
from ray_tpu_torch.llm.kvfetch.plane import (
    DeviceFetchClient,
    FetchClient,
    KVFetchError,
    LocalFetchClient,
    LocalFetchRegistry,
    RpcFetchClient,
    RpcFetchServer,
    get_local_fetch_registry,
    make_fetch_client,
)

__all__ = [
    "KVFetchManager",
    "KVFetchError",
    "FetchClient",
    "LocalFetchClient",
    "DeviceFetchClient",
    "RpcFetchClient",
    "RpcFetchServer",
    "LocalFetchRegistry",
    "get_local_fetch_registry",
    "make_fetch_client",
]
