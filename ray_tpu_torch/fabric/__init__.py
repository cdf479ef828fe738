"""ray_tpu_torch.fabric: the device-direct tensor transfer plane and the
pool topology (counterpart of ``ray_tpu/fabric``).

 * **transport**: ``send_arrays`` / ``recv_arrays``: named device tensors
   move between registered device endpoints by ``tensor.to(device)`` (by
   reference on one card), sealed with a checksum reduced on the device,
   so pages never cross to the host for integrity.
 * **device_connector**: ``DeviceKVConnector``, the third ``KVConnector``
   backend: prefill -> decode KV handoffs as device-tensor bundles, with
   the host-path connectors' checksum and timeout failure modes.
 * **topology / pool**: role-tagged pools pinned to slices, which pool
   pairs share a device mesh, and per-edge transport selection (device
   where meshes are shared, RPC elsewhere, a fault degrades the edge to
   its RPC fallback). ``build_fabric`` reserves each pool as a
   STRICT_PACK placement group on its slice, all or nothing.

Clients: the ``DisaggOrchestrator`` (per-edge device or RPC KV transfer),
the fetch plane's ``DeviceFetchClient``, and weight publishing
(``train/weight_sync.py``, the fleet's ``FleetWeightPlane``).
"""

from ray_tpu_torch.fabric.device_connector import DeviceKVConnector
from ray_tpu_torch.fabric.pool import (
    FabricPlan,
    SlicePoolSpec,
    build_fabric,
    build_topology,
    slice_resource,
)
from ray_tpu_torch.fabric.topology import FabricTopology
from ray_tpu_torch.fabric.transport import (
    ArrayBundle,
    DeviceTransport,
    FabricTransferError,
    device_checksum,
)

__all__ = [
    "ArrayBundle",
    "DeviceKVConnector",
    "DeviceTransport",
    "FabricPlan",
    "FabricTopology",
    "FabricTransferError",
    "SlicePoolSpec",
    "build_fabric",
    "build_topology",
    "device_checksum",
    "slice_resource",
]
