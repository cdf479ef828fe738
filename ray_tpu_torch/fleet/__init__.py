"""ray_tpu_torch.fleet: the multi-tenant model fleet (counterpart of
``ray_tpu/fleet``).

Maps {base models x LoRA adapters x tenants} onto replica pools:
model-aware prefix/residency routing, dynamic adapter load/evict against
each engine's slot budget, per-tenant weighted-fair admission with
priority preemption, and a versioned canary weight-rollout plane over the
device fabric (promote-on-green / rollback-on-red, bitwise-gated). Weights
are written into each replica's own tensors in place, so every captured
CUDA graph serves the new version.
"""

from ray_tpu_torch.fleet.config import (
    AdapterSpec,
    CanaryStateError,
    FleetError,
    FleetSpec,
    ModelSpec,
    TenantSpec,
    UnknownModelError,
    UnknownTenantError,
)
from ray_tpu_torch.fleet.ingress import FleetServer
from ray_tpu_torch.fleet.manager import (
    FleetAdmissionRejected,
    FleetManager,
    FleetReplica,
    FleetTicket,
)
from ray_tpu_torch.fleet.qos import TenantQoSController
from ray_tpu_torch.fleet.weights import (
    FleetWeightPlane,
    bitwise_equal,
    local_slo_histograms,
    shares_storage,
)

__all__ = [
    "AdapterSpec",
    "CanaryStateError",
    "FleetAdmissionRejected",
    "FleetError",
    "FleetManager",
    "FleetReplica",
    "FleetServer",
    "FleetSpec",
    "FleetTicket",
    "FleetWeightPlane",
    "ModelSpec",
    "TenantSpec",
    "TenantQoSController",
    "UnknownModelError",
    "UnknownTenantError",
    "bitwise_equal",
    "local_slo_histograms",
    "shares_storage",
]
