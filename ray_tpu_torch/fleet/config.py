"""Fleet topology declaration: {base models x LoRA adapters x tenants}
(counterpart of ``ray_tpu/fleet/config.py``, a copy).

A ``FleetSpec`` is the operator-facing description of a multi-tenant
serving fleet (the "Fine-Tuning and Serving Gemma on Cloud TPU" shape):
which base models exist, which LoRA adapters hang off each, and which
tenants may call them with what QoS. The FleetManager (manager.py) maps
it onto replica pools; the QoS plane (qos.py) prices admission from the
tenant specs; the weight plane (weights.py) versions per-(model,
adapter) payloads against it.

Everything here is plain data + validation — no engine imports, so the
spec can be built (and round-tripped through JSON for a control plane)
without touching torch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


class FleetError(Exception):
    """Base class for fleet-plane failures."""


class UnknownTenantError(FleetError):
    """Request carried a tenant id the FleetSpec does not declare."""


class UnknownModelError(FleetError):
    """Request named a model (or model:adapter) the fleet does not serve."""


class CanaryStateError(FleetError):
    """Canary ladder misuse: begin while one is active, promote/rollback
    while none is."""


@dataclasses.dataclass
class AdapterSpec:
    """One LoRA adapter of a base model. ``adapter_id`` is what requests
    select (``model = "base:adapter"``); the payload itself rides the
    FleetWeightPlane, not the spec."""

    adapter_id: str
    # rank must match the host engine's EngineConfig.lora_rank
    rank: int = 8

    def __post_init__(self):
        if not self.adapter_id or ":" in self.adapter_id:
            raise ValueError(
                f"adapter_id {self.adapter_id!r} must be non-empty and "
                "':'-free (':' separates model from adapter in routing)"
            )


@dataclasses.dataclass
class ModelSpec:
    """One base model and its adapter catalog. ``replicas`` is the pool
    target the manager converges to (the autoscale plane may move it)."""

    model_id: str
    replicas: int = 1
    # adapters declared up front; more can be attached at runtime via
    # FleetManager.register_adapter (the catalog is advisory — routing
    # only requires the adapter to be RESIDENT or loadable on a replica)
    adapters: Tuple[AdapterSpec, ...] = ()

    def __post_init__(self):
        if not self.model_id or ":" in self.model_id:
            raise ValueError(
                f"model_id {self.model_id!r} must be non-empty and ':'-free"
            )
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        seen = set()
        for a in self.adapters:
            if a.adapter_id in seen:
                raise ValueError(f"duplicate adapter {a.adapter_id!r}")
            seen.add(a.adapter_id)

    def adapter(self, adapter_id: str) -> Optional[AdapterSpec]:
        for a in self.adapters:
            if a.adapter_id == adapter_id:
                return a
        return None


@dataclasses.dataclass
class TenantSpec:
    """One tenant's QoS contract.

    ``priority`` orders admission and preemption (higher wins; a paying
    tenant at 10 preempts a batch tenant at 0). ``weight`` is the
    weighted-fair share of queue capacity. ``max_queue_depth`` caps this
    tenant's waiting requests per replica (-1 = fleet default), and
    ``target_queue_wait_s`` arms SLO-priced shedding for this tenant's
    own traffic (0 = depth-only)."""

    tenant_id: str
    priority: int = 0
    weight: float = 1.0
    max_queue_depth: int = -1
    target_queue_wait_s: float = 0.0

    def __post_init__(self):
        if not self.tenant_id:
            raise ValueError("tenant_id must be non-empty")
        if self.weight <= 0:
            raise ValueError("weight must be > 0")

    @property
    def slo_tag(self) -> str:
        """The SLO-histogram tag this tenant's observations record under
        (beyond the engine's model tag) — what evaluate_slo grades."""
        return f"tenant:{self.tenant_id}"


@dataclasses.dataclass
class FleetSpec:
    """The whole fleet: models, tenants, and shared QoS defaults."""

    models: Tuple[ModelSpec, ...] = ()
    tenants: Tuple[TenantSpec, ...] = ()
    # per-tenant queue-depth default when TenantSpec.max_queue_depth < 0:
    # ceil(weight_share * total_queue_budget) per replica
    total_queue_budget: int = 32
    # admit unknown tenants as an anonymous priority-0 tenant instead of
    # rejecting them (off = strict: UnknownTenantError -> 403 at ingress)
    allow_unknown_tenants: bool = False

    def __post_init__(self):
        seen = set()
        for m in self.models:
            if m.model_id in seen:
                raise ValueError(f"duplicate model {m.model_id!r}")
            seen.add(m.model_id)
        seen = set()
        for t in self.tenants:
            if t.tenant_id in seen:
                raise ValueError(f"duplicate tenant {t.tenant_id!r}")
            seen.add(t.tenant_id)

    # -- lookups --------------------------------------------------------------

    def model(self, model_id: str) -> ModelSpec:
        for m in self.models:
            if m.model_id == model_id:
                return m
        raise UnknownModelError(f"fleet does not serve model {model_id!r}")

    def tenant(self, tenant_id: str) -> TenantSpec:
        for t in self.tenants:
            if t.tenant_id == tenant_id:
                return t
        if self.allow_unknown_tenants:
            # anonymous traffic (no header, no user field) pools under one
            # id — TenantSpec forbids empty ids
            return TenantSpec(tenant_id=tenant_id or "anon",
                              priority=0, weight=1.0)
        raise UnknownTenantError(
            f"unknown tenant {tenant_id!r} (declare it in FleetSpec.tenants "
            "or set allow_unknown_tenants)"
        )

    def queue_depth_for(self, tenant: TenantSpec) -> int:
        """Weighted-fair share of the queue budget for one tenant."""
        if tenant.max_queue_depth >= 0:
            return tenant.max_queue_depth
        total_w = sum(t.weight for t in self.tenants) or tenant.weight
        share = tenant.weight / total_w
        return max(1, int(round(share * self.total_queue_budget)))

    @staticmethod
    def parse_model_ref(ref: str) -> Tuple[str, Optional[str]]:
        """Split a request's model field: ``"base"`` or ``"base:adapter"``."""
        if ":" in ref:
            base, adapter = ref.split(":", 1)
            return base, (adapter or None)
        return ref, None

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)
