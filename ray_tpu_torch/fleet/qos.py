"""Per-tenant QoS: weighted-fair admission on top of the serving front
end's ``AdmissionController`` (counterpart of ``ray_tpu/fleet/qos.py``).

One ``AdmissionController`` per tenant, constructed so its histogram-
priced SLO shedding reads the TENANT's own queue-wait series (requests
record under ``tenant:<id>`` via the engine's per-request ``slo_tag``)
instead of the engine-wide one. On top of that, the fleet adds what the
single-tenant controller cannot express:

 * weighted-fair depth caps — each tenant's waiting requests are capped
   at its weight share of ``FleetSpec.total_queue_budget``, so a batch
   tenant flooding the queue exhausts ITS OWN cap while the paying
   tenant's share stays admittable;
 * priority pass-through — the tenant's priority rides every request to
   the engine, where it orders admission and arms priority preemption.

Shed decisions are counted per tenant in
``llm_admission_rejected_total{model,code,tenant}``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ray_tpu_torch.fleet.config import FleetSpec, TenantSpec
from ray_tpu_torch.llm.admission import AdmissionConfig, AdmissionController


class TenantQoSController:
    """Fleet-wide admission state: per-tenant waiting counts and the
    per-tenant AdmissionController ladder. Thread-safe — the ingress
    admits from request threads while replicas retire from their engine
    loops."""

    def __init__(self, spec: FleetSpec):
        self.spec = spec
        self._lock = threading.Lock()
        self._waiting: Dict[str, int] = {}   # tenant -> in-queue count
        self._ctls: Dict[str, AdmissionController] = {}

    def controller(self, tenant: TenantSpec) -> AdmissionController:
        with self._lock:
            ctl = self._ctls.get(tenant.tenant_id)
            if ctl is None:
                ctl = AdmissionController(
                    AdmissionConfig(
                        max_queue_depth=self.spec.queue_depth_for(tenant),
                        target_queue_wait_s=tenant.target_queue_wait_s,
                    ),
                    # the controller's histogram pricing filters by this
                    # tag: point it at the tenant's own SLO series
                    model_tag=tenant.slo_tag,
                    tenant=tenant.tenant_id,
                )
                self._ctls[tenant.tenant_id] = ctl
        return ctl

    # -- admission ------------------------------------------------------------

    def admit(self, tenant: TenantSpec,
              num_running: int = 0) -> Optional[dict]:
        """None = admitted (the caller MUST pair with release());
        otherwise the 429/503 payload to return. The depth the
        admission ladder sees is THIS TENANT's waiting count, so one tenant's
        flood never prices another's admission."""
        ctl = self.controller(tenant)
        with self._lock:
            waiting = self._waiting.get(tenant.tenant_id, 0)
        rejection = ctl.check(num_waiting=waiting, num_running=num_running)
        if rejection is not None:
            return rejection
        with self._lock:
            self._waiting[tenant.tenant_id] = (
                self._waiting.get(tenant.tenant_id, 0) + 1
            )
        return None

    def release(self, tenant_id: str) -> None:
        """The admitted request left the waiting queue (prefilled,
        finished, failed, or was shed downstream)."""
        with self._lock:
            n = self._waiting.get(tenant_id, 0) - 1
            if n > 0:
                self._waiting[tenant_id] = n
            else:
                self._waiting.pop(tenant_id, None)

    def start_drain(self) -> None:
        with self._lock:
            ctls = list(self._ctls.values())
        for ctl in ctls:
            ctl.start_drain()

    def waiting_by_tenant(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._waiting)

    def stats(self) -> dict:
        with self._lock:
            ctls = dict(self._ctls)
            waiting = dict(self._waiting)
        return {
            "waiting_by_tenant": waiting,
            "tenants": {tid: ctl.stats() for tid, ctl in ctls.items()},
        }
