"""Slice pools: role-tagged engine pools pinned to slices (counterpart of
``ray_tpu/fabric/pool.py``).

A ``SlicePoolSpec`` names a pool (role, slice, size, per-engine
resources); ``build_topology`` turns the specs and the declared links into
the ``FabricTopology`` the transfer plane consults: pools whose slices
were linked (one peer-to-peer domain) get device edges, every other pair
RPC. That is what an in-process orchestrator consumes, where pools are
engine lists.

``build_fabric`` also reserves **one placement group per pool** whose
bundles all carry the pool's slice resource (``slice:<id>``, a custom
resource each node advertises for the slice its hosts belong to),
STRICT_PACK so the whole pool lands inside one slice's host group. It runs
on the in-process runtime (``ray_tpu_torch.init(resources={"slice:s0":
...})``) and on a cluster whose nodes advertise ``slice:`` resources, with
the same placement code.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ray_tpu_torch.fabric.topology import FabricTopology
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.fabric.pool")


def slice_resource(slice_id: str) -> str:
    """The custom resource name a node advertises for its slice."""
    return f"slice:{slice_id}"


@dataclasses.dataclass
class SlicePoolSpec:
    """One role-tagged pool pinned to one slice.

    ``resources`` are per-engine bundle resources beyond the slice pin
    (e.g. ``{"GPU": 1}``); every bundle also reserves one unit of the
    pool's ``slice:<id>`` resource."""

    name: str
    role: str                       # prefill | decode | draft | learner | rollout
    slice_id: str
    size: int = 1
    resources: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"pool {self.name!r}: size must be >= 1")

    def bundles(self) -> list[dict]:
        return [{**self.resources, slice_resource(self.slice_id): 1.0}
                for _ in range(self.size)]


@dataclasses.dataclass
class FabricPlan:
    """Reserved pools and the topology the transfer plane consults."""

    topology: FabricTopology
    specs: list
    groups: dict = dataclasses.field(default_factory=dict)  # pool -> placement group

    def describe(self) -> dict:
        return {
            "pools": self.topology.pools(),
            "edges": self.topology.edges(),
            "placement_groups": {name: getattr(pg, "name", str(pg))
                                 for name, pg in self.groups.items()},
        }

    def remove(self) -> None:
        import ray_tpu_torch

        for pg in self.groups.values():
            try:
                ray_tpu_torch.remove_placement_group(pg)
            except Exception:  # noqa: BLE001 — best-effort teardown
                logger.exception("failed to remove fabric placement group")
        self.groups.clear()


def build_topology(specs: list, links: Optional[list] = None) -> FabricTopology:
    """The topology alone, without reservations: what the in-process
    orchestrator consumes when pools are engine lists."""
    topo = FabricTopology()
    for spec in specs:
        topo.add_pool(spec.name, spec.role, spec.slice_id, spec.size)
    for a, b in links or ():
        topo.link(a, b)
    return topo


def build_fabric(specs: list, links: Optional[list] = None,
                 ready_timeout_s: float = 30.0) -> FabricPlan:
    """Reserve one STRICT_PACK placement group per pool (bundles pinned to
    the pool's slice resource) and return the plan. Raises
    ``PlacementGroupUnavailableError`` when a pool's slice can't hold it:
    a fabric that silently half-places would hand the transfer plane a
    topology describing pools that don't exist."""
    import ray_tpu_torch
    from ray_tpu_torch.core.errors import PlacementGroupUnavailableError

    topo = build_topology(specs, links)
    plan = FabricPlan(topology=topo, specs=list(specs))
    try:
        for spec in specs:
            pg = ray_tpu_torch.placement_group(spec.bundles(), strategy="STRICT_PACK",
                                               name=f"fabric-{spec.name}")
            plan.groups[spec.name] = pg
            # ready() raises only for INFEASIBLE/REMOVED and returns False
            # for a group still PENDING at the deadline: a transiently full
            # slice must fail the fabric too
            if not pg.ready(timeout=ready_timeout_s):
                raise PlacementGroupUnavailableError(
                    f"fabric pool {spec.name!r} still PENDING on slice "
                    f"{spec.slice_id!r} after {ready_timeout_s}s")
    except BaseException:
        plan.remove()  # all-or-nothing: no half-reserved fabric
        raise
    return plan
