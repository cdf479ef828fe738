"""Slice pools: role-tagged engine pools pinned to slices (counterpart of
``ray_tpu/fabric/pool.py``).

A ``SlicePoolSpec`` names a pool (role, slice, size, per-engine
resources); ``build_topology`` turns the specs and the declared links into
the ``FabricTopology`` the transfer plane consults: pools whose slices
were linked (one peer-to-peer domain) get device edges, every other pair
RPC. That is what an in-process orchestrator consumes, where pools are
engine lists.

``build_fabric``, which reserves one placement group per pool through the
cluster runtime, is not ported: the port has no cluster runtime yet
(ROADMAP.md, Queue 1, B8), and it raises NotImplementedError naming it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ray_tpu_torch.fabric.topology import FabricTopology


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
    """Reserving placement groups needs the cluster runtime: not ported."""
    raise NotImplementedError(
        "build_fabric reserves placement groups through the cluster runtime, which is not "
        "ported to ray_tpu_torch yet (ROADMAP.md, Queue 1, B8); build_topology gives the "
        "topology alone"
    )
