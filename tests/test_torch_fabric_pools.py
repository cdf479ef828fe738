"""``ray_tpu_torch.fabric.build_fabric``: one STRICT_PACK placement group a
pool, pinned to its slice resource, all or nothing.

``tests/test_fabric.py:296,340`` on the port's in-process runtime (the
reservation against ``slice:`` resources, the device edge between linked
slices, the rollback of a half-placed fabric, PENDING at the deadline as a
failure), the plan's description held against the reference's for the same
specs, and the same reservation on a ``LocalCluster`` whose nodes advertise
``slice:`` resources. Every wait has its own limit.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu.fabric.pool import SlicePoolSpec as JSlicePoolSpec
from ray_tpu.fabric.pool import build_topology as j_build_topology
from ray_tpu_torch.cluster import LocalCluster
from ray_tpu_torch.core import runtime as rt
from ray_tpu_torch.core.errors import PlacementGroupUnavailableError
from ray_tpu_torch.fabric import SlicePoolSpec, build_fabric

pytestmark = pytest.mark.torch_port

SPECS = [("prefill", "prefill", "s0", 2, {}), ("decode", "decode", "s1", 2, {"CPU": 1})]


def _specs(cls=SlicePoolSpec):
    return [cls(name, role, sl, size=n, resources=dict(res)) for name, role, sl, n, res in SPECS]


def _wait_slice(resource: str, want: float, timeout_s: float = 5.0) -> float:
    deadline = time.time() + timeout_s
    got = ray_tpu_torch.available_resources().get(resource, 0)
    while got < want and time.time() < deadline:
        time.sleep(0.05)  # a group's removal drains asynchronously
        got = ray_tpu_torch.available_resources().get(resource, 0)
    return got


def test_slice_pools_reserve_placement_groups_all_or_nothing():
    if rt.is_initialized():
        rt.shutdown_runtime()
    ray_tpu_torch.init(num_cpus=8, resources={"slice:s0": 4, "slice:s1": 4})
    try:
        plan = build_fabric(_specs(), links=[("s0", "s1")])
        try:
            desc = plan.describe()
            assert set(desc["pools"]) == {"prefill", "decode"}
            edges = {(e["src"], e["dst"]): e["backend"] for e in desc["edges"]}
            assert edges[("prefill", "decode")] == "device"  # linked slices
            ref = j_build_topology(_specs(JSlicePoolSpec), [("s0", "s1")])
            assert desc["pools"] == ref.pools() and desc["edges"] == ref.edges()
            assert desc["placement_groups"] == {"prefill": "fabric-prefill",
                                                "decode": "fabric-decode"}
            avail = ray_tpu_torch.available_resources()
            # bundles actually reserved against the slice resources
            assert avail.get("slice:s0", 0) == 2
            assert avail.get("slice:s1", 0) == 2
        finally:
            plan.remove()
        assert plan.groups == {}
        # a pool pinned to a slice nobody advertises fails loudly, and the
        # half-reserved fabric is rolled back (all-or-nothing)
        with pytest.raises(PlacementGroupUnavailableError):
            build_fabric([SlicePoolSpec("prefill", "prefill", "s0", size=2),
                          SlicePoolSpec("decode", "decode", "s9", size=1)],
                         ready_timeout_s=0.3)
        assert _wait_slice("slice:s0", 4) == 4
    finally:
        rt.shutdown_runtime()


def test_build_fabric_raises_on_pending_at_deadline(monkeypatch):
    """PlacementGroup.ready() returns False (no raise) for a group still
    PENDING at the deadline, a transiently full slice: build_fabric fails
    the whole plan and rolls back."""
    removed = []

    class _PendingPG:
        name = "stub"

        def ready(self, timeout=None):
            return False  # still PENDING, not infeasible

        def remove(self):
            removed.append(self)

    monkeypatch.setattr(ray_tpu_torch, "placement_group",
                        lambda *a, **k: _PendingPG(), raising=False)
    monkeypatch.setattr(ray_tpu_torch, "remove_placement_group",
                        lambda pg: pg.remove(), raising=False)
    with pytest.raises(PlacementGroupUnavailableError, match="PENDING"):
        build_fabric([SlicePoolSpec("prefill", "prefill", "s0", size=1)],
                     ready_timeout_s=0.1)
    assert len(removed) == 1  # all-or-nothing rollback ran


def test_slice_pools_reserved_on_a_cluster():
    """The same reservation on a port cluster whose nodes advertise the
    slices: each pool's bundles are taken from its slice's node, and
    removing the plan gives them back. (A slice no node advertises is not
    tried here: the cluster client's ``create_placement_group`` waits 30 s
    for placement and raises TimeoutError, in both packages.)"""
    if rt.is_initialized():
        rt.shutdown_runtime()
    c = LocalCluster(node_death_timeout_s=2.0)
    try:
        c.start()
        c.add_node({"num_cpus": 4, "slice:s0": 4}, node_id="host-s0")
        c.add_node({"num_cpus": 4, "slice:s1": 4}, node_id="host-s1")
        c.wait_for_nodes(2)
        ray_tpu_torch.init(address=c.address)
        plan = build_fabric(_specs(), links=[("s0", "s1")])
        try:
            edges = {(e["src"], e["dst"]): e["backend"] for e in plan.describe()["edges"]}
            assert edges[("prefill", "decode")] == "device"
            assert _wait_slice("slice:s0", 2) == 2 and _wait_slice("slice:s1", 2) == 2
            assert ray_tpu_torch.available_resources().get("slice:s0") == 2
            assert ray_tpu_torch.available_resources().get("slice:s1") == 2
            for pg in plan.groups.values():
                assert pg.ready(timeout=5)
        finally:
            plan.remove()
        assert _wait_slice("slice:s0", 4) == 4 and _wait_slice("slice:s1", 4) == 4
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()
        left = c.leftovers()
        assert left == {"processes": [], "store_files": []}, left
