"""Placement groups: gang resource reservation (counterpart of
``ray_tpu/core/placement.py``).

Upstream Ray's placement groups (python/ray/util/placement_group.py:41,145;
bundle packing policies in
src/ray/raylet/scheduling/policy/bundle_scheduling_policy.cc; strategy
enum src/ray/protobuf/common.proto:978-985). The in-process runtime has
one node unless ``cluster_utils.Cluster`` registers more capacity domains
(its ``add_node`` then retries the pending groups); the reservation and
per-bundle accounting are the reference's.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

from ray_tpu_torch.core import errors
from ray_tpu_torch.core.resources import NodeResources, ResourceSet
from ray_tpu_torch.utils.ids import PlacementGroupID

if TYPE_CHECKING:
    from ray_tpu_torch.core.runtime import Runtime

STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


@dataclass
class Bundle:
    index: int
    resources: ResourceSet
    node_id: Optional[object] = None  # which node holds the reservation
    pool: Optional[NodeResources] = None  # per-bundle accounting


class PlacementGroup:
    def __init__(
        self,
        pg_id: PlacementGroupID,
        bundles: list[dict],
        strategy: str,
        name: str,
        runtime: "Runtime",
    ):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
        self.id = pg_id
        self.strategy = strategy
        self.name = name
        self._runtime = runtime
        self.bundles = [Bundle(i, ResourceSet(b)) for i, b in enumerate(bundles)]
        self._state = "PENDING"
        self._infeasible_reason: Optional[str] = None
        # reentrant: __repr__ takes it, and a log line formatted by a thread
        # that already holds it must not deadlock that thread
        self._lock = threading.RLock()
        # serializes whole reservation attempts (autoscaler retry vs
        # cluster.add_node retry vs creation) — _lock only guards state reads
        self._reserve_lock = threading.Lock()

    @property
    def bundle_specs(self) -> list[dict]:
        return [dict(b.resources) for b in self.bundles]

    def mark_created(self) -> None:
        with self._lock:
            self._state = "CREATED"

    def mark_infeasible(self, reason: str) -> None:
        with self._lock:
            self._state = "INFEASIBLE"
            self._infeasible_reason = reason

    def ready(self, timeout: Optional[float] = 30.0) -> bool:
        """Block until the reservation exists (reference pg.ready() is an
        ObjectRef that stays pending). INFEASIBLE is not terminal while an
        autoscaler/cluster may add nodes — poll until the deadline, THEN
        raise if still infeasible; return False if merely pending."""
        import time as _time

        deadline = _time.monotonic() + (timeout if timeout is not None else 0.0)
        infinite = timeout is None
        while True:
            with self._lock:
                state, reason = self._state, self._infeasible_reason
            if state == "CREATED":
                return True
            if state == "REMOVED":
                raise errors.PlacementGroupUnavailableError(
                    f"placement group {self.name or self.id} was removed"
                )
            if not infinite and _time.monotonic() >= deadline:
                if state == "INFEASIBLE":
                    raise errors.PlacementGroupUnavailableError(
                        f"placement group {self.name or self.id}: {reason}"
                    )
                return False
            _time.sleep(0.02)

    def bundle_pool(self, index: int, req: ResourceSet) -> NodeResources:
        """Resolve which bundle's reservation a task draws from."""
        with self._lock:
            if self._state == "INFEASIBLE":
                raise errors.PlacementGroupUnavailableError(
                    f"placement group {self.name or self.id}: {self._infeasible_reason}"
                )
            if self._state == "REMOVED":
                raise errors.PlacementGroupUnavailableError(
                    f"placement group {self.name or self.id} was removed"
                )
        if index >= 0:
            if index >= len(self.bundles):
                raise errors.PlacementGroupUnavailableError(
                    f"bundle index {index} out of range ({len(self.bundles)} bundles)"
                )
            return self.bundles[index].pool
        # wildcard: first bundle that currently fits, else bundle 0 (task
        # will queue until that bundle frees up)
        for b in self.bundles:
            if req.fits_in(b.pool.available):
                return b.pool
        return self.bundles[0].pool

    def remove(self) -> None:
        """Reject new work immediately; release node capacity once in-flight
        bundle tasks drain (running threads can't be killed; the reference
        instead kills PG workers — raylet PlacementGroupResourceManager)."""
        with self._reserve_lock:
            self._remove_locked()

    def _remove_locked(self) -> None:
        with self._lock:
            if self._state == "REMOVED":
                return
            prev, self._state = self._state, "REMOVED"
        if prev != "CREATED":
            return

        def _drain_and_release():
            import time as _time

            for b in self.bundles:
                if b.node_id is None:
                    continue
                while b.pool is not None and b.pool.in_use():
                    _time.sleep(0.05)
                node = self._runtime.gcs.get_node(b.node_id)
                if node is not None:
                    node.resources.release(b.resources)
            self._runtime.scheduler.notify()

        threading.Thread(
            target=_drain_and_release, name="ray_tpu_torch-pg-drain", daemon=True
        ).start()

    def __repr__(self):
        with self._lock:
            state = self._state
        return (f"PlacementGroup({self.name or self.id.hex()[:8]}, {self.strategy}, "
                f"{len(self.bundles)} bundles, {state})")


def create_placement_group(
    runtime: "Runtime",
    bundles: list[dict],
    strategy: str = "PACK",
    name: str = "",
) -> PlacementGroup:
    """Reserve bundle resources on cluster nodes per the strategy."""
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    pg = PlacementGroup(PlacementGroupID.from_random(), bundles, strategy, name, runtime)
    return reserve_placement_group(pg, runtime.gcs.alive_nodes())


def retry_pending_placement_groups(runtime: "Runtime") -> None:
    """Re-attempt reservation for every PENDING/INFEASIBLE group (called
    by ``cluster_utils.Cluster`` after adding nodes)."""
    nodes = runtime.gcs.alive_nodes()
    for pg in runtime.gcs.list_placement_groups():
        if getattr(pg, "_state", None) in ("PENDING", "INFEASIBLE"):
            reserve_placement_group(pg, nodes)


def reserve_placement_group(pg: PlacementGroup, nodes: list) -> PlacementGroup:
    """Try to reserve a PENDING/INFEASIBLE group's bundles."""
    with pg._reserve_lock:
        return _reserve_locked(pg, nodes)


def _reserve_locked(pg: PlacementGroup, nodes: list) -> PlacementGroup:
    with pg._lock:
        if pg._state in ("CREATED", "REMOVED"):
            return pg  # REMOVED is terminal: never resurrect a removed group
        pg._state = "PENDING"
        pg._infeasible_reason = None
    strategy = pg.strategy

    def reserve(bundle: Bundle, node) -> bool:
        if node.resources.try_acquire(bundle.resources):
            bundle.node_id = node.node_id
            # Per-bundle pool so tasks draw from the reservation, mirroring
            # the reference's CPU_group_{pg_id} shadow resources.
            bundle.pool = NodeResources(bundle.resources)
            return True
        return False

    reserved: list[tuple[Bundle, object]] = []

    def rollback() -> None:
        for b, node in reserved:
            node.resources.release(b.resources)
            b.node_id, b.pool = None, None

    if strategy in ("PACK", "STRICT_PACK"):
        # all bundles on one node if possible (PACK falls back to spill)
        for node in nodes:
            ok = True
            for b in pg.bundles:
                if reserve(b, node):
                    reserved.append((b, node))
                else:
                    ok = False
                    break
            if ok:
                pg.mark_created()
                return pg
            rollback()
            reserved.clear()
        if strategy == "STRICT_PACK":
            pg.mark_infeasible("no single node can hold all bundles (STRICT_PACK)")
            return pg
        # PACK fallback: best-effort any placement
        strategy = "SPREAD"

    if strategy in ("SPREAD", "STRICT_SPREAD"):
        used_nodes: set = set()
        for b in pg.bundles:
            placed = False
            # prefer unused nodes (spread), then any (non-strict)
            candidates = [n for n in nodes if n.node_id not in used_nodes]
            if strategy == "SPREAD":
                candidates += [n for n in nodes if n.node_id in used_nodes]
            for node in candidates:
                if reserve(b, node):
                    reserved.append((b, node))
                    used_nodes.add(node.node_id)
                    placed = True
                    break
            if not placed:
                rollback()
                pg.mark_infeasible(
                    f"bundle {b.index} ({dict(b.resources)}) does not fit "
                    f"({strategy}; {len(nodes)} nodes)"
                )
                return pg
        pg.mark_created()
        return pg

    raise AssertionError(f"unhandled strategy {strategy}")
