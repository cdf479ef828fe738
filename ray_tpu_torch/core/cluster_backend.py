"""Cluster backend for the public API: one `init(address=...)` attaches
the whole `ray_tpu_torch.*` surface to a running GCS/node-daemon plane.

Reference analog: ray.init(address=...) attaching the driver's core
worker to an existing GCS + raylet (python/ray/_private/worker.py:1285);
after that every `remote/get/put/wait/actor/placement_group` call rides
the same cluster runtime that Train/Serve/Data workers use. Here the
adapter maps the in-process API's TaskOptions/ActorOptions onto the
ClusterClient protocol (leases, pushes, GCS actor table) so the SAME
user program runs in-process (no address) or on a multi-process cluster
(address given) without edits.

A copy of ``ray_tpu/core/cluster_backend.py``: ``num_gpus`` maps onto the
daemons' ``"GPU"`` resource where the reference maps ``num_tpus`` onto
``"TPU"``, and a GPU lease runs in a worker pinned to its cards.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

from ray_tpu_torch.cluster.client import (
    ClusterActorHandle,
    ClusterClient,
    ClusterObjectRef,
)
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.core.cluster_backend")


class ClusterPlacementGroup:
    """Placement-group handle in cluster mode (reference:
    python/ray/util/placement_group.py:41 PlacementGroup)."""

    def __init__(self, info: dict, client: ClusterClient):
        self._info = info
        self._client = client

    @property
    def id(self) -> bytes:
        return self._info["pg_id"]

    @property
    def bundle_specs(self) -> list[dict]:
        return [dict(b["resources"]) for b in self._info["bundles"]]

    @property
    def bundles(self) -> list[dict]:
        return [dict(b) for b in self._info["bundles"]]

    def ready(self, timeout: float = 30.0) -> bool:
        # create_placement_group blocks until CREATED + reserved, so a
        # constructed handle is ready by definition; re-check for liveness
        info = self._client.gcs.call("get_pg", {"pg_id": self.id})
        return info is not None and info["state"] == "CREATED"

    def remove(self) -> None:
        self._client.remove_placement_group(self.id)

    def __repr__(self) -> str:
        return f"ClusterPlacementGroup({self.id.hex()[:12]}, {len(self._info['bundles'])} bundles)"


def _to_cluster_resources(options) -> dict:
    """Map TaskOptions/ActorOptions resources onto the cluster's resource
    naming (daemons register `num_cpus`, `GPU`, plus custom keys)."""
    req = dict(options.resources)
    if options.num_cpus:
        req["num_cpus"] = req.get("num_cpus", 0.0) + options.num_cpus
    if options.num_gpus:
        req["GPU"] = req.get("GPU", 0.0) + options.num_gpus
    return req


def _placement(options) -> tuple[Optional[bytes], int, Optional[str], bool]:
    """Extract (pg_id, bundle_index, affinity_node_id, affinity_soft)
    from options + scheduling strategy (single source of truth, the
    cluster-mode analog of core/scheduler.resolve_pool)."""
    pg = options.placement_group
    idx = options.placement_group_bundle_index
    affinity = None
    soft = False
    strat = options.scheduling_strategy
    if strat is not None and hasattr(strat, "placement_group"):
        pg = strat.placement_group
        idx = strat.placement_group_bundle_index
    elif strat is not None and hasattr(strat, "node_id"):
        affinity = strat.node_id
        soft = bool(getattr(strat, "soft", False))
    pg_id = None
    if pg is not None:
        pg_id = getattr(pg, "id", None)
        if isinstance(pg_id, (bytearray, memoryview)):
            pg_id = bytes(pg_id)
        if not isinstance(pg_id, bytes):
            raise TypeError(
                f"cluster mode needs a ClusterPlacementGroup (got {type(pg).__name__}); "
                "create it via ray_tpu_torch.placement_group() after init(address=...)"
            )
    # -1 = "any bundle that fits" (wildcard), resolved at lease time
    bundle_index = -1 if idx is None or idx < 0 else int(idx)
    return pg_id, bundle_index, affinity, soft


class ClusterBackend:
    """Adapter: public-API calls -> ClusterClient protocol."""

    @classmethod
    def from_client(cls, client: ClusterClient,
                    namespace: str = "default") -> "ClusterBackend":
        """Wrap an existing ClusterClient (worker processes: their
        ambient client already points at the local daemon)."""
        self = cls.__new__(cls)
        self.client = client
        self.namespace = namespace
        self.address = "%s:%d" % client.gcs.addr
        return self

    def __init__(self, address: str, namespace: str = "default"):
        # "h:p" (a GCS of several endpoints waits for part 3b)
        from ray_tpu_torch.cluster.rpc import ReconnectingRpcClient, parse_gcs_addr

        gcs_addr = parse_gcs_addr(address)
        # the driver leases from / fetches through a colocated daemon; on
        # a LocalCluster every daemon is local, so attach to the first
        # alive node (reference: ray.init picks up the local raylet)
        gcs = ReconnectingRpcClient(
            *gcs_addr, timeout=60.0
        ).connect(retries=20)
        try:
            nodes = [n for n in gcs.call("list_nodes", None) if n["alive"]]
        finally:
            gcs.close()
        if not nodes:
            raise ConnectionError(
                f"no alive nodes registered at GCS {address}; start a node "
                "daemon first (LocalCluster.add_node)"
            )
        self.client = ClusterClient(gcs_addr, tuple(nodes[0]["addr"]))
        self.namespace = namespace
        self.address = address

    def close(self) -> None:
        self.client.close()

    # -- tasks ---------------------------------------------------------------

    def submit_task(self, func, args, kwargs, options) -> list[ClusterObjectRef]:
        if options.num_returns == "streaming":
            raise NotImplementedError(
                "streaming generators are not yet supported in cluster mode"
            )
        pg_id, bundle_index, affinity, soft = _placement(options)
        out = self.client.submit(
            func,
            args,
            dict(kwargs or {}),
            resources=_to_cluster_resources(options),
            num_returns=int(options.num_returns),
            max_retries=options.max_retries,
            pg_id=pg_id,
            bundle_index=bundle_index,
            desc=options.name or getattr(func, "__name__", "task"),
            affinity_node_id=affinity,
            affinity_soft=soft,
            runtime_env=options.runtime_env,
        )
        return out if isinstance(out, list) else [out]

    # -- actors --------------------------------------------------------------

    def create_actor(self, cls, args, kwargs, options) -> ClusterActorHandle:
        if options.name and options.get_if_exists:
            try:
                return self.client.get_named_actor(options.name, self.namespace)
            except ValueError:
                pass
        pg_id, bundle_index, _affinity, _soft = _placement(options)
        return self.client.create_actor(
            cls,
            args,
            dict(kwargs or {}),
            resources=_to_cluster_resources(options),
            name=options.name,
            namespace=self.namespace,
            max_restarts=options.max_restarts,
            pg_id=pg_id,
            bundle_index=bundle_index,
            runtime_env=options.runtime_env,
        )

    def get_named_actor(self, name: str, namespace: Optional[str] = None):
        return self.client.get_named_actor(name, namespace or self.namespace)

    # -- objects -------------------------------------------------------------

    def put(self, value: Any) -> ClusterObjectRef:
        return self.client.put(value)

    def get(self, refs, timeout: Optional[float] = None):
        return self.client.get(refs, timeout=timeout)

    def wait(self, refs: Sequence[ClusterObjectRef], num_returns: int,
             timeout: Optional[float]):
        return self.client.wait(refs, num_returns=num_returns, timeout=timeout)

    # -- placement groups ----------------------------------------------------

    def placement_group(self, bundles: list[dict], strategy: str,
                        name: str = "") -> ClusterPlacementGroup:
        # accept in-process style bundle dicts ({"CPU": 1} or {"num_cpus": 1})
        norm = []
        for b in bundles:
            r = dict(b)
            if "CPU" in r:
                r["num_cpus"] = r.pop("CPU")
            norm.append(r)
        info = self.client.create_placement_group(
            norm, strategy=strategy, name=name or None
        )
        return ClusterPlacementGroup(info, self.client)

    def remove_placement_group(self, pg) -> None:
        pg_id = pg.id if hasattr(pg, "id") else pg
        self.client.remove_placement_group(pg_id)

    # -- cluster state -------------------------------------------------------

    def cluster_resources(self) -> dict:
        return self.client.cluster_resources()

    def available_resources(self) -> dict:
        total: dict[str, float] = {}
        for n in self.client.nodes():
            if n["alive"]:
                for k, v in n["available"].items():
                    total[k] = total.get(k, 0.0) + v
        return total

    def nodes(self) -> list:
        return self.client.nodes()
