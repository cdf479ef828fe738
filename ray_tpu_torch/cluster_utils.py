"""In-process fake cluster for multi-node tests (a copy of
``ray_tpu/cluster_utils.py``).

Reference analog: python/ray/cluster_utils.py:135 (Cluster — N raylets
sharing one GCS, used by scheduling/FT/placement tests). Here a "node"
is a capacity domain registered in the in-process runtime's GCS:
placement groups spread/pack across them exactly as across real hosts,
while execution stays in-process threads. The accelerator resource is
``num_gpus`` -> ``"GPU"`` where the reference's is ``num_tpus`` ->
``"TPU"``. The multi-process cluster is ``ray_tpu_torch.cluster.LocalCluster``.
"""

from __future__ import annotations

import threading
from typing import Optional

from ray_tpu_torch.core.gcs import NodeInfo
from ray_tpu_torch.core.resources import NodeResources, ResourceSet
from ray_tpu_torch.utils.ids import NodeID


class Cluster:
    def __init__(self, initialize_head: bool = True, head_node_args: Optional[dict] = None):
        import ray_tpu_torch
        from ray_tpu_torch.core import runtime as rt

        self._lock = threading.Lock()
        self._nodes: list[NodeInfo] = []
        if not rt.is_initialized():
            ray_tpu_torch.init(**(head_node_args or {}))
        self._runtime = rt.get_runtime()
        if initialize_head:
            # the runtime's own node is the head
            self.head_node = self._runtime.gcs.get_node(self._runtime.node_id)

    def add_node(
        self,
        num_cpus: float = 1.0,
        num_gpus: float = 0.0,
        resources: Optional[dict] = None,
    ) -> NodeInfo:
        total = dict(resources or {})
        total["CPU"] = num_cpus
        if num_gpus:
            total["GPU"] = num_gpus
        info = NodeInfo(NodeID.from_random(), NodeResources(ResourceSet(total)))
        self._runtime.gcs.register_node(info)
        with self._lock:
            self._nodes.append(info)
        self._retry_pending_pgs()
        return info

    def remove_node(self, node: NodeInfo) -> None:
        self._runtime.gcs.remove_node(node.node_id)
        with self._lock:
            if node in self._nodes:
                self._nodes.remove(node)

    def _retry_pending_pgs(self) -> None:
        from ray_tpu_torch.core.placement import retry_pending_placement_groups

        retry_pending_placement_groups(self._runtime)

    @property
    def nodes(self) -> list[NodeInfo]:
        with self._lock:
            return list(self._nodes)

    def shutdown(self) -> None:
        for n in self.nodes:
            self.remove_node(n)
