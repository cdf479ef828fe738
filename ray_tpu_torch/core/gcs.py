"""Control plane: cluster metadata registries (counterpart of
``ray_tpu/core/gcs.py``).

Upstream Ray's GCS server (src/ray/gcs/gcs_server/: GcsNodeManager,
GcsActorManager naming, InternalKVManager gcs_kv_manager.h), in process
for the in-process runtime. The GCS served across processes is the
cluster runtime's (``cluster/gcs_service.py``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional

from ray_tpu_torch.core.resources import NodeResources
from ray_tpu_torch.utils.ids import ActorID, NodeID

if TYPE_CHECKING:
    from ray_tpu_torch.core.actor_runtime import Actor


@dataclass
class NodeInfo:
    node_id: NodeID
    resources: NodeResources
    hostname: str = "localhost"
    alive: bool = True
    last_heartbeat: float = field(default_factory=time.monotonic)
    labels: dict = field(default_factory=dict)


class Gcs:
    def __init__(self):
        self._lock = threading.RLock()
        self._nodes: dict[NodeID, NodeInfo] = {}
        self._named_actors: dict[tuple[str, str], ActorID] = {}  # (ns, name) -> id
        self._actors: dict[ActorID, "Actor"] = {}
        self._placement_groups: dict = {}
        self._kv: dict[str, dict[bytes, bytes]] = {}  # namespace -> k/v

    # -- nodes ---------------------------------------------------------------

    def register_node(self, info: NodeInfo) -> None:
        with self._lock:
            self._nodes[info.node_id] = info

    def remove_node(self, node_id: NodeID) -> None:
        with self._lock:
            info = self._nodes.get(node_id)
            if info:
                info.alive = False

    def heartbeat(self, node_id: NodeID) -> None:
        with self._lock:
            info = self._nodes.get(node_id)
            if info:
                info.last_heartbeat = time.monotonic()

    def get_node(self, node_id: NodeID) -> Optional[NodeInfo]:
        with self._lock:
            return self._nodes.get(node_id)

    def alive_nodes(self) -> list[NodeInfo]:
        with self._lock:
            return [n for n in self._nodes.values() if n.alive]

    def cluster_resources(self) -> dict:
        with self._lock:
            total: dict[str, float] = {}
            for n in self._nodes.values():
                if not n.alive:
                    continue
                for k, v in n.resources.total.items():
                    total[k] = total.get(k, 0.0) + v
            return total

    def available_resources(self) -> dict:
        with self._lock:
            total: dict[str, float] = {}
            for n in self._nodes.values():
                if not n.alive:
                    continue
                for k, v in n.resources.available.items():
                    total[k] = total.get(k, 0.0) + v
            return total

    # -- actors --------------------------------------------------------------

    def register_actor(
        self, actor: "Actor", name: Optional[str], namespace: str
    ) -> None:
        with self._lock:
            if name:
                key = (namespace, name)
                if key in self._named_actors and self._named_actors[key] in self._actors:
                    existing = self._actors[self._named_actors[key]]
                    from ray_tpu_torch.core.actor_runtime import ActorState

                    if existing.state != ActorState.DEAD:
                        raise ValueError(
                            f"actor name {name!r} already taken in namespace {namespace!r}"
                        )
                self._named_actors[key] = actor.actor_id
            self._actors[actor.actor_id] = actor

    def get_actor(self, actor_id: ActorID) -> Optional["Actor"]:
        with self._lock:
            return self._actors.get(actor_id)

    def get_named_actor(self, name: str, namespace: str) -> Optional["Actor"]:
        with self._lock:
            actor_id = self._named_actors.get((namespace, name))
            return self._actors.get(actor_id) if actor_id else None

    def remove_actor(self, actor_id: ActorID) -> None:
        with self._lock:
            actor = self._actors.pop(actor_id, None)
            if actor is not None:
                self._named_actors = {
                    k: v for k, v in self._named_actors.items() if v != actor_id
                }

    def list_actors(self) -> list["Actor"]:
        with self._lock:
            return list(self._actors.values())

    # -- placement groups ----------------------------------------------------

    def register_placement_group(self, pg) -> None:
        with self._lock:
            self._placement_groups[pg.id] = pg

    def remove_placement_group(self, pg_id) -> None:
        with self._lock:
            self._placement_groups.pop(pg_id, None)

    def list_placement_groups(self) -> list:
        with self._lock:
            return list(self._placement_groups.values())

    # -- internal KV (reference: gcs_kv_manager.h InternalKVManager) ---------

    def kv_put(self, key: bytes, value: bytes, namespace: str = "default") -> None:
        with self._lock:
            self._kv.setdefault(namespace, {})[key] = value

    def kv_get(self, key: bytes, namespace: str = "default") -> Optional[bytes]:
        with self._lock:
            return self._kv.get(namespace, {}).get(key)

    def kv_del(self, key: bytes, namespace: str = "default") -> None:
        with self._lock:
            self._kv.get(namespace, {}).pop(key, None)

    def kv_keys(self, prefix: bytes = b"", namespace: str = "default") -> list[bytes]:
        with self._lock:
            return [k for k in self._kv.get(namespace, {}) if k.startswith(prefix)]
