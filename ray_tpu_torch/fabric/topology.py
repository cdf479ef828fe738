"""Fabric topology: which pools sit on which slice, and which pool pairs
can move device tensors directly (counterpart of
``ray_tpu/fabric/topology.py``, whole: it touches no device).

Every role-tagged pool (prefill / decode / draft / learner / rollout) is
pinned to a **slice**, slices are grouped into **meshes** (a slice always
shares a mesh with itself; ``link`` declares two slices device-reachable,
one NVLink or peer-to-peer domain), and an **edge** between two pools
carries a transport backend:

 * ``"device"`` when the pools share a mesh: tensors move by
   ``tensor.to(device)`` (``fabric/transport.py``), never through host
   memory;
 * ``"rpc"`` otherwise: the length-prefixed frame protocol
   (``llm/disagg/connector.RpcKVConnector``), chunked for large payloads.

Edges are *stateful*: a device edge that faults is degraded to its RPC
fallback (``mark_fallback``), so the next transfer on that edge rides the
wire instead of retrying a broken device path; fallbacks are counted
(``fabric_transfer_fallbacks_total``).

The map serializes to a plain dict (``to_dict`` / ``from_dict``), so a
``DisaggConfig`` can carry it and ``/v1/stats`` can show it.
"""

from __future__ import annotations

import threading
from typing import Optional

VALID_BACKENDS = ("device", "rpc", "inproc")


class FabricTopology:
    """Pool → slice → mesh map with per-edge transport state."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pools: dict[str, dict] = {}      # name -> {role, slice, size}
        self._mesh_of: dict[str, str] = {}     # slice -> mesh-group root
        self._fallbacks: dict[tuple, str] = {} # (src, dst) -> reason
        self._overrides: dict[tuple, str] = {} # (src, dst) -> forced backend

    # -- declaration ----------------------------------------------------------

    def add_pool(self, name: str, role: str, slice_id: str,
                 size: int = 1) -> "FabricTopology":
        with self._lock:
            self._pools[name] = {
                "role": role, "slice": slice_id, "size": int(size),
            }
            self._mesh_of.setdefault(slice_id, slice_id)
        return self

    def link(self, slice_a: str, slice_b: str) -> "FabricTopology":
        """Declare two slices device-reachable (one peer-to-peer mesh
        domain): union their mesh groups."""
        with self._lock:
            ra = self._root_locked(slice_a)
            rb = self._root_locked(slice_b)
            if ra != rb:
                self._mesh_of[rb] = ra
        return self

    def _root_locked(self, slice_id: str) -> str:
        self._mesh_of.setdefault(slice_id, slice_id)
        s = slice_id
        while self._mesh_of[s] != s:
            s = self._mesh_of[s]
        self._mesh_of[slice_id] = s  # path compression
        return s

    # -- queries --------------------------------------------------------------

    def pools(self) -> dict:
        with self._lock:
            return {k: dict(v) for k, v in self._pools.items()}

    def pool_of_role(self, role: str) -> Optional[str]:
        with self._lock:
            for name, p in self._pools.items():
                if p["role"] == role:
                    return name
        return None

    def shares_mesh(self, pool_a: str, pool_b: str) -> bool:
        with self._lock:
            pa = self._pools.get(pool_a)
            pb = self._pools.get(pool_b)
            if pa is None or pb is None:
                return False
            return self._root_locked(pa["slice"]) == self._root_locked(pb["slice"])

    def edge_backend(self, src_pool: str, dst_pool: str) -> str:
        """Transport for the (src → dst) edge: a forced override wins,
        a recorded fallback degrades to rpc, else device iff the pools
        share a mesh."""
        key = (src_pool, dst_pool)
        with self._lock:
            if key in self._overrides:
                return self._overrides[key]
            if key in self._fallbacks:
                return "rpc"
        return "device" if self.shares_mesh(src_pool, dst_pool) else "rpc"

    def set_edge_backend(self, src_pool: str, dst_pool: str,
                         backend: str) -> None:
        if backend not in VALID_BACKENDS:
            raise ValueError(
                f"unknown fabric backend {backend!r}; one of {VALID_BACKENDS}"
            )
        with self._lock:
            self._overrides[(src_pool, dst_pool)] = backend

    def mark_fallback(self, src_pool: str, dst_pool: str,
                      reason: str = "") -> bool:
        """Degrade one edge to its RPC fallback after a device-transfer
        fault; returns True the first time (so the caller counts each
        degradation once)."""
        key = (src_pool, dst_pool)
        with self._lock:
            if key in self._fallbacks:
                return False
            self._fallbacks[key] = reason or "device_transfer_fault"
            return True

    def fallbacks(self) -> dict:
        with self._lock:
            return {f"{s}->{d}": r for (s, d), r in self._fallbacks.items()}

    def edges(self) -> list:
        """Every directed pool pair with its current backend (the
        transport matrix ``/v1/stats`` shows)."""
        names = sorted(self.pools())
        return [
            {"src": s, "dst": d, "backend": self.edge_backend(s, d)}
            for s in names for d in names if s != d
        ]

    # -- wire form ------------------------------------------------------------

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "pools": {k: dict(v) for k, v in self._pools.items()},
                "mesh_of": dict(self._mesh_of),
                "overrides": {
                    f"{s}->{d}": b for (s, d), b in self._overrides.items()
                },
            }

    @classmethod
    def from_dict(cls, doc: dict) -> "FabricTopology":
        topo = cls()
        for name, p in (doc.get("pools") or {}).items():
            topo.add_pool(name, p["role"], p["slice"], p.get("size", 1))
        for slice_id, root in (doc.get("mesh_of") or {}).items():
            topo.link(root, slice_id)
        for edge, backend in (doc.get("overrides") or {}).items():
            src, _, dst = edge.partition("->")
            topo.set_edge_backend(src, dst, backend)
        return topo

    def __repr__(self):
        return (f"FabricTopology(pools={sorted(self.pools())}, "
                f"edges={[(e['src'], e['dst'], e['backend']) for e in self.edges()]})")
