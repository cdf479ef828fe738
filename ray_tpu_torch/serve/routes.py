"""Shared route-table cache for Serve front ends (counterpart of
``ray_tpu/serve/routes.py``).

The HTTP proxy consumes the controller's route table through one TTL'd
cache. The reference's ``AppResolver`` (app-name resolution for its gRPC
and RPC ingresses) waits with those ingresses (ROADMAP.md Queue 1,
item 6, a later part).
"""

from __future__ import annotations

import time
from typing import Any


class RouteTableCache:
    """TTL'd view of controller.list_routes: {prefix: (app, ingress)}."""

    def __init__(self, controller_handle, ttl_s: float = 0.5):
        self._controller = controller_handle
        self._ttl = ttl_s
        self._routes: dict = {}
        self._stamp = 0.0

    def get(self) -> dict:
        import ray_tpu_torch

        if time.time() - self._stamp >= self._ttl or not self._routes:
            self._routes = ray_tpu_torch.get(self._controller.list_routes.remote())
            self._stamp = time.time()
        return self._routes

    def match(self, path: str) -> "Any | None":
        """Longest-prefix route match -> (norm, prefix, app, ingress)."""
        best = None
        for prefix, (app, ingress) in self.get().items():
            norm = prefix.rstrip("/") or "/"
            if path == norm or path.startswith(norm + "/") or norm == "/":
                if best is None or len(norm) > len(best[0]):
                    best = (norm, prefix, app, ingress)
        return best
