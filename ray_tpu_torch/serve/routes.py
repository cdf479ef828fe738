"""Shared route-table cache for Serve front ends (counterpart of
``ray_tpu/serve/routes.py``).

Every ingress tier (the HTTP proxy, the framed-RPC and gRPC ingresses)
consumes the controller's route table through one TTL'd cache;
``AppResolver`` is the app-name resolution and handle memo the two
non-HTTP ingresses share.
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


class AppResolver:
    """App-name resolution with a single-app default, and one memoized
    DeploymentHandle per (app, ingress), for the framed-RPC and gRPC front
    doors."""

    def __init__(self, controller_handle, error_cls: type = KeyError):
        import threading

        self.route_cache = RouteTableCache(controller_handle)
        self._handles: dict = {}
        self._lock = threading.Lock()
        self._error_cls = error_cls

    def resolve(self, app: "str | None") -> tuple:
        apps = {a: ingress for _, (a, ingress) in self.route_cache.get().items()}
        if app is None:
            if not apps:
                raise self._error_cls("no applications with a route_prefix are deployed")
            if len(apps) > 1:
                raise self._error_cls(
                    f"app selection required: multiple apps deployed ({sorted(apps)})")
            app = next(iter(apps))
        ingress = apps.get(app)
        if ingress is None:
            raise self._error_cls(f"no deployed app {app!r}; have {sorted(apps)}")
        return app, ingress

    def handle_for(self, app: str, ingress: str):
        with self._lock:
            h = self._handles.get((app, ingress))
            if h is None:
                from ray_tpu_torch.serve.handle import DeploymentHandle

                h = DeploymentHandle(ingress, app)
                self._handles[(app, ingress)] = h
            return h
