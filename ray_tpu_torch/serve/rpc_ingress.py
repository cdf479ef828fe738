"""RPC ingress: the binary front door beside the HTTP proxy (counterpart
of ``ray_tpu/serve/rpc_ingress.py``).

It speaks the framed TCP RPC plane (``cluster/rpc.py``): one ``call``
method carrying (app, method, args, kwargs), routed through the
controller's route table and the DeploymentHandles the HTTP proxy uses.
Python clients send and get structured values, with no JSON round trip.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.cluster.rpc import RpcClient, RpcServer
from ray_tpu_torch.serve.routes import AppResolver


class RpcIngress:
    """Framed-RPC front end. Handlers run on the RPC server's executor
    threads; each blocks on the deployment's reply, as an HTTP worker does."""

    def __init__(self, host: str, port: int, controller_handle):
        self._resolver = AppResolver(controller_handle, error_cls=ValueError)
        self.rpc = RpcServer(self, host=host, port=port)
        self.addr = self.rpc.start()

    def rpc_call(self, payload, peer):
        """{app?, method?, args?, kwargs?, timeout?} -> the deployment's
        result. ``method`` names a method of the ingress deployment;
        without it, its ``__call__``."""
        app, ingress = self._resolver.resolve(payload.get("app"))
        handle = self._resolver.handle_for(app, ingress)
        if payload.get("method"):
            handle = getattr(handle, payload["method"])
        response = handle.remote(*payload.get("args", ()), **payload.get("kwargs", {}))
        return response.result(timeout_s=payload.get("timeout", 120.0))

    def rpc_routes(self, payload, peer):
        return dict(self._resolver.route_cache.get())

    def shutdown(self) -> None:
        self.rpc.stop()


def rpc_ingress_call(addr: tuple, *args, app: Optional[str] = None,
                     method: Optional[str] = None, timeout: float = 120.0, **kwargs):
    """Client helper: one structured call against an RpcIngress."""
    c = RpcClient(addr[0], addr[1], timeout=timeout + 10).connect()
    try:
        return c.call("call", {"app": app, "method": method, "args": args, "kwargs": kwargs,
                               "timeout": timeout})
    finally:
        c.close()
